"""The port's ``BatchedTextEngine`` against the JAX one on the JAX suite's
hand cases: twins of tests/test_text_engine.py's ``TestBatchedTextEngine``
(sequential typing, RGA order of concurrent inserts, delete and update,
concurrent delete against update, the differential against ``OpSet``).

Each twin runs the JAX test method itself, unchanged, twice: once with
the suite's ``te`` module as it is, once with ``te.BatchedTextEngine``
bound to the port's engine on the CPU. Either way the method makes its
own assertions (the differential against the JAX package's ``OpSet``).
A wrapper records every ``visible_texts()`` the method reads and, at the
end, each engine's texts and document ranks; ``twin_pkgs`` holds the
port's record equal to the JAX engine's. The tolerance is zero."""
import types

import pytest

import test_text_engine
from test_torch_faults_domain import twin_pkgs


def recording_engines(P, rec, built):
    def make(*args, **kwargs):
        eng = P.text_engine.BatchedTextEngine(*args, **kwargs, **P.cpu)
        read = eng.visible_texts

        def visible_texts():
            texts = read()
            rec.value(texts)
            return texts

        eng.visible_texts = visible_texts
        built.append(eng)
        return eng

    return make


CASES = [n for n in vars(test_text_engine.TestBatchedTextEngine)
         if n.startswith("test_")]


@pytest.mark.parametrize("name", CASES)
def test_text_engine_hand_case(name, monkeypatch):
    def scenario(P, rec):
        built = []
        te = types.SimpleNamespace(
            BatchedTextEngine=recording_engines(P, rec, built))
        monkeypatch.setattr(test_text_engine, "te", te)
        getattr(test_text_engine.TestBatchedTextEngine(), name)()
        for eng in built:
            rec.value(eng.document_ranks().tolist())

    rec = twin_pkgs(scenario, monkeypatch)
    assert rec, "the case built no engine"
