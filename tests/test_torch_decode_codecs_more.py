"""Column-level parity of the vectorised decode, the port against the JAX
package, continued from test_torch_decode_codecs.py: twins of
tests/test_decode_vectorized.py's ``TestColumnCodecs`` for the Boolean
and string-RLE columns (eight seeds each) and the bad run grammars that
must defer to the scalar oracle. The tolerance is zero."""
import random

import pytest

from test_torch_decode_codecs import expand, scalar_column
from test_torch_faults_domain import twin_pkgs


@pytest.mark.parametrize("seed", range(8))
def test_boolean(seed, monkeypatch):
    def scenario(P, rec):
        rng = random.Random(seed)
        values = []
        for _ in range(rng.randrange(1, 20)):
            values.extend([rng.random() < 0.5] * rng.randrange(1, 7))
        enc = P.codecs.BooleanEncoder()
        for v in values:
            enc.append_value(v)
        buf = enc.buffer
        got = expand(P, buf, "_bool_expand").tolist()
        assert got == scalar_column(P.codecs.BooleanDecoder(buf))
        rec.value((bytes(buf), got))

    twin_pkgs(scenario, monkeypatch)


@pytest.mark.parametrize("seed", range(8))
def test_strrle(seed, monkeypatch):
    def scenario(P, rec):
        rng = random.Random(seed)
        words = ["", "a", "longer-key", "élément", "x" * 200]
        values = []
        for _ in range(rng.randrange(1, 25)):
            v = rng.choice([None] + words)
            values.extend([v] * rng.randrange(1, 5))
        enc = P.codecs.RLEEncoder("utf8")
        for v in values:
            enc.append_value(v)
        buf = enc.buffer
        blob, offs = P.decode._strrle_expand(buf)
        got = [None if s < 0 else blob[s:e].decode("utf-8", "surrogatepass")
               for s, e in offs.tolist()]
        assert got == scalar_column(P.codecs.RLEDecoder("utf8", buf))
        rec.value((bytes(buf), got, offs.tolist()))

    twin_pkgs(scenario, monkeypatch)


def test_bad_run_grammar_defers_to_oracle(monkeypatch):
    def scenario(P, rec):
        def rle_bytes(records):
            enc = P.codecs.Encoder()
            for record in records:
                for kind, v in record:
                    if kind == "i":
                        enc.append_int53(v)
                    else:
                        enc.append_uint53(v)
            return bytes(enc.buffer)

        bad_streams = [
            rle_bytes([[("i", 1), ("u", 5)]]),
            rle_bytes([[("i", 0), ("u", 0)]]),
            rle_bytes([[("i", 0), ("u", 2)], [("i", 0), ("u", 2)]]),
            rle_bytes([[("i", 3), ("u", 7)], [("i", 2), ("u", 7)]]),
            rle_bytes([[("i", -1), ("u", 4)], [("i", -1), ("u", 5)]]),
            rle_bytes([[("i", -2), ("u", 4), ("u", 4)]]),
        ]
        for buf in bad_streams:
            with pytest.raises(P.errors.DecodeError) as scalar_exc:
                scalar_column(P.codecs.RLEDecoder("uint", buf))
            with pytest.raises(P.decode._Fallback) as vector_exc:
                expand(P, buf, "_rle_expand", signed=False)
            rec.value((buf, str(scalar_exc.value), str(vector_exc.value)))

    twin_pkgs(scenario, monkeypatch)
