"""The port's farm against the JAX farm on the JAX suite's own cases: twins
of tests/test_farm.py's ``TestFarmBasics`` (nine hand cases) and
``TestFarmDifferential`` (five seeded workloads against ``OpSet``).

Each twin runs the JAX test method itself, unchanged, twice: once with
``test_farm.TpuDocFarm`` as it is, once with that name bound to the port's
``TorchDocFarm`` on the CPU. Either way the method makes its own
assertions against the JAX package's ``OpSet`` and ``encode_change``
(the differential's ``Workload`` and ``run_farm_differential`` loop are
the suite's own). A wrapper around each farm the method builds records
every ``apply_changes`` outcome and patch, and at the end every doc's
heads, whole-document patch, missing deps and change log; ``twin_pkgs``
holds the port's record equal to the JAX farm's. The tolerance is zero.
"""
import pytest

import test_farm
from test_torch_faults_domain import record_result, twin_pkgs


def recording_farms(P, rec, built):
    """A stand-in for ``TpuDocFarm`` that builds `P`'s farm on its CPU and
    records what each ``apply_changes`` call returns."""
    def make(*args, **kwargs):
        farm = P.farm(*args, **kwargs)
        apply = farm.apply_changes

        def apply_changes(*a, **k):
            result = apply(*a, **k)
            record_result(rec, result)
            return result

        farm.apply_changes = apply_changes
        built.append(farm)
        return farm

    return make


def run_method(cls, name, monkeypatch):
    def scenario(P, rec):
        built = []
        monkeypatch.setattr(test_farm, "TpuDocFarm",
                            recording_farms(P, rec, built))
        getattr(cls(), name)()
        for farm in built:
            for d in range(farm.num_docs):
                rec.value(farm.get_heads(d))
                rec.value(farm.get_missing_deps(d))
                rec.patch(farm.get_patch(d))
                rec.changes(farm.get_all_changes(d))

    rec = twin_pkgs(scenario, monkeypatch)
    assert rec, "the case built no farm"


BASICS = [n for n in vars(test_farm.TestFarmBasics) if n.startswith("test_")]
DIFFERENTIAL = [n for n in vars(test_farm.TestFarmDifferential)
                if n.startswith("test_")]


@pytest.mark.parametrize("name", BASICS)
def test_farm_basics(name, monkeypatch):
    run_method(test_farm.TestFarmBasics, name, monkeypatch)


@pytest.mark.parametrize("name", DIFFERENTIAL)
def test_farm_differential(name, monkeypatch):
    run_method(test_farm.TestFarmDifferential, name, monkeypatch)


def test_the_suite_has_the_cases_twinned():
    """Nine hand cases and five workloads, as ROADMAP queue A counts them."""
    assert (len(BASICS), len(DIFFERENTIAL)) == (9, 5)
