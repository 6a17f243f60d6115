"""Smoke gate for the port's persistence tier, twins of the JAX package's
tests/test_store_smoke.py. Where the JAX suite runs ``bench.py --store
--quick``, these drive ``chip_smoke.run_store`` (phase 15's driver) on the
CPU at the JAX quick shape (24 docs x 4 rounds x one 16-op change) and
gate on properties that hold on any host:

- the writer's farm and the farm ``open_farm`` rebuilt from the on-disk
  log are byte-identical (change log, heads and whole-doc patches);
- the recovery report is clean, and every committed change is accounted
  for (the WAL appended docs x rounds records and replays every one);
- the default group-commit policy fsynced once per barrier;
- the hydrated farm keeps logging, and a torn tail recovers exactly the
  acked prefix.
"""
import pytest

import chip_smoke

DOCS, ROUNDS, OPS = 24, 4, 16


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    record = []
    with chip_smoke.counting_fallbacks():
        stats = chip_smoke.run_store("cpu", DOCS, ROUNDS, OPS, 0,
                                     str(tmp_path_factory.mktemp("store")),
                                     sample=2, record=record)
    return stats, record


def test_quick_gate_passes(smoke):
    stats, _ = smoke
    assert stats["report"]["clean"] is True
    assert stats["sample"] == 2
    assert stats["batched_s"] > 0 and stats["sequential_s"] > 0


def test_hydrated_farm_is_bit_compatible(smoke):
    """The reopened farm's whole-doc patches equal the writer's, and the
    fresh replica caught up from it holds the same patches."""
    _, record = smoke
    files, written, hydrated = record[:3]
    assert len(written) == DOCS
    assert hydrated == written
    assert record[-2] == written  # check_converged on the caught-up pair
    assert any(name.startswith("wal-") for name, _ in files)


def test_recovery_report_is_clean(smoke):
    rec = smoke[0]["report"]
    assert rec["clean"] is True, rec
    assert rec["torn_bytes"] == 0, rec
    assert rec["corrupt_segments"] == 0, rec


def test_every_committed_change_is_accounted_for(smoke):
    """docs x rounds changes went through the WAL and every one came back
    on replay."""
    stats = smoke[0]
    expected = DOCS * ROUNDS
    assert stats["store.append.records"] == expected, stats
    assert stats["report"]["records"] == expected, stats
    assert stats["report"]["changes"] == expected, stats


def test_group_commit_fsynced_each_barrier(smoke):
    """The default policy (group_commit=1) pays one fsync per delivery."""
    assert smoke[0]["store.fsyncs"] == ROUNDS


def test_wal_overhead_is_reported(smoke):
    stats = smoke[0]
    assert stats["overhead"] > 0
    assert stats["store.append.bytes"] > 0
    assert 0 < stats["commit_s"] < stats["wal_s"]


def test_torn_tail_recovers_the_acked_prefix(smoke):
    """The hydrated farm logs one more round to the store it attached;
    cutting the active segment mid-way through its last frame then loses
    that frame's commit alone."""
    torn = smoke[0]["torn"]
    assert torn["doc"] == DOCS - 1 and torn["lost"] == 1
    assert torn["recovered"] == DOCS * (ROUNDS + 1) - 1
    assert torn["torn_bytes"] > 0


def test_torn_tail_does_not_depend_on_the_segment_size(tmp_path, monkeypatch):
    """With segments far smaller than one round, the writer rotates at
    every barrier; the hydrated farm's extra round must still land in one
    active segment, so the tear hits its last commit frame."""
    import dataclasses

    from automerge_tpu_torch import store

    @dataclasses.dataclass
    class SmallSegments(store.StoreConfig):
        segment_bytes: int = 4096

    monkeypatch.setattr(store, "StoreConfig", SmallSegments)
    with chip_smoke.counting_fallbacks():
        stats = chip_smoke.run_store("cpu", DOCS, ROUNDS, OPS, 0,
                                     str(tmp_path), sample=2)
    assert stats["report"]["segments"] > ROUNDS
    assert stats["torn"]["lost"] == 1 and stats["torn"]["torn_bytes"] > 0
    assert stats["torn"]["recovered"] == DOCS * (ROUNDS + 1) - 1
