"""The crash-point sweep of the port's store, a twin of the JAX package's
tests/test_store.py::test_crash_point_sweep on the CPU: an injected crash
walks across every firing of one durability boundary (``store.append``,
``store.fsync``, ``store.rotate``, ``store.compact``, the port's own fault
points) over a commit + rotate + compact workload, and each reopen must
serve an exact prefix of the history covering every acked commit. Also
the restart path of the v2 fingerprint index, rebuilt from the store's
footer hashes."""
import pytest

from automerge_tpu_torch.store import ShardStore, StoreConfig, open_farm
from automerge_tpu_torch.testing import faults
from automerge_tpu_torch.tpu.farm import TorchDocFarm
from chip_smoke import store_streams

NUM_DOCS = 4
ROUNDS = 3
OPS = 6
CAP = ROUNDS * OPS + 8


def _streams(num_docs=NUM_DOCS, rounds=ROUNDS, seed=0):
    """Per doc, one actor's stream (the JAX suite's, seeded seed + 31 d)."""
    return [store_streams(1, rounds, OPS, seed + 31 * d)[0]
            for d in range(num_docs)]


def _round_delivery(streams, r):
    return [[streams[d][r]] for d in range(len(streams))]


def _write_farm(root, streams, config=None, rounds=None):
    """A farm with an attached store, the workload committed round by
    round. Returns (farm, store) still open."""
    farm = TorchDocFarm(len(streams), capacity=CAP, device="cpu")
    store = ShardStore(root, config)
    farm.attach_store(store)
    for r in range(rounds if rounds is not None else len(streams[0])):
        farm.apply_changes(_round_delivery(streams, r))
    return farm, store


def _crash_workload(root, streams, point, n):
    """One scripted run with fail_at(n) armed at `point`: ROUNDS commits,
    then a rotation, then a compaction. Returns (acked_rounds, hook,
    refs) where refs pins the abandoned farm/store so their buffered
    handles stay un-flushed (the in-process stand-in for a killed
    process) until the caller's reopen has happened."""
    hook = faults.fail_at(n, lambda: OSError(f"injected crash at {point}#{n}"))
    farm = store = None
    acked = 0
    try:
        with faults.inject(point, hook):
            farm = TorchDocFarm(len(streams), capacity=CAP, device="cpu")
            store = ShardStore(root, StoreConfig())
            farm.attach_store(store)
            for r in range(ROUNDS):
                farm.apply_changes(_round_delivery(streams, r))
                acked = r + 1
            store.rotate()
            store.compact()
            store.close()
            store = None
    except OSError:
        pass
    return acked, hook, (farm, store)


@pytest.mark.parametrize(
    "point", ["store.append", "store.fsync", "store.rotate", "store.compact"])
def test_crash_point_sweep(tmp_path, point):
    """Walks an injected crash across EVERY firing of one durability
    boundary over a commit+rotate+compact workload. After each crash the
    reopened farm must hold, per doc, an exact prefix of the intended
    history that covers every acked commit, with no corrupt segments —
    the store never trades consistency for the crash, only the unacked
    tail."""
    streams = _streams()
    n = 1
    while True:
        root = str(tmp_path / f"{point.replace('.', '-')}-{n}")
        acked, hook, refs = _crash_workload(root, streams, point, n)
        if hook.fired < n:
            # walked off the end: the whole workload ran fault-free
            assert acked == ROUNDS
            break
        farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
        assert store2.report.corrupt_segments == [], (point, n)
        for d in range(NUM_DOCS):
            got = list(farm2.changes[d])
            assert got == list(streams[d])[:len(got)], (point, n, d)
            assert len(got) >= acked, (point, n, d, acked)
        assert farm2.quarantine == {}, (point, n)
        store2.close()
        del refs
        n += 1
    assert n > 1, f"{point} never fired"


def test_store_fault_points_are_registered():
    """The port's registry lists the store's and the chaos transport's
    fault points, as the JAX package's does."""
    for point in ("store.append", "store.fsync", "store.rotate",
                  "store.compact", "chaos.send", "chaos.deliver"):
        assert point in faults.POINTS


def test_fingerprint_index_rebuilds_from_store(tmp_path):
    """``FingerprintIndex.rebuild_from_store`` seeds every doc from the
    store's footer hash lists: after a rotation seals the history, the
    rebuilt index answers the same range fingerprints as one synced from
    the farm."""
    from automerge_tpu_torch.tpu.fingerprint import FingerprintIndex

    root = str(tmp_path / "shard")
    streams = _streams()
    farm = TorchDocFarm(NUM_DOCS, capacity=CAP, device="cpu")
    store = ShardStore(root)
    farm.attach_store(store)
    for r in range(ROUNDS):
        farm.apply_changes(_round_delivery(streams, r))
    store.rotate()
    store.close()
    reopened = ShardStore(root)
    rebuilt = FingerprintIndex(device="cpu")
    rebuilt.rebuild_from_store(reopened)
    synced = FingerprintIndex(device="cpu")
    for d in range(NUM_DOCS):
        synced.sync_from_farm(farm, d)
    queries = [(d, "0" * 64, "f" * 64) for d in range(NUM_DOCS)]
    assert rebuilt.fingerprint_ranges(queries) == \
        synced.fingerprint_ranges(queries)
    assert all(count == ROUNDS
               for count, _ in rebuilt.fingerprint_ranges(queries))
    reopened.close()
