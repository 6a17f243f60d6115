"""The port's persistence tier (``automerge_tpu_torch.store``): twins of the
JAX package's tests/test_store.py on the CPU (``device="cpu"``), without
its black-box and process-mesh tests (their modules are later slices).

- acked means durable: every commit a ``TorchDocFarm`` acked is on disk
  after any crash, and recovery lands on a clean per-doc prefix of the
  committed history in the reference wire format;
- a torn tail truncates, corruption quarantines only its segment's docs;
- ``open_farm`` hydrates in one batched delivery and restores the
  quarantine sidecar;
- the on-disk format is the contract between the packages: the same
  commits through the JAX and the port farms give byte-identical store
  directories, and a directory the JAX package wrote hydrates the port's
  farm to the JAX farm's whole-doc patches.

The crash-point sweep is in tests/test_torch_store_crash.py.
"""
import json
import os

import pytest

from automerge_tpu.store import ShardStore as JaxShardStore
from automerge_tpu.store import StoreConfig as JaxStoreConfig
from automerge_tpu.store import open_farm as jax_open_farm
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu_torch.errors import (ChecksumError, DecodeError,
                                        StoreCorruptError,
                                        StoreTornWriteError, error_from_kind)
from automerge_tpu_torch.store import (MANIFEST_NAME, QUARANTINE_NAME,
                                       ShardStore, StoreConfig, atomic_write,
                                       open_farm)
from automerge_tpu_torch.store.wal import CORRUPT_DIR
from automerge_tpu_torch.testing import faults
from automerge_tpu_torch.tpu.farm import TorchDocFarm
from chip_smoke import dir_files, store_streams

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


# ---------------------------------------------------------------------- #
# round-trip + bit compatibility


def test_wal_roundtrip_bit_compatible(tmp_path):
    """Reopening replays the WAL into a farm whose change log is
    byte-identical to the writer's — the persisted chunks ARE the
    reference-format buffers that were applied."""
    root = str(tmp_path / "shard")
    streams = _streams()
    farm, store = _write_farm(root, streams)
    store.close()

    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
    assert store2.report.clean, vars(store2.report)
    assert [list(c) for c in farm2.changes] == [list(c) for c in farm.changes]
    assert farm2.heads == farm.heads
    assert farm2.quarantine == {}
    for d in range(NUM_DOCS):
        assert json.dumps(farm2.get_patch(d), sort_keys=True) == \
            json.dumps(farm.get_patch(d), sort_keys=True)
    store2.close()


def test_rotation_and_compaction_roundtrip(tmp_path):
    """rotate() seals the active segment (footer + rename), compact()
    folds sealed WAL into a verified cold generation and deletes the
    sources; the reopened farm is unchanged through both."""
    root = str(tmp_path / "shard")
    streams = _streams(rounds=ROUNDS + 2)
    farm = TorchDocFarm(NUM_DOCS, capacity=CAP + 2 * OPS, device="cpu")
    store = ShardStore(root)
    farm.attach_store(store)
    for r in range(ROUNDS):
        farm.apply_changes(_round_delivery(streams, r))
    store.rotate()
    for r in range(ROUNDS, ROUNDS + 2):
        farm.apply_changes(_round_delivery(streams, r))
    store.compact()
    names = set(os.listdir(root))
    assert MANIFEST_NAME in names
    assert any(n.startswith("cold-") for n in names)
    assert not any(n.endswith(".seg") and n.startswith("wal-") for n in names)
    store.close()

    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP + 2 * OPS, device="cpu")
    assert store2.report.clean
    assert [list(c) for c in farm2.changes] == [list(c) for c in farm.changes]
    assert farm2.heads == farm.heads
    store2.close()


# ---------------------------------------------------------------------- #
# torn writes and corruption


def test_torn_tail_truncates_to_last_whole_frame(tmp_path):
    """A partial frame at the active tail (the power-loss signature) is
    truncated away; every acked commit before it survives."""
    root = str(tmp_path / "shard")
    streams = _streams()
    farm, store = _write_farm(root, streams)
    store.close()
    active = [n for n in os.listdir(root) if n.endswith(".open")]
    assert len(active) == 1
    path = os.path.join(root, active[0])
    with open(path, "ab") as fh:
        fh.write(b"\x99\x00\x00\x00" + b"torn!")  # length says 153, body 5

    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
    assert not store2.report.clean
    assert store2.report.torn_bytes == 9
    assert store2.report.corrupt_segments == []
    assert [list(c) for c in farm2.changes] == [list(c) for c in farm.changes]
    store2.close()

    # and the truncated file appends cleanly again
    farm3, store3 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
    assert store3.report.clean
    store3.close()


def test_torn_mid_frame_recovers_strict_prefix(tmp_path):
    """Chopping bytes off the active tail loses exactly the last frames,
    never garbles the ones before them."""
    root = str(tmp_path / "shard")
    streams = _streams()
    farm, store = _write_farm(root, streams)
    store.close()
    active = [n for n in os.listdir(root) if n.endswith(".open")]
    path = os.path.join(root, active[0])
    os.truncate(path, os.path.getsize(path) - 11)

    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
    assert store2.report.torn_bytes > 0
    total = sum(len(c) for c in farm2.changes)
    full = sum(len(c) for c in farm.changes)
    assert 0 < total < full
    for d in range(NUM_DOCS):
        k = len(farm2.changes[d])
        assert list(farm2.changes[d]) == list(farm.changes[d])[:k]
    store2.close()


def test_corrupt_segment_quarantines_only_its_docs(tmp_path):
    """A checksum-bad frame condemns its whole segment: the file moves to
    corrupt/, its docs enter quarantine with a StoreCorruptError cause,
    and docs whose history lives in OTHER segments hydrate untouched."""
    root = str(tmp_path / "shard")
    streams = _streams()
    farm = TorchDocFarm(NUM_DOCS, capacity=CAP, device="cpu")
    store = ShardStore(root)
    farm.attach_store(store)
    # segment 1: docs 0..1 only, sealed; segment 2: docs 2..3
    for r in range(ROUNDS):
        farm.apply_changes(
            [[streams[d][r]] if d < 2 else [] for d in range(NUM_DOCS)])
    store.rotate()
    for r in range(ROUNDS):
        farm.apply_changes(
            [[streams[d][r]] if d >= 2 else [] for d in range(NUM_DOCS)])
    store.close()

    sealed = [n for n in os.listdir(root) if n.endswith(".seg")]
    assert len(sealed) == 1
    path = os.path.join(root, sealed[0])
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x40  # mid-payload bit flip
    with open(path, "wb") as fh:
        fh.write(data)

    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
    assert not store2.report.clean
    assert sealed[0] in store2.report.corrupt_segments
    assert os.path.exists(os.path.join(root, CORRUPT_DIR, sealed[0]))
    assert set(farm2.quarantine) == {0, 1}
    for exc in farm2.quarantine.values():
        assert isinstance(exc, StoreCorruptError)
    # the untouched segment's docs hydrated fully
    for d in (2, 3):
        assert list(farm2.changes[d]) == list(farm.changes[d])
    store2.close()


def test_store_errors_are_decode_taxonomy(tmp_path):
    """The store's failure modes are classifiable taxonomy errors of the
    port's own ``errors`` module, with the JAX package's kinds, and
    rebuildable by kind."""
    from automerge_tpu import errors as jax_errors

    assert issubclass(StoreCorruptError, DecodeError)
    assert issubclass(StoreTornWriteError, DecodeError)
    assert StoreCorruptError is not jax_errors.StoreCorruptError
    assert StoreCorruptError.kind == "store_corrupt" == \
        jax_errors.StoreCorruptError.kind
    assert StoreTornWriteError.kind == "store_torn" == \
        jax_errors.StoreTornWriteError.kind
    rebuilt = error_from_kind("store_corrupt", "boom")
    assert isinstance(rebuilt, StoreCorruptError)
    assert str(rebuilt) == "boom"


# ---------------------------------------------------------------------- #
# group commit + the atomic writer


def test_group_commit_defers_fsync_not_consistency(tmp_path):
    """group_commit=N pays one fsync every N barriers (the documented
    durability window); the WAL content is flushed and prefix-consistent
    either way."""
    fsyncs = []

    def counter(**ctx):
        # only count syncs of the active WAL segment — the quarantine
        # sidecar's atomic_write fires the same point for its own file
        if ".open" in (ctx.get("path") or ""):
            fsyncs.append(ctx["path"])

    root = str(tmp_path / "shard")
    streams = _streams()
    with faults.inject("store.fsync", counter):
        farm = TorchDocFarm(NUM_DOCS, capacity=CAP, device="cpu")
        store = ShardStore(root, StoreConfig(group_commit=3))
        farm.attach_store(store)
        barrier_syncs = []
        for r in range(ROUNDS):
            before = len(fsyncs)
            farm.apply_changes(_round_delivery(streams, r))
            barrier_syncs.append(len(fsyncs) - before)
    # barriers 1 and 2 deferred, barrier 3 paid the fsync
    assert barrier_syncs == [0, 0, 1]
    store.close()

    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
    assert [list(c) for c in farm2.changes] == [list(c) for c in farm.changes]
    store2.close()


def test_atomic_write_leaves_old_content_on_fsync_crash(tmp_path):
    """The shared atomic writer (store manifests and sidecars) is
    all-or-nothing — a crash in its fsync seam
    leaves the previous content untouched and no tmp litter."""
    path = str(tmp_path / "MANIFEST.json")
    atomic_write(path, '{"generation": 1}')
    with faults.inject("store.fsync", faults.fail_always(
            lambda: OSError("injected fsync failure"))):
        with pytest.raises(OSError):
            atomic_write(path, '{"generation": 2}')
    assert open(path).read() == '{"generation": 1}'
    assert os.listdir(tmp_path) == ["MANIFEST.json"]


# ---------------------------------------------------------------------- #
# quarantine state survives save/load (the satellite regression)


def test_quarantine_state_survives_cold_restart(tmp_path):
    """The PR-bugfix regression: a quarantined doc's cause and failure
    counts were silently reset by save/load. Now the sidecar persists
    them through the barrier and hydration restores them."""
    root = str(tmp_path / "shard")
    streams = _streams()
    farm = TorchDocFarm(NUM_DOCS, capacity=CAP, quarantine_threshold=1, device="cpu")
    store = ShardStore(root)
    farm.attach_store(store)
    farm.apply_changes(_round_delivery(streams, 0))
    # poison doc 1 into organic quarantine (checksum damage)
    delivery = [[] for _ in range(NUM_DOCS)]
    delivery[1] = [faults.bit_flipped(streams[1][1])]
    res = farm.apply_changes(delivery)
    assert res.outcomes[1].status == "quarantined"
    assert 1 in farm.quarantine
    counts = list(farm.fault_counts)
    store.close()

    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu",
                              quarantine_threshold=1)
    assert 1 in farm2.quarantine
    assert isinstance(farm2.quarantine[1], ChecksumError)
    assert list(farm2.fault_counts) == counts
    # released docs stay released across the NEXT cold restart
    assert farm2.release_quarantine(1) == [1]
    store2.close()
    farm3, store3 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu",
                              quarantine_threshold=1)
    assert farm3.quarantine == {}
    # and the released doc accepts redelivery of the clean change
    delivery = [[] for _ in range(NUM_DOCS)]
    delivery[1] = [streams[1][1]]
    res = farm3.apply_changes(delivery)
    assert res.outcomes[1].status == "applied"
    store3.close()


def test_quarantine_sidecar_is_advisory(tmp_path):
    """An unreadable sidecar degrades to 'no persisted quarantine', never
    a failed open."""
    root = str(tmp_path / "shard")
    streams = _streams()
    farm, store = _write_farm(root, streams)
    store.close()
    with open(os.path.join(root, QUARANTINE_NAME), "w") as fh:
        fh.write("not json {")
    farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
    assert farm2.quarantine == {}
    store2.close()


def test_compact_crash_leaves_one_generation_live(tmp_path):
    """Pin the two-generation invariant at each named compaction stage:
    whatever stage dies, reopening serves the complete history exactly
    once."""
    streams = _streams()
    for stage in ("write", "verify", "swap", "cleanup"):
        root = str(tmp_path / stage)
        farm, store = _write_farm(root, streams)
        store.rotate()
        hook = faults.fail_at(1, lambda: OSError("injected"), stage=stage)
        with faults.inject("store.compact", hook):
            with pytest.raises(OSError):
                store.compact()
        assert hook.fired == 1, stage
        store.close()
        farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
        assert store2.report.clean, (stage, vars(store2.report))
        assert [list(c) for c in farm2.changes] == \
            [list(c) for c in farm.changes], stage
        store2.close()


def test_rotate_crash_recovery_finishes_or_resumes(tmp_path):
    """A crash between the footer write and the rename leaves a footer-
    stamped .open file; recovery finishes the seal instead of calling it
    corrupt. A crash before the footer leaves the segment active."""
    streams = _streams()
    for stage in ("footer", "rename"):
        root = str(tmp_path / stage)
        farm, store = _write_farm(root, streams)
        hook = faults.fail_at(1, lambda: OSError("injected"), stage=stage)
        with faults.inject("store.rotate", hook):
            with pytest.raises(OSError):
                store.rotate()
        store.close()
        farm2, store2 = open_farm(root, NUM_DOCS, capacity=CAP, device="cpu")
        assert store2.report.corrupt_segments == [], stage
        assert [list(c) for c in farm2.changes] == \
            [list(c) for c in farm.changes], stage
        if stage == "rename":
            # footer made it down: recovery completed the rotation
            assert store2.report.sealed_on_open >= 1
        store2.close()


# ---------------------------------------------------------------------- #
# the on-disk format across the two packages


def _jax_write(root, streams, rotate_after=None):
    farm = TpuDocFarm(len(streams), capacity=CAP)
    store = JaxShardStore(root, JaxStoreConfig())
    farm.attach_store(store)
    for r in range(len(streams[0])):
        farm.apply_changes(_round_delivery(streams, r))
        if r == rotate_after:
            store.rotate()
    return farm, store


def test_jax_and_port_write_identical_directories(tmp_path):
    """The same commits (with a rotation, then a compaction, and a
    quarantine transition persisted to the sidecar) through the JAX and
    the port farms leave file-for-file identical store directories."""
    streams = _streams()
    poison = [[] for _ in range(NUM_DOCS)]
    poison[2] = [faults.bit_flipped(streams[2][1])]
    dirs = []
    for name, make in (("jax", lambda: (TpuDocFarm(NUM_DOCS, capacity=CAP),
                                        JaxShardStore)),
                       ("port", lambda: (TorchDocFarm(NUM_DOCS, capacity=CAP,
                                                      device="cpu"),
                                         ShardStore))):
        farm, store_cls = make()
        root = str(tmp_path / name)
        store = store_cls(root)
        farm.attach_store(store)
        farm.apply_changes(_round_delivery(streams, 0))
        store.rotate()
        farm.apply_changes(poison)
        for r in range(1, ROUNDS):
            farm.apply_changes(_round_delivery(streams, r))
        store.rotate()
        store.compact()
        farm.apply_changes([[faults.garbage(48)]] + [[]] * (NUM_DOCS - 1))
        store.close()
        dirs.append(dir_files(root))
    names = [n for n, _ in dirs[0]]
    assert any(n.startswith("cold-") for n in names), names
    assert QUARANTINE_NAME in names and MANIFEST_NAME in names
    assert [n for n, _ in dirs[1]] == names
    for (name, want), (_, got) in zip(*dirs):
        assert got == want, name


def test_jax_written_store_hydrates_port_farm(tmp_path):
    """A store directory the JAX package wrote (a sealed segment and an
    active one) hydrates the port's farm (``open_farm(device="cpu")``) to
    the JAX farm's change log, heads and whole-doc patches; the port
    then appends to it and the JAX package reads the result back."""
    root = str(tmp_path / "shard")
    streams = _streams(rounds=ROUNDS + 1)
    jax_farm, jax_store = _jax_write(
        root, [s[:ROUNDS] for s in streams], rotate_after=0)
    jax_store.close()

    farm, store = open_farm(root, NUM_DOCS, capacity=CAP + OPS,
                            device="cpu")
    assert store.report.clean, vars(store.report)
    assert [list(c) for c in farm.changes] == \
        [list(c) for c in jax_farm.changes]
    assert farm.heads == jax_farm.heads
    for d in range(NUM_DOCS):
        assert json.dumps(farm.get_patch(d), sort_keys=True) == \
            json.dumps(jax_farm.get_patch(d), sort_keys=True)
    farm.apply_changes(_round_delivery(streams, ROUNDS))
    store.close()

    back, back_store = jax_open_farm(root, NUM_DOCS, capacity=CAP + OPS)
    assert back_store.report.clean
    assert [list(c) for c in back.changes] == [list(c) for c in farm.changes]
    back_store.close()


def test_open_farm_defaults_to_the_card(tmp_path, monkeypatch):
    """``open_farm`` builds its farm on the card unless asked for the CPU,
    and without CUDA it raises before it opens (and so recovers) the
    directory."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "shard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_farm(root, NUM_DOCS, capacity=CAP)
    assert not os.path.exists(root)
