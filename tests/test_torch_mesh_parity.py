"""The port's doc-sharded ``MeshFarm`` (inline backend, ``device="cpu"``)
against the port's single ``TorchDocFarm`` and the JAX package's
``MeshFarm`` on the same deliveries: twins of tests/test_mesh_parity.py.

Every round's outcome statuses and patches are compared byte for byte in
canonical JSON across the three farms: the fuzz corpus, a mid-delivery
page-granular migration, the byte-fault quarantine corpus, a quarantined
doc migrating with its quarantine, the actor-table reconcile running
mid-workload, and the decode caches shared by shards whose interner
tables have diverged.
"""
import json

import pytest

from automerge_tpu.opset import OpSet
from automerge_tpu.parallel import MeshFarm as JaxMeshFarm
from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
from automerge_tpu_torch.opset import OpSet as TorchOpSet
from automerge_tpu_torch.parallel import MeshFarm
from automerge_tpu_torch.testing import faults
from automerge_tpu_torch.tpu.farm import TorchDocFarm
from test_farm import Workload

SEEDS = [11, 23, 47]
ROUNDS = 10
NUM_DOCS = 8
NUM_SHARDS = 3


def canon(patch):
    return json.dumps(patch, sort_keys=True)


def build(num_docs=NUM_DOCS, num_shards=NUM_SHARDS, quarantine_threshold=None,
          reconcile_interval=None):
    """(port mesh, port single farm, JAX mesh) over the same documents."""
    mesh = MeshFarm(num_docs, num_shards=num_shards, capacity=64,
                    quarantine_threshold=quarantine_threshold,
                    reconcile_interval=reconcile_interval, device="cpu")
    solo = TorchDocFarm(num_docs, capacity=64,
                        quarantine_threshold=quarantine_threshold,
                        device="cpu")
    jax_mesh = JaxMeshFarm(num_docs, num_shards=num_shards, capacity=64,
                           quarantine_threshold=quarantine_threshold,
                           reconcile_interval=reconcile_interval)
    return mesh, solo, jax_mesh


def apply_all(farms, per_doc, context):
    """One delivery into every farm; outcomes and patches must agree."""
    mesh, solo, jax_mesh = farms
    got = mesh.apply_changes(per_doc)
    for name, want in (("single farm", solo.apply_changes(per_doc)),
                       ("JAX mesh", jax_mesh.apply_changes(per_doc))):
        for d in range(len(per_doc)):
            assert got.outcomes[d].status == want.outcomes[d].status, (
                f"{context} doc={d}: outcome diverged from the {name} "
                f"({got.outcomes[d]} vs {want.outcomes[d]})"
            )
            assert canon(got[d]) == canon(want[d]), (
                f"{context} doc={d}: patch diverged from the {name}\n"
                f"got:  {canon(got[d])}\nwant: {canon(want[d])}"
            )


def assert_whole_docs(farms, context):
    mesh, solo, jax_mesh = farms
    for d in range(mesh.num_docs):
        got = canon(mesh.get_patch(d))
        assert got == canon(solo.get_patch(d)), f"{context} doc={d}"
        assert got == canon(jax_mesh.get_patch(d)), f"{context} doc={d}"


def run_triple(seed, deliver=None, between_rounds=None,
               quarantine_threshold=None, reconcile_interval=None):
    """Drives one random workload through the three farms side by side.
    `deliver` rewrites deliveries (fault interleavings); `between_rounds`
    runs controller actions on both meshes mid-stream."""
    farms = build(quarantine_threshold=quarantine_threshold,
                  reconcile_interval=reconcile_interval)
    gen = OpSet()
    workload = Workload(seed)
    for r in range(ROUNDS):
        buffers = workload.next_round(gen)
        if buffers:
            per_doc = [list(buffers) for _ in range(NUM_DOCS)]
            if deliver is not None:
                per_doc = deliver(r, per_doc)
            apply_all(farms, per_doc, f"seed={seed} round={r}")
            gen.apply_changes(list(buffers))
        if between_rounds is not None:
            between_rounds(r, farms[0], farms[2])
    assert_whole_docs(farms, f"seed={seed} whole-doc")
    return farms


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_corpus_mesh_matches_single_farm_and_jax(seed):
    run_triple(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_mid_delivery_migration_keeps_parity(seed):
    """A doc migrated between shards mid-workload keeps merging the
    remaining rounds with byte-identical patches on both meshes."""
    doc, split = 2, 4
    moved = []

    def between_rounds(r, mesh, jax_mesh):
        if r == split:
            src = mesh.shard_of(doc)
            assert src == jax_mesh.shard_of(doc)  # the same routing
            dest = (src + 1) % mesh.num_shards
            for m in (mesh, jax_mesh):
                m.migrate_doc(doc, dest)
                assert m.shard_of(doc) == dest != src
                m.audit()
            moved.append((src, dest))

    run_triple(seed, between_rounds=between_rounds)
    assert moved, "the migration round never ran"


@pytest.mark.parametrize("name,corrupt,kind", faults.BYTE_CORPUS)
def test_quarantine_rollback_parity(name, corrupt, kind):
    """A poisoned delivery quarantines the same doc in the same round on
    every farm, rolls its state back identically, and leaves every later
    clean delivery byte-identical."""
    poison_round, poison_doc = 3, 1

    def deliver(r, per_doc):
        if r == poison_round and per_doc[poison_doc]:
            per_doc[poison_doc] = [
                bytes(corrupt(buf)) for buf in per_doc[poison_doc]
            ]
        return per_doc

    run_triple(7, deliver=deliver)


def test_quarantined_doc_migrates_with_its_quarantine():
    """A shed doc stays shed on its new shard, release on every farm at the
    same round boundary returns it to service there, and everything stays
    byte-identical through the whole interleaving."""
    poison_doc = 1
    corrupt = faults.BYTE_CORPUS[1][1]  # bit_flipped
    farms = build(quarantine_threshold=1)
    mesh, solo, jax_mesh = farms
    gen = OpSet()
    workload = Workload(7)
    stage, stage_round = 0, 0
    for r in range(ROUNDS + 4):
        buffers = workload.next_round(gen)
        if not buffers:
            continue
        stage_round += 1
        per_doc = [list(buffers) for _ in range(NUM_DOCS)]
        if stage == 0 and stage_round >= 2:
            per_doc[poison_doc] = [
                bytes(corrupt(buf)) for buf in per_doc[poison_doc]
            ]
            stage, stage_round = 1, 0
        apply_all(farms, per_doc, f"round={r}")
        gen.apply_changes(list(buffers))
        if stage == 1 and stage_round >= 2:
            dest = (mesh.shard_of(poison_doc) + 1) % mesh.num_shards
            for m in (mesh, jax_mesh):
                assert poison_doc in m.quarantine
                m.migrate_doc(poison_doc, dest)
                assert m.shard_of(poison_doc) == dest
                assert poison_doc in m.quarantine, (
                    "quarantine entry lost in migration"
                )
                m.audit()
            assert poison_doc in solo.quarantine
            stage, stage_round = 2, 0
        elif stage == 2 and stage_round >= 2:
            for m in (mesh, jax_mesh):
                assert m.release_quarantine(doc=poison_doc) == [poison_doc]
                assert poison_doc not in m.quarantine
            solo.release_quarantine(poison_doc)
            stage, stage_round = 3, 0
    assert stage == 3, f"interleaving never completed (stage={stage})"
    assert_whole_docs(farms, "whole-doc")


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_reconcile_during_workload_keeps_parity(seed):
    """With reconcile_interval=2 the actor-table reconcile runs every other
    apply and never changes a patch; the tables converge (a second pass
    syncs zero), with the JAX mesh's counts."""
    mesh, _, jax_mesh = run_triple(seed, reconcile_interval=2)
    assert mesh.reconcile_actors() == jax_mesh.reconcile_actors()
    assert mesh.reconcile_actors() == 0


def test_decode_cache_shared_across_shards_without_state():
    """Shards share the process-global decode caches (parses), never
    interner state: two shards whose interner tables have diverged decode
    one fanned-out buffer once, intern its actor at different indices, and
    still emit byte-identical patches, equal to the JAX mesh's."""
    mesh = MeshFarm(6, num_shards=2, capacity=32, quarantine_threshold=None,
                    device="cpu")
    jax_mesh = JaxMeshFarm(6, num_shards=2, capacity=32,
                           quarantine_threshold=None)
    by_shard = {}
    for d in range(6):
        by_shard.setdefault(mesh.shard_of(d), []).append(d)
    assert len(by_shard) == 2, "routing degenerated to one shard"
    (s0, docs0), (s1, docs1) = sorted(by_shard.items())

    priv0a = faults.make_change("dd" * 4, 1, 1, [], [faults.set_op("p", 1)])
    priv0b = faults.make_change("cc" * 4, 1, 1, [], [faults.set_op("q", 3)])
    priv1 = faults.make_change("ee" * 4, 1, 1, [], [faults.set_op("p", 2)])
    delivery = [[] for _ in range(6)]
    delivery[docs0[0]] = [priv0a, priv0b]
    delivery[docs1[0]] = [priv1]
    mesh.apply_changes(delivery)
    jax_mesh.apply_changes(delivery)
    f0, f1 = mesh.shards[s0], mesh.shards[s1]
    assert f0.actors.find("dd" * 4) is not None
    assert f1.actors.find("dd" * 4) is None  # the tables have diverged

    shared = faults.make_change("ff" * 4, 1, 1, [], [faults.set_op("x", 9)])
    reg = get_metrics()
    reg.reset()
    with enabled_metrics():
        result = mesh.apply_changes([[shared]] * 6)
    misses = reg.counter("codecs.decode_cache.misses").value
    hits = reg.counter("codecs.decode_cache.hits").value
    assert misses <= 1, "shards must share the decode parse, not re-miss"
    assert hits >= 5 - misses
    assert f0.actors.find("ff" * 4) != f1.actors.find("ff" * 4)
    assert canon(result[docs0[1]]) == canon(result[docs1[1]])
    want = TorchOpSet().apply_changes([shared])
    jax_result = jax_mesh.apply_changes([[shared]] * 6)
    for d in range(6):
        assert canon(result[d]) == canon(jax_result[d]), f"doc={d}"
    for d in (docs0[1], docs1[1]):
        assert canon(result[d]) == canon(want), f"shared-buffer doc={d}"
