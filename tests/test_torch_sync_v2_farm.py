"""Sync v2's device fingerprints and the farm's batched sweep, the port
against the JAX package: twins of tests/test_sync_v2.py's
``TestHostDeviceParity`` (bit-identical fingerprints, a multi-doc batch,
the empty query list), the two ``TestConvergence`` cases that
test_torch_sync_v2.py does not hold (the round-trip bound at scale, a
converged channel going silent) and ``TestFarmBatchedFingerprints`` (at
most one ``sync.fingerprint_ranges`` dispatch per sweep, read from each
package's own observatory).

Each scenario is the JAX test written once over a package namespace and
run through both packages (``twin_pkgs``); it makes the JAX test's
assertions and records fingerprints, messages, heads, round trips and
dispatch counts, which must be equal. The tolerance is zero."""
import hashlib
import math
import random

from test_torch_faults_domain import twin_pkgs


def fake_hash(i) -> str:
    return hashlib.sha256(str(i).encode()).hexdigest()


def grow_backend(P, backend, actor, keys, start_seq=1):
    for i, key in enumerate(keys):
        buf = P.columnar.encode_change({
            "actor": actor, "seq": start_seq + i, "startOp": start_seq + i,
            "time": 0, "deps": P.backend.get_heads(backend),
            "ops": [{"action": "set", "obj": "_root", "key": key,
                     "datatype": "uint", "value": i, "pred": []}],
        })
        backend, _ = P.backend.apply_changes(backend, [buf])
    return backend


def make_backend(P, actor, n):
    return grow_backend(P, P.backend.init(), actor,
                        [f"k{i}" for i in range(n)])


def converge_v2(P, ba, bb, rec, max_round_trips=64):
    V2 = P.sync_v2
    sa, sb = P.sync.init_sync_state(), P.sync.init_sync_state()
    ia, ib = V2.index_for_backend(ba), V2.index_for_backend(bb)
    trips = 0
    for _ in range(max_round_trips):
        sa, ma = V2.generate_sync_message_v2(ba, sa, ia)
        sb, mb = V2.generate_sync_message_v2(bb, sb, ib)
        rec.changes([m for m in (ma, mb) if m is not None])
        if ma is None and mb is None:
            break
        trips += 1
        if ma is not None:
            bb, sb, _ = V2.receive_sync_message_v2(bb, sb, ib, ma)
        if mb is not None:
            ba, sa, _ = V2.receive_sync_message_v2(ba, sa, ia, mb)
    return ba, bb, trips


def device_index(P):
    return P.fingerprint.FingerprintIndex(**P.cpu)


def counted(P, fn):
    """``fn()`` with the package's observatory on; returns (its result, the
    ``sync.fingerprint_ranges`` dispatches it made)."""
    prog = fingerprint_program(P)
    with P.prof.enabled_observatory():
        before = prog.dispatches
        out = fn()
        return out, prog.dispatches - before


# ---------------------------------------------------------------------- #
# TestHostDeviceParity


def test_fingerprints_bit_identical(monkeypatch):
    def scenario(P, rec):
        V2 = P.sync_v2
        rng = random.Random(5)
        hashes = sorted(fake_hash(i) for i in range(150))
        host = V2.HashIndex(hashes)
        device = device_index(P)
        device.sync_doc(0, hashes)
        spans = [(V2.MIN_HASH, V2.MAX_HASH), (hashes[0], hashes[1]),
                 (hashes[3], hashes[3])]
        for _ in range(25):
            i, j = sorted(rng.sample(range(len(hashes)), 2))
            spans.append((hashes[i], hashes[j]))
        got_host = host.fingerprint_many(spans)
        got_device, n = counted(P, lambda: device.fingerprint_ranges(
            [(0, lo, hi) for lo, hi in spans]))
        assert got_host == got_device
        assert n == 1
        rec.value((got_device, n))

    twin_pkgs(scenario, monkeypatch)


def test_multi_doc_batch_keeps_documents_apart(monkeypatch):
    def scenario(P, rec):
        V2 = P.sync_v2
        MIN, MAX = V2.MIN_HASH, V2.MAX_HASH
        device = device_index(P)
        a = sorted(fake_hash(f"a{i}") for i in range(40))
        b = sorted(fake_hash(f"b{i}") for i in range(9))
        device.sync_doc(0, a)
        device.sync_doc(1, b)
        got, n = counted(P, lambda: device.fingerprint_ranges([
            (0, MIN, MAX), (1, MIN, MAX), (1, b[2], b[5]), (0, a[0], a[0]),
        ]))
        assert got[0] == V2.HashIndex(a).fingerprint_many([(MIN, MAX)])[0]
        assert got[1] == V2.HashIndex(b).fingerprint_many([(MIN, MAX)])[0]
        assert got[2] == V2.HashIndex(b).fingerprint_many([(b[2], b[5])])[0]
        assert got[3] == (0, "0" * 64)
        assert n == 1
        rec.value((got, n))

    twin_pkgs(scenario, monkeypatch)


def test_empty_query_list_dispatches_nothing(monkeypatch):
    def scenario(P, rec):
        got, n = counted(P, lambda: device_index(P).fingerprint_ranges([]))
        assert got == [] and n == 0
        rec.value(n)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# TestConvergence (the four divergent-history cases are
# test_torch_sync_v2.py::test_single_document_v2_matches_jax)


def test_round_trip_bound_holds_at_scale(monkeypatch):
    def scenario(P, rec):
        shared = [f"s{i}" for i in range(64)]
        ba = make_backend(P, "aaaaaaaa", 0)
        ba = grow_backend(P, ba, "cccccccc", shared)
        bb = grow_backend(P, P.backend.init(), "cccccccc", shared)
        ba = grow_backend(P, ba, "aaaaaaaa", [f"a{i}" for i in range(130)])
        bb = grow_backend(P, bb, "bbbbbbbb", [f"b{i}" for i in range(170)])
        ba, bb, trips = converge_v2(P, ba, bb, rec)
        assert P.backend.get_heads(ba) == P.backend.get_heads(bb)
        assert trips <= 2 * math.log2(64 + 130 + 170)
        rec.value((trips, P.backend.get_heads(ba)))

    twin_pkgs(scenario, monkeypatch)


def test_converged_channel_is_silent(monkeypatch):
    def scenario(P, rec):
        V2, S = P.sync_v2, P.sync
        ba = make_backend(P, "aaaaaaaa", 8)
        bb = make_backend(P, "bbbbbbbb", 8)
        ba, bb, _ = converge_v2(P, ba, bb, rec)
        sa = S.init_sync_state()
        sa, first = V2.generate_sync_message_v2(ba, sa,
                                                V2.index_for_backend(ba))
        assert first is not None
        _bb2, _sb, patch = V2.receive_sync_message_v2(
            bb, S.init_sync_state(), V2.index_for_backend(bb), first)
        rec.changes([first])
        rec.patch(patch)
        _, _, trips = converge_v2(P, ba, bb, rec)
        assert trips == 0 or trips <= 3
        rec.value(trips)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# TestFarmBatchedFingerprints

NUM_DOCS = 4


def farm_edit(P, farm, d, actor, seq, start_op, keys):
    buf = P.columnar.encode_change({
        "actor": actor, "seq": seq, "startOp": start_op, "time": 0,
        "deps": sorted(farm.get_heads(d)),
        "ops": [{"action": "set", "obj": "_root", "key": k,
                 "datatype": "uint", "value": v, "pred": []}
                for v, k in enumerate(keys)],
    })
    per_doc = [[] for _ in range(farm.num_docs)]
    per_doc[d] = [buf]
    farm.apply_changes(per_doc)


def make_pair(P):
    fa = P.farm(NUM_DOCS, capacity=256)
    fb = P.farm(NUM_DOCS, capacity=256)
    for d in range(NUM_DOCS):
        farm_edit(P, fa, d, "aaaaaaaa", 1, 1, [f"a{d}", f"x{d}"])
        farm_edit(P, fb, d, "bbbbbbbb", 1, 1, [f"b{d}"])
    SyncFarm = P.sync_farm.SyncFarm
    return SyncFarm(fa), SyncFarm(fb)


def fingerprint_program(P):
    return P.prof.get_observatory().programs()["sync.fingerprint_ranges"]


def test_converges_with_one_dispatch_per_sweep(monkeypatch):
    def scenario(P, rec):
        SyncFarm = P.sync_farm.SyncFarm
        sa, sb = make_pair(P)
        n = NUM_DOCS
        a_states = [SyncFarm.init_state() for _ in range(n)]
        b_states = [SyncFarm.init_state() for _ in range(n)]
        protocols = ["v2"] * n
        prog = fingerprint_program(P)
        per_sweep = []
        with P.prof.enabled_observatory():
            prog.reset()
            for _ in range(12):
                before = prog.dispatches
                out = sa.generate_messages(list(zip(range(n), a_states)),
                                           protocols=protocols)
                per_sweep.append(prog.dispatches - before)
                a_states = [s for s, _ in out]
                sends = [(d, b_states[d], m)
                         for d, (_, m) in enumerate(out) if m is not None]
                rec.changes([m for _, _, m in sends])
                if sends:
                    recv = sb.receive_messages(sends, protocols=protocols)
                    for (d, _, _), (state, _p) in zip(sends, recv):
                        b_states[d] = state
                before = prog.dispatches
                out = sb.generate_messages(list(zip(range(n), b_states)),
                                           protocols=protocols)
                per_sweep.append(prog.dispatches - before)
                b_states = [s for s, _ in out]
                sends = [(d, a_states[d], m)
                         for d, (_, m) in enumerate(out) if m is not None]
                rec.changes([m for _, _, m in sends])
                if sends:
                    recv = sa.receive_messages(sends, protocols=protocols)
                    for (d, _, _), (state, _p) in zip(sends, recv):
                        a_states[d] = state
                if not sends:
                    break
            sweeps = prog.dispatches
        for d in range(n):
            assert sa.farm.get_heads(d) == sb.farm.get_heads(d), f"doc {d}"
            rec.value(sa.farm.get_heads(d))
            rec.patch(sa.farm.get_patch(d))
        assert 0 < sweeps <= 2 * 12
        assert max(per_sweep) <= 1
        rec.value(per_sweep)

    twin_pkgs(scenario, monkeypatch)


def test_single_sweep_with_all_channels_probing_is_one_dispatch(monkeypatch):
    def scenario(P, rec):
        SyncFarm = P.sync_farm.SyncFarm
        sa, _sb = make_pair(P)
        n = NUM_DOCS
        states = [SyncFarm.init_state() for _ in range(n)]
        prog = fingerprint_program(P)
        with P.prof.enabled_observatory():
            prog.reset()
            out = sa.generate_messages(list(zip(range(n), states)),
                                       protocols=["v2"] * n)
            assert prog.dispatches == 1
        assert all(m is not None for _, m in out)
        rec.changes([m for _, m in out])
        rec.value(prog.dispatches)

    twin_pkgs(scenario, monkeypatch)
