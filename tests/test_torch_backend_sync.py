"""The port's single-document backend and sync loop against the JAX
package's, on the CPU: the same change buffers through both backends give
equal patches, saved bytes, change lists and missing deps; two peers
synced through each package's ``generate_sync_message`` /
``receive_sync_message`` exchange byte-identical messages sweep by sweep;
and persisted sync states encode to the same bytes and round-trip."""
import random

import pytest

from automerge_tpu import backend as JaxBackend
from automerge_tpu import sync as JaxSync
from automerge_tpu.errors import SyncProtocolError as JaxSyncProtocolError
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch import sync as Sync
from automerge_tpu_torch.columnar import decode_change_meta_cached
from automerge_tpu_torch.errors import SyncProtocolError
from test_farm_lists import ListWorkload


def history(seed, n, actors=("aaaaaaaa", "bbbbbbbb")):
    """`n` change buffers of a seeded list/map workload (two actors,
    inserts, deletes, overwrites), each on the previous heads."""
    load = ListWorkload(seed, actors)
    heads, bufs = [], []
    while len(bufs) < n:
        buf = load.next_change(heads)
        if buf:
            bufs.append(buf)
            heads = [decode_change_meta_cached(buf)["hash"]]
    return bufs


def twins(bufs, chunk=3):
    """The same buffers, `chunk` at a time, through both backends; every
    patch must be equal. Returns (jax handle, port handle)."""
    jb, pb = JaxBackend.init(), Backend.init()
    for i in range(0, len(bufs), chunk):
        jb, want = JaxBackend.apply_changes(jb, bufs[i:i + chunk])
        pb, got = Backend.apply_changes(pb, bufs[i:i + chunk])
        assert got == want, f"patch at change {i}"
    return jb, pb


@pytest.mark.parametrize("seed,n", [(1, 12), (2, 30), (3, 45)])
def test_backend_matches_jax(seed, n):
    bufs = history(seed, n)
    jb, pb = twins(bufs)
    assert Backend.get_heads(pb) == JaxBackend.get_heads(jb)
    assert Backend.get_patch(pb) == JaxBackend.get_patch(jb)
    assert Backend.save(pb) == JaxBackend.save(jb)
    rng = random.Random(seed)
    hashes = [decode_change_meta_cached(b)["hash"] for b in bufs]
    for have in ([], hashes[:1], rng.sample(hashes, 3), hashes[-2:]):
        assert Backend.get_changes(pb, have) == JaxBackend.get_changes(jb, have)
    for h in rng.sample(hashes, 4):
        assert (Backend.get_change_by_hash(pb, h)
                == JaxBackend.get_change_by_hash(jb, h))
    # load(save) round-trips to the same document in both packages
    loaded = Backend.load(Backend.save(pb))
    assert Backend.get_patch(loaded) == JaxBackend.get_patch(
        JaxBackend.load(JaxBackend.save(jb)))
    assert Backend.get_heads(loaded) == Backend.get_heads(pb)


@pytest.mark.parametrize("seed", [4, 5])
def test_missing_deps_and_queue_match_jax(seed):
    """Changes delivered with gaps queue in both backends: the same missing
    deps, then the same patch once the gap fills."""
    bufs = history(seed, 16)
    order = list(range(len(bufs)))
    random.Random(seed).shuffle(order)
    gap = sorted(order[:5])
    rest = [bufs[i] for i in range(len(bufs)) if i not in gap]
    jb, pb = twins(rest, chunk=4)
    heads = [decode_change_meta_cached(bufs[-1])["hash"]]
    assert Backend.get_missing_deps(pb) == JaxBackend.get_missing_deps(jb)
    assert (Backend.get_missing_deps(pb, heads)
            == JaxBackend.get_missing_deps(jb, heads))
    jb, want = JaxBackend.apply_changes(jb, [bufs[i] for i in gap])
    pb, got = Backend.apply_changes(pb, [bufs[i] for i in gap])
    assert got == want
    assert Backend.get_missing_deps(pb) == JaxBackend.get_missing_deps(jb) == []


def test_local_change_matches_jax():
    jb, pb = twins(history(6, 6))
    change = {"actor": "cccccccc", "seq": 1, "startOp": 100, "time": 0,
              "deps": [], "ops": [{"action": "set", "obj": "_root",
                                   "key": "local", "datatype": "uint",
                                   "value": 1, "pred": []}]}
    jb2, jpatch, jbuf = JaxBackend.apply_local_change(jb, change)
    pb2, ppatch, pbuf = Backend.apply_local_change(pb, change)
    assert (ppatch, pbuf) == (jpatch, jbuf)
    assert Backend.get_patch(pb2) == JaxBackend.get_patch(jb2)
    with pytest.raises(ValueError, match="outdated"):
        Backend.apply_changes(pb, [])  # the handle before the change


def peers(seed, shared, a_own, b_own):
    """Two peers built in both packages from the same buffers: a shared
    prefix, then A continues the same history while B grows a branch of
    its own by two other actors."""
    bufs = history(seed, shared + a_own)
    extra = history(seed + 100, b_own, ("cccccccc", "dddddddd"))
    return twins(bufs), twins(bufs[:shared] + extra)


def sync_pair(pkg_sync, pkg_backend, a, b, rounds=20):
    """Lockstep driver: both generate, then both receive. Returns the
    messages and patches in order, and the final handles and states."""
    sa, sb = pkg_sync.init_sync_state(), pkg_sync.init_sync_state()
    log = []
    for _ in range(rounds):
        sa, ma = pkg_sync.generate_sync_message(a, sa)
        sb, mb = pkg_sync.generate_sync_message(b, sb)
        log.append((ma, mb))
        if ma is None and mb is None:
            return log, a, b, sa, sb
        if ma is not None:
            b, sb, patch = pkg_sync.receive_sync_message(b, sb, ma)
            log.append(patch)
        if mb is not None:
            a, sa, patch = pkg_sync.receive_sync_message(a, sa, mb)
            log.append(patch)
    raise AssertionError("did not converge")


@pytest.mark.parametrize("seed,shared,a_own,b_own", [
    (7, 0, 10, 0), (8, 6, 9, 7), (9, 12, 0, 5), (10, 20, 30, 25)])
def test_single_document_v1_sync_matches_jax(seed, shared, a_own, b_own):
    (ja, pa), (jb, pb) = peers(seed, shared, a_own, b_own)
    want, ja, jb, jsa, jsb = sync_pair(JaxSync, JaxBackend, ja, jb)
    got, pa, pb, psa, psb = sync_pair(Sync, Backend, pa, pb)
    assert got == want
    assert Backend.get_heads(pa) == Backend.get_heads(pb)
    assert Backend.get_patch(pa) == JaxBackend.get_patch(ja)
    assert Sync.encode_sync_state(psa) == JaxSync.encode_sync_state(jsa)
    assert Sync.encode_sync_state(psb) == JaxSync.encode_sync_state(jsb)


def test_malformed_message_rejects_and_touches_nothing():
    (_, pa), _ = peers(11, 0, 4, 0)
    state = Sync.init_sync_state()
    heads = Backend.get_heads(pa)
    for bad in (b"", b"\x42", b"\x42\xff\xff", b"\x00garbage"):
        with pytest.raises(SyncProtocolError):
            Sync.receive_sync_message(pa, state, bad)
        with pytest.raises(JaxSyncProtocolError):
            JaxSync.receive_sync_message(JaxBackend.init(),
                                         JaxSync.init_sync_state(), bad)
    assert Backend.get_heads(pa) == heads
    assert state == Sync.init_sync_state()


SESSIONS = [
    None,
    {"epoch": 7, "seqOut": 3, "lastSeen": 2, "peerEpoch": None},
    {"epoch": 1 << 31, "seqOut": 1 << 40, "lastSeen": 5, "peerEpoch": 9,
     "wdRounds": 4, "wdStage": 2, "wdStalls": 1, "wdEscalations": 3,
     "wdResets": 1},
]


@pytest.mark.parametrize("session", SESSIONS)
def test_sync_state_codec_matches_jax(session):
    bufs = history(12, 8)
    heads = sorted(decode_change_meta_cached(b)["hash"] for b in bufs[-3:])
    for shared in ([], heads):
        state = dict(Sync.init_sync_state(), sharedHeads=shared)
        blob = Sync.encode_sync_state(state, session=session)
        assert blob == JaxSync.encode_sync_state(state, session=session)
        got = Sync.decode_sync_state(blob)
        assert got == JaxSync.decode_sync_state(blob)
        assert got["sharedHeads"] == shared
        if session is not None:
            assert {k: got["session"][k] for k in session} == session
        for keep in range(len(blob)):
            # a proper prefix either decodes to what the JAX package
            # decodes (it stops between fields) or raises in both
            try:
                want = JaxSync.decode_sync_state(blob[:keep])
            except ValueError:
                with pytest.raises(SyncProtocolError):
                    Sync.decode_sync_state(blob[:keep])
            else:
                assert Sync.decode_sync_state(blob[:keep]) == want
