"""The error taxonomy, the fault corpus and the sync layer's survival of
malformed traffic, the port against the JAX package: twins of
tests/test_faults.py's ``TestTaxonomy``, ``TestCorrupters`` and
``TestSyncFaults`` (the farm's fault domains are in
test_torch_faults_domain.py, whose ``twin_pkgs`` runs each scenario through
both packages and compares what each observed, with zero tolerance)."""
import pytest

from test_torch_faults_domain import metric_values, twin_pkgs

#: the JAX corpus' names; each package's scenario takes its own entry
CORPUS = ("truncated", "bit_flipped", "corrupt_checksum", "bad_chunk_type",
          "garbage")


def corpus_entry(P, name):
    return next(c for c in P.faults.BYTE_CORPUS if c[0] == name)


# ---------------------------------------------------------------------- #
# taxonomy


def test_hierarchy_keeps_stdlib_bases(monkeypatch):
    def scenario(P, rec):
        e = P.errors
        for cls in (e.DecodeError, e.ChecksumError, e.EncodeError,
                    e.CausalityError, e.PackingLimitError,
                    e.SyncProtocolError):
            assert issubclass(cls, e.AutomergeError)
            assert issubclass(cls, ValueError)
        assert issubclass(e.ChecksumError, e.DecodeError)
        assert issubclass(e.QuarantinedError, e.AutomergeError)
        assert issubclass(e.DeviceFaultError, e.AutomergeError)
        for cls in (e.AutomergeError, e.DecodeError, e.ChecksumError,
                    e.EncodeError, e.CausalityError, e.PackingLimitError,
                    e.SyncProtocolError, e.DeviceFaultError,
                    e.QuarantinedError):
            rec.value([c.__name__ for c in cls.__mro__])

    twin_pkgs(scenario, monkeypatch)


def test_error_kind_dimension(monkeypatch):
    def scenario(P, rec):
        e = P.errors
        kinds = [e.error_kind(cls("x")) for cls in (
            e.DecodeError, e.ChecksumError, e.CausalityError,
            e.PackingLimitError, e.SyncProtocolError, e.DeviceFaultError,
            ValueError, RuntimeError)]
        assert kinds == ["decode", "checksum", "causality", "packing", "sync",
                         "device", "other", "other"]
        rec.value(kinds)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# corrupters


def test_byte_corpus_is_the_same(monkeypatch):
    def scenario(P, rec):
        rec.value([(name, kind) for name, _, kind in P.faults.BYTE_CORPUS])

    twin_pkgs(scenario, monkeypatch)


@pytest.mark.parametrize("name", CORPUS)
def test_byte_corpus_error_kinds(name, monkeypatch):
    def scenario(P, rec):
        _, corrupt, kind = corpus_entry(P, name)
        buf = P.healthy_change("aaaaaaaa", 1, 1)
        poisoned = corrupt(buf)
        assert poisoned != buf
        with pytest.raises(P.errors.DecodeError) as exc_info:
            P.columnar.decode_change(poisoned)
        assert P.errors.error_kind(exc_info.value) == kind
        rec.value(bytes(poisoned))
        rec.value((type(exc_info.value).__name__, str(exc_info.value)))

    twin_pkgs(scenario, monkeypatch)


def test_bad_chunk_type_preserves_checksum(monkeypatch):
    def scenario(P, rec):
        buf = P.faults.bad_chunk_type(P.healthy_change("aaaaaaaa", 1, 1))
        with pytest.raises(P.errors.DecodeError, match="chunk type") as exc:
            P.columnar.decode_change(buf)
        rec.value((bytes(buf), str(exc.value)))

    twin_pkgs(scenario, monkeypatch)


def test_seq_poisons_raise_causality(monkeypatch):
    def scenario(P, rec):
        opset = P.OpSet()
        opset.apply_changes([P.healthy_change("aaaaaaaa", 1, 1)])
        with pytest.raises(P.errors.CausalityError,
                           match="Reuse of sequence number") as reuse:
            opset.apply_changes([P.faults.seq_reused("aaaaaaaa", 1, 2)])
        with pytest.raises(P.errors.CausalityError,
                           match="Skipped sequence number") as skip:
            opset.apply_changes([P.faults.seq_skipped("aaaaaaaa", 5, 2)])
        rec.value((str(reuse.value), str(skip.value)))

    twin_pkgs(scenario, monkeypatch)


def test_missing_dep_queues_forever_without_error(monkeypatch):
    def scenario(P, rec):
        opset = P.OpSet()
        patch = opset.apply_changes([P.faults.missing_dep("bbbbbbbb", 1, 1)])
        assert patch["pendingChanges"] == 1
        assert opset.get_missing_deps() == [P.faults.MISSING_DEP]
        rec.patch(patch)
        rec.value(opset.get_missing_deps())

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# sync-layer survival


def _two_peers(P):
    a = P.backend.init()
    a, _ = P.backend.apply_changes(a, [P.healthy_change("aaaaaaaa", 1, 1)])
    return a, P.sync.init_sync_state()


def test_malformed_message_rejected_state_untouched(monkeypatch):
    def scenario(P, rec):
        Backend, Sync = P.backend, P.sync
        backend, state = _two_peers(P)
        heads = Backend.get_heads(backend)
        valid = Sync.encode_sync_message(
            {"heads": heads, "need": [], "have": [], "changes": []})
        for bad in (P.faults.truncated(valid, keep=3), b"\x00" + valid[1:],
                    P.faults.garbage(16)):
            with pytest.raises(P.errors.SyncProtocolError) as exc_info:
                Sync.receive_sync_message(backend, state, bad)
            assert Backend.get_heads(backend) == heads
            assert state["theirHeads"] is None
            rec.value(str(exc_info.value))
        backend, state, _ = Sync.receive_sync_message(backend, state, valid)
        assert state["theirHeads"] == heads
        rec.value(Sync.encode_sync_state(state))

    twin_pkgs(scenario, monkeypatch)


def test_message_with_poisoned_changes_rejected(monkeypatch):
    def scenario(P, rec):
        Backend, Sync = P.backend, P.sync
        backend, state = _two_peers(P)
        heads = Backend.get_heads(backend)
        poison = P.faults.seq_reused("aaaaaaaa", 1, 2, heads)
        msg = Sync.encode_sync_message(
            {"heads": heads, "need": [], "have": [], "changes": [poison]})
        with pytest.raises(P.errors.SyncProtocolError,
                           match="inapplicable") as exc_info:
            Sync.receive_sync_message(backend, state, msg)
        assert Backend.get_heads(backend) == heads
        clean = P.healthy_change("bbbbbbbb", 1, 2, key="other")
        msg2 = Sync.encode_sync_message(
            {"heads": heads, "need": [], "have": [], "changes": [clean]})
        backend, state, patch = Sync.receive_sync_message(backend, state, msg2)
        assert patch is not None
        rec.value(str(exc_info.value))
        rec.patch(patch)
        rec.value(Backend.save(backend))

    twin_pkgs(scenario, monkeypatch)


def test_rejected_counter_increments(monkeypatch):
    def scenario(P, rec):
        reg = P.registry()
        reg.reset()
        backend, state = _two_peers(P)
        with P.metrics.enabled_metrics():
            with pytest.raises(P.errors.SyncProtocolError):
                P.sync.receive_sync_message(backend, state,
                                            P.faults.garbage(16))
        assert reg.counter("sync.messages.rejected").value == 1
        rec.value(reg.counter("sync.messages.rejected").value)

    twin_pkgs(scenario, monkeypatch)


def test_injection_point_rejects_like_a_wire_fault(monkeypatch):
    def scenario(P, rec):
        backend, state = _two_peers(P)
        valid = P.sync.encode_sync_message(
            {"heads": P.backend.get_heads(backend), "need": [], "have": [],
             "changes": []})
        with P.faults.inject(
            "sync.receive_message",
            P.faults.fail_always(lambda: ValueError("line noise")),
        ):
            with pytest.raises(P.errors.SyncProtocolError) as exc_info:
                P.sync.receive_sync_message(backend, state, valid)
        rec.value(str(exc_info.value))

    twin_pkgs(scenario, monkeypatch)


def test_sync_farm_survives_one_bad_peer(monkeypatch):
    """Besides the JAX test's checks: the bad channel counts one
    ``sync.messages.rejected`` in each package's registry."""
    def scenario(P, rec):
        Sync, SyncFarm = P.sync, P.sync_farm.SyncFarm
        farm = P.farm(3, capacity=32)
        farm.apply_changes(
            [[P.healthy_change(f"{d:08x}", 1, 1, value=d)] for d in range(3)])
        sf = SyncFarm(farm)
        heads = [farm.get_heads(d) for d in range(3)]

        def msg_for(d, changes=()):
            return Sync.encode_sync_message(
                {"heads": heads[d], "need": [], "have": [],
                 "changes": list(changes)})

        good0 = msg_for(0)
        bad1 = P.faults.truncated(msg_for(1), keep=3)
        new2 = P.healthy_change("00000002", 2, 2, heads[2], key="r2")
        good2 = msg_for(2, [new2])
        states = [SyncFarm.init_state() for _ in range(3)]
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            results = sf.receive_messages([
                (0, states[0], good0), (1, states[1], bad1),
                (2, states[2], good2),
            ])
        assert results[1] == (states[1], None)
        assert results[0][0]["theirHeads"] == heads[0]
        assert results[2][1] is not None
        assert len(farm.get_all_changes(2)) == 2
        rejected = metric_values(P, ("sync.messages.rejected",))
        assert rejected == {"sync.messages.rejected": 1}
        rec.value(rejected)
        for state, patch in results:
            rec.value(Sync.encode_sync_state(state))
            rec.patch(patch)
        for d in range(3):
            rec.value(farm.get_heads(d))
            rec.patch(farm.get_patch(d))

    twin_pkgs(scenario, monkeypatch)


def test_peers_converge_after_poisoned_interlude(monkeypatch):
    def scenario(P, rec):
        am = P.am
        a = am.change(am.init("aaaaaaaa"), lambda d: d.__setitem__("x", 1))
        b = am.change(am.init("bbbbbbbb"), lambda d: d.__setitem__("y", 2))
        sa, sb = am.init_sync_state(), am.init_sync_state()
        for _ in range(10):
            sa, msg_ab = am.generate_sync_message(a, sa)
            sb, msg_ba = am.generate_sync_message(b, sb)
            if msg_ab is None and msg_ba is None:
                break
            if msg_ab is not None:
                with pytest.raises(P.errors.SyncProtocolError):
                    am.receive_sync_message(
                        b, sb, P.faults.truncated(msg_ab, keep=5))
                b, sb, _ = am.receive_sync_message(b, sb, msg_ab)
            if msg_ba is not None:
                a, sa, _ = am.receive_sync_message(a, sa, msg_ba)
            rec.value((msg_ab, msg_ba))
        assert dict(a) == dict(b) == {"x": 1, "y": 2}
        rec.doc(a)
        rec.saved(am, a)
        rec.saved(am, b)

    twin_pkgs(scenario, monkeypatch)
