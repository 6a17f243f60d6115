"""The farm's packing-limit and routing regressions, the port against the
JAX package: twins of every case of tests/test_farm_regressions.py (the
interner caps, the merge-key packing range, the element budget with
duplicate and queued inserts, a queued list change released by a map-only
delivery, the prevalidation skip). A limit the JAX test monkeypatches is
patched in each package's own module, and the prevalidation spy wraps
each package's own farm class. ``twin_pkgs`` holds the port's record
equal to the JAX package's."""
import pytest

from test_farm_regressions import _insert_ops, make_change
from test_torch_faults_domain import outcome, twin_pkgs

MISSING_DEP = "00" * 32


def _root_set(key, value):
    return [{"action": "set", "obj": "_root", "key": key, "value": value,
             "pred": []}]


def test_interner_max_size_enforced(monkeypatch):
    def scenario(P, rec):
        interner = P.transcode._Interner(max_size=2, name="slot")
        assert interner.intern("a") == 0
        assert interner.intern("b") == 1
        assert interner.intern("a") == 0
        with pytest.raises(ValueError, match="slot table overflow") as exc:
            interner.intern("c")
        rec.value((type(exc.value).__name__, str(exc.value)))

    twin_pkgs(scenario, monkeypatch)


def test_farm_interners_are_capped(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(1)
        assert farm.slots.max_size == 1 << 19
        assert farm.actors.max_size == 1 << 20
        rec.value((farm.slots.max_size, farm.actors.max_size))

    twin_pkgs(scenario, monkeypatch)


def test_map_op_counter_beyond_packing_range_rejected(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(1)
        buf, _ = make_change("aaaaaaaa", 1, 1, [], _root_set("a", 1))
        farm.apply_changes([[buf]])
        big, _ = make_change("aaaaaaaa", 2, 1 << 24, [farm.get_heads(0)[0]],
                             _root_set("b", 2))
        with pytest.raises(ValueError, match="packing range") as exc:
            farm.apply_changes([[big]], isolation="batch")
        rec.value((type(exc.value).__name__, str(exc.value)))
        result = farm.apply_changes([[big]])
        assert result.outcomes[0].status == "quarantined"
        assert result.outcomes[0].error_kind == "packing"
        assert len(farm.get_all_changes(0)) == 1
        patch = farm.get_patch(0)
        assert set(patch["diffs"]["props"]) == {"a"}
        rec.value(outcome(result.outcomes[0]))
        rec.patch(patch)

    twin_pkgs(scenario, monkeypatch)


def test_duplicate_delivery_does_not_count_toward_elem_budget(monkeypatch):
    def scenario(P, rec):
        monkeypatch.setattr(P.rga, "MAX_ELEMS", 4)
        farm = P.farm(1)
        opset = P.OpSet()
        buf1, h1 = make_change("aaaaaaaa", 1, 1, [], [
            {"action": "makeList", "obj": "_root", "key": "l", "pred": []}])
        buf2, _ = make_change("aaaaaaaa", 2, 2, [h1], _insert_ops(3))
        farm.apply_changes([[buf1]])
        farm.apply_changes([[buf2]])
        opset.apply_changes([buf1, buf2])
        result = farm.apply_changes([[buf2]])
        expected = opset.apply_changes([buf2])
        assert result[0] == expected
        rec.value(outcome(result.outcomes[0]))
        rec.patch(result[0])

    twin_pkgs(scenario, monkeypatch)


def test_queued_inserts_count_toward_elem_budget(monkeypatch):
    def scenario(P, rec):
        monkeypatch.setattr(P.rga, "MAX_ELEMS", 4)
        farm = P.farm(1)
        buf1, h1 = make_change("aaaaaaaa", 1, 1, [], [
            {"action": "makeList", "obj": "_root", "key": "l", "pred": []}])
        farm.apply_changes([[buf1]])
        qbuf, _ = make_change("bbbbbbbb", 1, 10, [MISSING_DEP],
                              _insert_ops(2))
        farm.apply_changes([[qbuf]])
        assert farm.get_patch(0)["pendingChanges"] == 1
        buf3, _ = make_change("aaaaaaaa", 2, 2, [h1], _insert_ops(3))
        with pytest.raises(ValueError, match="list elements") as exc:
            farm.apply_changes([[buf3]], isolation="batch")
        rec.value((type(exc.value).__name__, str(exc.value)))
        result = farm.apply_changes([[buf3]])
        assert result.outcomes[0].status == "quarantined"
        assert len(farm.get_all_changes(0)) == 1
        rec.value(outcome(result.outcomes[0]))
        rec.patch(farm.get_patch(0))

    twin_pkgs(scenario, monkeypatch)


def test_queued_list_change_released_by_map_only_delivery(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(1)
        opset = P.OpSet()
        buf1, h1 = make_change("aaaaaaaa", 1, 1, [], _root_set("a", 1))
        buf2, _ = make_change(
            "bbbbbbbb", 1, 2, [h1],
            [{"action": "makeList", "obj": "_root", "key": "l", "pred": []},
             {"action": "set", "obj": "2@bbbbbbbb", "elemId": "_head",
              "insert": True, "value": "x", "pred": []}])
        for buf in (buf2, buf1):
            p_farm = farm.apply_changes([[buf]])[0]
            p_ref = opset.apply_changes([buf])
            assert p_farm == p_ref
            rec.patch(p_farm)
        assert farm.get_patch(0) == opset.get_patch()
        rec.patch(farm.get_patch(0))

    twin_pkgs(scenario, monkeypatch)


def test_prevalidation_skipped_for_docs_with_no_delivery(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(2)
        qbuf, _ = make_change("bbbbbbbb", 1, 10, [MISSING_DEP],
                              _root_set("q", 1))
        farm.apply_changes([[qbuf], []])
        assert farm.get_patch(0)["pendingChanges"] == 1
        prevalidated = []
        orig = P.Farm._prevalidate_limits

        def spy(self, d, decoded):
            prevalidated.append(d)
            return orig(self, d, decoded)

        monkeypatch.setattr(P.Farm, "_prevalidate_limits", spy)
        buf, _ = make_change("aaaaaaaa", 1, 1, [], _root_set("a", 1))
        farm.apply_changes([[], [buf]])
        assert prevalidated == [1]
        buf2, _ = make_change("aaaaaaaa", 1, 1, [], _root_set("b", 2))
        farm.apply_changes([[buf2], []])
        assert prevalidated == [1, 0]
        rec.value(prevalidated)

    twin_pkgs(scenario, monkeypatch)
