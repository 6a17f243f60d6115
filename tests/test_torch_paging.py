"""Ragged paged op storage, the port against the JAX package: twins of every
case of tests/test_paging.py (the allocator's invariants, slab occupancy on
a mixed-size farm, active-only dispatch, the page tables' rollback under
per-document quarantine and device faults, reads after a partial
delivery). Each scenario makes the JAX test's assertions on one package
and records the allocator's counts, every doc's page count and length,
and every patch; ``twin_pkgs`` holds the port's record equal to the JAX
package's."""
import pytest

from bench import _make_change_stream
from test_torch_faults_domain import twin_pkgs


def _stream(rounds, ops_per_round, seed=0):
    return _make_change_stream(rounds, ops_per_round, seed)


def _pages_consistent(farm, rec):
    """The allocator's view matches the per-doc page tables exactly: every
    allocated page is owned by exactly one document. Records the counts."""
    engine = farm.engine
    owned = [p for d in range(farm.num_docs) for p in engine.page_table[d]]
    assert len(owned) == len(set(owned)), "page owned twice"
    assert 0 not in owned, "PAD page handed out"
    assert len(owned) == engine.pages.allocated
    for d in range(farm.num_docs):
        need = engine.pages.pages_for(int(engine.lengths[d]))
        assert len(engine.page_table[d]) == need, (d, engine.lengths[d])
    rec.value((engine.pages.num_pages, engine.pages.allocated,
               engine.pages.free_count,
               [len(t) for t in engine.page_table],
               [int(n) for n in engine.lengths]))


# ---------------------------------------------------------------------- #
# the allocator


def test_pad_page_reserved(monkeypatch):
    def scenario(P, rec):
        alloc = P.paging.PageAllocator(page_size=8, initial_pages=4)
        pages = alloc.alloc(3)
        assert 0 not in pages
        assert alloc.free_count == 0
        assert alloc.allocated == 3
        rec.value(pages)

    twin_pkgs(scenario, monkeypatch)


def test_ensure_doubles(monkeypatch):
    def scenario(P, rec):
        alloc = P.paging.PageAllocator(page_size=8, initial_pages=4)
        assert not alloc.ensure(3)
        assert alloc.ensure(10)
        assert alloc.num_pages >= 11
        got = alloc.alloc(10)
        assert len(set(got)) == 10
        rec.value((alloc.num_pages, got))

    twin_pkgs(scenario, monkeypatch)


def test_free_recycles(monkeypatch):
    def scenario(P, rec):
        alloc = P.paging.PageAllocator(page_size=8, initial_pages=8)
        pages = alloc.alloc(5)
        alloc.free(pages[:3])
        assert alloc.free_count == 2 + 3
        assert alloc.allocated == 2
        rec.value((pages, alloc.alloc(4)))

    twin_pkgs(scenario, monkeypatch)


def test_pages_for(monkeypatch):
    def scenario(P, rec):
        alloc = P.paging.PageAllocator(page_size=64)
        got = [alloc.pages_for(n) for n in (0, 1, 64, 65)]
        assert got == [0, 1, 1, 2]
        rec.value(got)

    twin_pkgs(scenario, monkeypatch)


def test_misuse_raises_as_jax_does(monkeypatch):
    """A page size that is not a power of two and ``alloc`` past the free
    list: the same exception class and message in both packages."""
    def scenario(P, rec):
        for make in (lambda: P.paging.PageAllocator(page_size=24),
                     lambda: P.paging.PageAllocator(8, 4).alloc(4)):
            with pytest.raises(Exception) as exc_info:
                make()
            rec.value((type(exc_info.value).__name__, str(exc_info.value)))

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# mixed-size farm


def test_occupancy_and_patch_parity(monkeypatch):
    def scenario(P, rec):
        num_docs = 16
        streams = [_stream(d // 4 + 1, 16 * (d % 4 + 1), seed=d)
                   for d in range(num_docs)]
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            farm = P.farm(num_docs, capacity=64, page_size=16)
            opsets = [P.OpSet() for _ in range(num_docs)]
            for r in range(max(len(s) for s in streams)):
                delivery = [[streams[d][r]] if r < len(streams[d]) else []
                            for d in range(num_docs)]
                patches = farm.apply_changes(delivery)
                for d in range(num_docs):
                    if delivery[d]:
                        expected = opsets[d].apply_changes(delivery[d])
                        assert patches[d] == expected, f"doc {d} round {r}"
                    rec.patch(patches[d])
            for d in range(num_docs):
                assert farm.get_patch(d) == opsets[d].get_patch()
        _pages_consistent(farm, rec)
        occ = reg.gauge("farm.pages.occupancy").value
        assert occ >= 0.8, f"page occupancy {occ:.2f} < 0.8"
        lens = farm.engine.lengths
        dense_cells = num_docs * (1 << int(lens.max() - 1).bit_length())
        paged_cells = farm.engine.pages.allocated * farm.engine.pages.page_size
        assert paged_cells < dense_cells
        rec.value((occ, paged_cells, dense_cells))

    twin_pkgs(scenario, monkeypatch)


def test_active_only_dispatch(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(8, capacity=32)
        stream = _stream(3, 8)
        farm.apply_changes([[stream[0]]] * 8)
        tables_before = [list(farm.engine.page_table[d]) for d in range(8)]
        farm.apply_changes([[stream[1]]] + [[]] * 7)
        for d in range(1, 8):
            assert farm.engine.page_table[d] == tables_before[d]
        assert farm.engine.lengths[0] > farm.engine.lengths[1]
        rec.value([list(t) for t in farm.engine.page_table])
        _pages_consistent(farm, rec)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# rollback of the page tables


def test_quarantined_delivery_leaks_no_pages(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(4, capacity=32, quarantine_threshold=None)
        stream = _stream(2, 8)
        farm.apply_changes([[stream[0]]] * 4)
        _pages_consistent(farm, rec)
        before_alloc = farm.engine.pages.allocated
        before_tables = [list(farm.engine.page_table[d]) for d in range(4)]
        bad = P.faults.truncated(stream[1])
        result = farm.apply_changes(
            [[stream[1]], [stream[1]], [bytes(bad)], [stream[1]]])
        assert 2 in result.quarantined
        assert farm.engine.page_table[2] == before_tables[2]
        _pages_consistent(farm, rec)
        assert farm.engine.pages.allocated >= before_alloc
        assert farm.engine.lengths[2] < farm.engine.lengths[1]
        rec.value([list(t) for t in farm.engine.page_table])
        for d in range(4):
            rec.patch(farm.get_patch(d))

    twin_pkgs(scenario, monkeypatch)


def test_counter_overflow_rollback_restores_pages(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(2, capacity=32, quarantine_threshold=None)
        stream = _stream(1, 8)
        farm.apply_changes([[stream[0]]] * 2)
        _pages_consistent(farm, rec)
        snap_pages = list(farm.engine.page_table[0])
        big = P.faults.make_change("cccccccc", 1, 1 << 24, [],
                                   [P.faults.set_op("k", 1)])
        result = farm.apply_changes([[big], []])
        assert 0 in result.quarantined
        assert farm.engine.page_table[0] == snap_pages
        _pages_consistent(farm, rec)
        o = result.outcomes[0]
        rec.value((o.error_kind, str(o.error), o.offending_hashes))
        rec.patch(farm.get_patch(0))

    twin_pkgs(scenario, monkeypatch)


def test_release_quarantine_and_recover(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(2, capacity=32, quarantine_threshold=1)
        stream = _stream(2, 8)
        farm.apply_changes([[stream[0]]] * 2)
        bad = bytes(P.faults.garbage(40))
        farm.apply_changes([[bad], []])
        assert 0 in farm.quarantine
        farm.release_quarantine(0)
        patches = farm.apply_changes([[stream[1]], [stream[1]]])
        assert patches.outcomes[0].status == "applied"
        _pages_consistent(farm, rec)
        assert farm.engine.lengths[0] == farm.engine.lengths[1]
        for patch in patches:
            rec.patch(patch)

    twin_pkgs(scenario, monkeypatch)


def test_device_fault_frees_delta_pages(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(2, capacity=32, quarantine_threshold=None)
        stream = _stream(2, 8)
        farm.apply_changes([[stream[0]]] * 2)
        _pages_consistent(farm, rec)
        with P.faults.inject("engine.apply_batch", P.faults.fail_always()):
            result = farm.apply_changes([[stream[1]]] * 2)
        _pages_consistent(farm, rec)
        rec.value([(o.status, o.fallback) for o in result.outcomes])
        for patch in result:
            rec.patch(patch)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# reads after a partial delivery


def test_get_patch_after_partial_delivery(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(4, capacity=32)
        stream = _stream(2, 8)
        farm.apply_changes([[stream[0]]] * 4)
        farm.apply_changes([[stream[1]], [], [], []])
        ref = P.OpSet()
        ref.apply_changes([stream[0], stream[1]])
        ref_short = P.OpSet()
        ref_short.apply_changes([stream[0]])
        assert farm.get_patch(0) == ref.get_patch()
        assert farm.get_patch(3) == ref_short.get_patch()
        for d in range(4):
            rec.patch(farm.get_patch(d))

    twin_pkgs(scenario, monkeypatch)
