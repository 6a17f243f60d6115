"""The dense merge kernel (``csrc/dense_merge.cu``) on the card, held bit for
bit to its plain version (``engine.apply_ops_plain``: ``merge_docs`` and
the copies) on all rows of all seven columns after every round: the cases
of ``dense_merge_cases`` and the dense-100k cell's own shape, 12,500
documents x 14,000 rows at 80 change rows a round, through ~5,000 and
~9,900 held rows. Then the wrapper's refusals on the card and its launch
counters. Every test is marked ``card`` and skips where CUDA is absent
(the ``card`` fixture decides when the test runs). Run on the card with
``python -m pytest tests/test_torch_dense_merge_card.py -q``."""
import numpy as np
import pytest
import torch

from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
from automerge_tpu_torch.tpu import engine, merge_kernels
from dense_merge_cases import CASES, case_rounds, cell_rounds

pytestmark = pytest.mark.card

NAMES = ("key", "op", "action", "value", "pred", "overwritten", "num_ops")
#: the dense-100k cell: documents, rows a document, change rows a round
CELL_DOCS, CELL_ROWS, CELL_WIDTH = 12_500, 14_000, 80
#: rounds of the cell's traffic merged: ~80 rows each, ~9,960 a document
CELL_ROUNDS = 125


@pytest.fixture
def card():
    """The CUDA device; skips without one. The decision is made here, when
    the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _assert_equal(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (what, name)


def _run_both(card, docs, capacity, rounds):
    """The kernel's state and the plain version's, both on the card,
    compared after every round of `rounds`; yields (round, live rows a
    document before it, kernel state)."""
    kern = engine.make_empty_state(docs, capacity, device=card)
    plain = engine.make_empty_state(docs, capacity, device=card)
    for r, batch in enumerate(rounds):
        held = int((kern.key != engine.PAD_KEY).sum()) // docs
        changes = engine.changes_from_numpy(*batch, device=card)
        assert engine.batched_apply_ops(kern, changes) is kern
        engine.apply_ops_plain(plain, changes)
        torch.cuda.synchronize()
        _assert_equal(kern, plain, f"round {r} of {len(rounds)}")
        yield r, held, kern


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain(name, card):
    merge_kernels.reset_launch_counts()
    docs, capacity, rounds = case_rounds(name, 7)
    done = list(_run_both(card, docs, capacity, rounds))
    assert merge_kernels.LAUNCHES["dense_merge"] == len(done)


def test_kernel_equals_plain_at_the_cells_shape(card):
    """12,500 x 14,000 at m = 80, every round compared, through ~5,000 and
    ~9,900 live rows a document (the ~80 rows a round fill 125 rounds to
    ~9,960)."""
    rounds = cell_rounds(CELL_DOCS, CELL_ROUNDS, CELL_WIDTH, 11,
                         device=card)
    held = [h for _r, h, _s in _run_both(card, CELL_DOCS, CELL_ROWS,
                                         rounds)]
    assert any(4_900 <= h <= 5_100 for h in held), held[::10]
    assert held[-1] >= 9_800, held[-1]


def _refused(card):
    state = engine.make_empty_state(4, 32, device=card)
    rows = cell_rounds(4, 1, 8, 0)[0]
    changes = engine.changes_from_numpy(*rows, device=card)
    yield "dtype", state._replace(value=state.value.int()), changes
    yield "not contiguous", state, changes._replace(
        pred=changes.pred.t().contiguous().t())
    yield "no change rows", state, engine.ChangeOpsBatch(
        *(c[:, :0] for c in changes))
    yield "too many change rows", state, engine.ChangeOpsBatch(*(
        c.repeat(1, merge_kernels.MAX_CHANGE_ROWS // 8 + 1)
        for c in changes))
    yield "changes on the CPU", state, engine.ChangeOpsBatch(
        *(c.cpu() for c in changes))


def test_refusals_on_the_card(card):
    """What the kernel does not take raises from ``batched_apply_ops``
    itself (no fallback to the plain version) and launches nothing."""
    merge_kernels.reset_launch_counts()
    for what, state, changes in _refused(card):
        before = [c.clone() for c in state]
        with pytest.raises((TypeError, ValueError)):
            engine.batched_apply_ops(state, changes)
        _assert_equal(state, before, what)
    assert merge_kernels.LAUNCHES["dense_merge"] == 0


def test_one_launch_a_merge(card):
    """Each merge on the card is one kernel launch, counted on the wrapper
    and on ``engine.dense_merge.launches``."""
    rounds = cell_rounds(16, 6, 24, 3)
    counter = get_metrics().counter("engine.dense_merge.launches")
    merge_kernels.reset_launch_counts()
    with enabled_metrics():
        start = counter.value
        state = engine.make_empty_state(16, 256, device=card)
        for batch in rounds:
            engine.batched_apply_ops(
                state, engine.changes_from_numpy(*batch, device=card))
        launched = counter.value - start
    torch.cuda.synchronize()
    assert merge_kernels.LAUNCHES["dense_merge"] == launched == len(rounds)
    handed = sum((b[0] != engine.PAD_KEY).sum(1) for b in rounds)
    assert np.array_equal(state.num_ops.cpu().numpy(), handed)
