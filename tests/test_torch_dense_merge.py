"""The dense merge kernel's contract on the CPU: the NumPy mirror of its
algorithm (``dense_merge_cases.mirror_merge``) equals ``merge_docs`` bit for
bit on every case the card test runs, the wrapper refuses what the kernel
does not take before any launch, and ``batched_apply_ops`` on CPU tensors
is still the plain version. The kernel itself runs only on the card
(``test_torch_dense_merge_card.py``, ``chip_smoke.py`` phase 20)."""
import re

import numpy as np
import pytest
import torch

from automerge_tpu_torch import kernels
from automerge_tpu_torch.tpu import engine, merge_kernels
from dense_merge_cases import CASES, case_rounds, empty_state_np, mirror_merge

NAMES = ("key", "op", "action", "value", "pred", "overwritten", "num_ops")


def _state(docs, capacity):
    return engine.make_empty_state(docs, capacity, device="cpu")


def _changes(docs, m):
    cols = [np.full((docs, m), engine.PAD_KEY, np.int32),
            np.zeros((docs, m), np.int64), np.zeros((docs, m), np.int32),
            np.zeros((docs, m), np.int64), np.full((docs, m), -1, np.int64)]
    return engine.changes_from_numpy(*cols, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_mirror_equals_merge_docs(name):
    """Round by round, all seven columns of every row, two seeds; the
    mirror's tiles are 5 rows, so every case crosses tiles."""
    for seed in (0, 1):
        docs, capacity, rounds = case_rounds(name, seed)
        mirror = empty_state_np(docs, capacity)
        state = _state(docs, capacity)
        for r, batch in enumerate(rounds):
            mirror_merge(mirror, batch)
            engine.apply_ops_plain(
                state, engine.changes_from_numpy(*batch, device="cpu"))
            for col, got, want in zip(NAMES, mirror, state):
                want = want.numpy()
                assert got.dtype == want.dtype, (name, col)
                assert np.array_equal(got, want), (name, seed, r, col)


def _bad_args():
    """(what, state, changes) the kernel does not take, on the CPU."""
    good = (_state(2, 16), _changes(2, 8))
    s, c = good
    yield "state dtype", s._replace(op=s.op.int()), c
    yield "changes dtype", s, c._replace(value=c.value.int())
    yield "overwritten dtype", s._replace(
        overwritten=s.overwritten.to(torch.uint8)), c
    yield "num_ops shape", s._replace(num_ops=s.num_ops[:1]), c
    yield "changes docs", s, engine.ChangeOpsBatch(*(x[:1] for x in c))
    yield "state not contiguous", s._replace(
        pred=torch.full((16, 2), -1, dtype=torch.int64).t()), c
    yield "no change rows", s, _changes(2, 0)
    yield "too many change rows", s, _changes(
        2, merge_kernels.MAX_CHANGE_ROWS + 1)
    yield "one-dimensional state", s._replace(key=s.key[0]), c
    yield "on the CPU", s, c


def test_wrapper_refuses_before_any_launch(monkeypatch):
    """Every refusal is raised by the argument check, before the library
    is loaded or built (there is no nvcc here) and with no launch
    counted."""
    def no_load(name):
        raise AssertionError(f"loaded {name} for a refused merge")

    monkeypatch.setattr(merge_kernels, "load", no_load)
    merge_kernels.reset_launch_counts()
    refused = []
    for what, state, changes in _bad_args():
        with pytest.raises((TypeError, ValueError)) as err:
            merge_kernels.dense_merge(state, changes)
        # all but the last are refused for their own fault, not the device
        assert ("runs on the card" in str(err.value)) == (
            what == "on the CPU"), (what, err.value)
        refused.append(what)
    assert len(refused) == 10
    assert merge_kernels.LAUNCHES["dense_merge"] == 0


def test_cpu_path_is_merge_docs(monkeypatch):
    """For CPU tensors ``batched_apply_ops`` never reaches the kernel's
    wrapper, and its result is ``merge_docs``' columns with ``num_ops``
    counting the real rows."""
    def no_kernel(*args):
        raise AssertionError("the kernel's wrapper ran for CPU tensors")

    monkeypatch.setattr(engine, "dense_merge", no_kernel)
    docs, capacity, rounds = case_rounds("past_capacity", 3)
    state = _state(docs, capacity)
    handed = np.zeros(docs, np.int64)
    for batch in rounds:
        changes = engine.changes_from_numpy(*batch, device="cpu")
        want = engine.merge_docs(*(c.clone() for c in state[:6]), *changes)
        assert engine.batched_apply_ops(state, changes) is state
        for got, w in zip(state[:6], want):
            assert torch.equal(got, w)
        handed += (batch[0] != engine.PAD_KEY).sum(1)
    assert np.array_equal(state.num_ops.numpy(), handed)
    assert merge_kernels.LAUNCHES["dense_merge"] == 0


def test_change_rows_fit_the_default_shared_memory():
    """The wrapper's cap on change rows keeps the kernel's dynamic shared
    memory (``kSmemPerRow`` bytes a row, read from its source) within the
    48 KiB a block has without opting in, which the kernel never asks
    for; the cap itself passes the argument check (CPU tensors are then
    refused for their device alone)."""
    src = kernels.SOURCES["dense_merge"].read_text()
    expr = re.search(r"kSmemPerRow = ([^;]+);", src).group(1)
    per_row = sum(int(a) * int(b) for a, b in
                  re.findall(r"(\d+) \* (\d+)", expr))
    cap = merge_kernels.MAX_CHANGE_ROWS
    assert per_row == merge_kernels.SMEM_BYTES_PER_ROW
    assert cap * per_row <= 48 * 1024 < (cap + 1) * per_row
    assert "cudaFuncSetAttribute" not in src
    with pytest.raises(ValueError, match="runs on the card"):
        merge_kernels.check_dense_merge_args(_state(2, 16), _changes(2, cap))


def test_kernel_source_is_built_with_the_others():
    assert kernels.SOURCES["dense_merge"].name == "dense_merge.cu"
    assert kernels.SOURCES["dense_merge"].exists()
    assert kernels.library_path("dense_merge").name.startswith(
        "libdense_merge_")
