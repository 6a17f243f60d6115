"""AM203 clean fixture: every constructor pins its dtype."""
import numpy as np
import torch


def make_rows(n):
    keys = torch.zeros(n, dtype=torch.int32)
    ops = torch.arange(n, dtype=torch.int64)
    vals = torch.tensor([1, 2, 3], dtype=torch.int64)
    pad = np.full(n, -1, np.int64)
    return keys, ops, vals, pad
