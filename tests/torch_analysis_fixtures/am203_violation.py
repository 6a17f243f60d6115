"""AM203 violating fixture: tensors and arrays built without a dtype in
a module that imports torch."""
import numpy as np
import torch


def make_rows(n):
    keys = torch.zeros(n)
    ops = torch.arange(n)
    vals = torch.tensor([1, 2, 3])
    pad = np.full(n, -1)
    return keys, ops, vals, pad
