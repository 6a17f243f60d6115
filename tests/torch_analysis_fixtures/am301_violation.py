"""AM301 violating fixture: a host-only module imports the device layer."""
# amlint: host-only
import torch

from automerge_tpu_torch.tpu import engine


def encode(rows):
    return torch.as_tensor(rows, dtype=torch.int64), engine
