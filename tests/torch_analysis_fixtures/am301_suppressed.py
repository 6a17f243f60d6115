"""AM301 suppressed fixture: a device import, justified."""
# amlint: host-only
# amlint: disable=AM301 — a lazy debugging hook; the host path never
# calls it
import torch


def encode(rows):
    return torch.as_tensor(rows, dtype=torch.int64)
