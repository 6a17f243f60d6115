"""AM203 suppressed fixture: a dtype-less constructor, justified."""
import torch


def make_rows(n):
    # amlint: disable=AM203 — a float mask whose dtype follows the
    # caller's default on purpose; never packed into opids
    return torch.ones(n)
