"""AM403 violating fixture: device readbacks block the serve loop."""
# amlint: serve-event-loop
import torch


def flush(batch):
    torch.cuda.synchronize()
    return batch.numpy(), batch.sum().item()
