"""AM403 suppressed fixture: the one dispatch-point readback, justified."""
# amlint: serve-event-loop


def flush(batch):
    # amlint: disable=AM403 — the batcher's single flush dispatch: device
    # latency is paid here and nowhere else
    return batch.cpu()
