"""AM403 clean fixture: the loop only enqueues."""
# amlint: serve-event-loop


def flush(batch, queue):
    queue.append(batch)
    return len(queue)
