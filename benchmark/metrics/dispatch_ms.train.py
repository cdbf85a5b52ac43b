"""Host milliseconds per optimizer step spent in the trainer's call
(``train_indices`` over K steps, or ``train_batch``): enqueueing the steps'
graph replays, plus any wait the call makes for the card."""


def read(record):
    d = record.spans.get("dispatch", [])
    return 1e3 * sum(d) / len(d) if d else None
