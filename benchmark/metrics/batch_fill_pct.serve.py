"""Share of the micro-batcher's dispatched rows that held a request: the
requests of the window's batches over their batches times the batch size
(the rest are padding)."""


def read(record):
    n, B = record.counters.get("batches"), record.counters.get("batch")
    return 100.0 * record.counters["rows"] / (n * B) if n else None
