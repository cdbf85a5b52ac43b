"""Host milliseconds of ``SamplerService.dispatch`` per batch (queueing the
chain from CUDA graphs, no wait for the card), mean over the window."""


def read(record):
    d = record.spans.get("dispatch", [])
    return 1e3 * sum(d) / len(d) if d else None
