"""Host milliseconds of ``SamplerService.finalize`` per batch (waiting for the
batch's arrays, then its PDB text), mean over the window's batches, on the
batcher's finisher thread."""


def read(record):
    d = record.spans.get("finalize", [])
    return 1e3 * sum(d) / len(d) if d else None
