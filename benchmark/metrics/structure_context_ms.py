"""Host milliseconds per traced batch in the program's span
``structure.context`` (the batch's static context of the structure
network: the pair representation z and the pocket rows' embeddings)."""

from benchmark import program_spans


def read(record):
    return program_spans.per_unit_ms(program_spans.recorded(), "structure.context",
                                     "sampler.dispatch")
