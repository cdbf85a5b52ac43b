"""Host milliseconds per traced batch in the program's span ``sampler.pdb``
(``SamplerService.finalize``: the batch's PDB arrays read and its PDB text
written)."""

from benchmark import program_spans


def read(record):
    return program_spans.per_unit_ms(program_spans.recorded(), "sampler.pdb",
                                     "sampler.dispatch")
