"""Seconds from the start of the run's process to the start of its measured
window: inputs and weights made, the program built, kernels loaded or built,
CUDA graphs captured, every shape of the cell warmed up."""


def read(record):
    return record.setup_s
