"""Sampled complexes whose PDB text was complete within the window, per
second of the window."""


def read(record):
    return record.completed / record.window_s if record.window_s > 0 else None
