"""Requests due in the window and answered with a PDB, per second of the
window (requests answered after the window closed count: they were drained)."""


def read(record):
    return record.completed / record.window_s if record.window_s > 0 else None
