"""Examples of the optimizer steps completed in the window, over all cards,
per second of the window."""


def read(record):
    return record.completed / record.window_s if record.window_s > 0 else None
