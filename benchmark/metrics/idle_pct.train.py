"""Share of the traced window in which no operation ran on the card (on a
mesh, the mean over the cards)."""


def read(record):
    busy, window = record.counters.get("busy_s"), record.counters.get("trace_window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
