"""Launches of the IPA attention kernel (the program's counter
``ipa_attention.launches.f32``) over the window's sampler steps: the
structure network's blocks a step where the kernel is engaged (8)."""

COUNTER = "ipa_attention.launches.f32"


def read(record):
    n, steps = record.counters.get(COUNTER), record.counters.get("steps")
    if n is None or not steps:
        return None
    return n / steps
