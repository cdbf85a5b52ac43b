"""The IPA attention kernel (``ipa_attention_kernel``, one launch a block of
the structure network) against its roofline: the least time of its launches
at their logical shapes (``benchmark/roofline_structure.py``: z, the
projections and points read once, the output written once; fp32) over
their device time in the trace."""

from benchmark import roofline_structure

KERNEL = "ipa_attention_kernel"


def read(record):
    t = record.trace
    if t is None:
        return None
    secs, launches = t.kernel_s([KERNEL])
    if launches < 1 or secs <= 0:
        return None
    B, L = record.counters["batch"], record.counters["rows"]
    return 100.0 * launches * roofline_structure.ipa_attention_bound_s(B, L) / secs
