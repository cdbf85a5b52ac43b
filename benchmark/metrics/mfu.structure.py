"""The structure network's whole sampler step's share of the card's fp32
peak: its forward's FLOPs (``roofline_structure.forward_flops``) times the
steps completed in the window, over the window and the peak."""

from benchmark import roofline_structure
from benchmark.roofline import PEAK_FP32


def read(record):
    steps, B, L = (record.counters.get(k) for k in ("steps", "batch", "rows"))
    if not steps or not L or record.window_s <= 0:
        return None
    rate = roofline_structure.forward_flops(B, L) * steps / record.window_s
    return 100.0 * rate / (PEAK_FP32 * record.cards)
