"""The whole sampler step's share of the card's peak in the configuration's
mode: the network's forward FLOPs (``roofline.forward_flops``) times the
steps completed in the window, over the window and the peak."""

from benchmark import roofline


def read(record):
    steps, B = record.counters.get("steps"), record.counters.get("batch")
    if not steps or record.window_s <= 0:
        return None
    rate = roofline.forward_flops(B) * steps / record.window_s
    return 100.0 * rate / (roofline.PEAK_STEP[record.cell.config["mode"]] * record.cards)
