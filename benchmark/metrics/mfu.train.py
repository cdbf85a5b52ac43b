"""The whole training step's share of the cards' peak in the configuration's
mode: three forwards' FLOPs (``roofline.forward_flops``) a step at each
card's batch, times the steps each card completed in the window, over the
window and the peak of all the cards."""

from benchmark import roofline


def read(record):
    steps, B = record.counters.get("steps"), record.counters.get("batch")
    if not steps or record.window_s <= 0:
        return None
    rate = 3 * roofline.forward_flops(B) * steps * record.cards / record.window_s
    return 100.0 * rate / (roofline.PEAK_STEP[record.cell.config["mode"]] * record.cards)
