"""Layer kernel #1 (``egnn_fused_kernel``, both layers of every sampler step)
against its roofline: the least time of its launches at the layer's logical
shapes (``benchmark/roofline.py``, in the configuration's mode) over their
device time in the trace. Launches alternate layer 1 and layer 2."""

from benchmark import roofline

KERNEL = "egnn_fused_kernel"


def read(record):
    t = record.trace
    if t is None:
        return None
    secs, launches = t.kernel_s([KERNEL])
    if launches < 2 or secs <= 0:
        return None
    B, mode = record.counters["batch"], record.cell.config["mode"]
    pair = sum(roofline.fused_bound_s(B, H, O, mode) for H, O in roofline.LAYERS)
    return 100.0 * (launches / 2) * pair / secs
