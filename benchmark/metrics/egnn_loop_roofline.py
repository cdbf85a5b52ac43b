"""Loop kernels #4 (``egnn_loop_fwd_kernel``) and #6 (``egnn_loop_bwd_kernel``
with its ``egnn_loop_reduce_kernel``) against their roofline: the least time
of a training step's forward and backward launches of both layers at the
layers' logical shapes (``benchmark/roofline.py``, in the configuration's
mode), times the steps traced, over their device time."""

from benchmark import roofline

FWD, BWD, REDUCE = "egnn_loop_fwd_kernel", "egnn_loop_bwd_kernel", "egnn_loop_reduce_kernel"


def read(record):
    t = record.trace
    if t is None:
        return None
    secs, _ = t.kernel_s([FWD, BWD, REDUCE])
    _, fwd = t.kernel_s([FWD])
    if fwd < 2 or secs <= 0:
        return None
    B, mode = record.counters["batch"], record.cell.config["mode"]
    step = sum(roofline.loop_bound_s(B, H, O, mode, backward=b)
               for H, O in roofline.LAYERS for b in (False, True))
    return 100.0 * (fwd / 2) * step / secs
