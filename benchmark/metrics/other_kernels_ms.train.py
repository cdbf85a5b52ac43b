"""Device milliseconds per training step in every operation but the loop
kernels (#4, #6 and its reduction): the gather, the noise, the network's
elementwise work and projections, the loss, Adam, and on a mesh the
all-reduce."""

LOOP = ("egnn_loop_fwd_kernel", "egnn_loop_bwd_kernel", "egnn_loop_reduce_kernel")


def read(record):
    t = record.trace
    if t is None:
        return None
    _, fwd = t.kernel_s([LOOP[0]])
    other, _ = t.kernel_s(LOOP, exclude=True)
    return 1e3 * other / (fwd / 2) if fwd >= 2 else None
