"""Device milliseconds per training step in NCCL kernels (the gradient and
loss-sum all-reduce), on the traced card."""


def read(record):
    t = record.trace
    if t is None:
        return None
    nccl, launches = t.kernel_s(["nccl"])
    _, fwd = t.kernel_s(["egnn_loop_fwd_kernel"])
    return 1e3 * nccl / (fwd / 2) if launches and fwd >= 2 else None
