"""Device milliseconds per 100 sampler steps in every kernel but layer kernel
#1 (two launches a step): the sampler's elementwise work, the noise, the
reverse step, the PDB conversion."""

KERNEL = "egnn_fused_kernel"


def read(record):
    t = record.trace
    if t is None:
        return None
    _, launches = t.kernel_s([KERNEL])
    other, _ = t.kernel_s([KERNEL], exclude=True)
    return 1e3 * other / (launches / 2) * 100 if launches >= 2 else None
