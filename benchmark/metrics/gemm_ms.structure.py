"""Device milliseconds a sampler step of the structure network in matrix
product kernels (cuBLAS's, every kernel whose name holds ``gemm`` or
``gemv``): its linears and the frames applied to points. Steps are the
IPA attention kernel's launches over the cell's blocks a step
(``num_blocks`` of its configuration)."""

KERNEL = "ipa_attention_kernel"
GEMM = ("gemm", "gemv")


def read(record):
    t = record.trace
    if t is None:
        return None
    _, launches = t.kernel_s([KERNEL])
    steps = launches / record.cell.config["num_blocks"]
    if steps < 1:
        return None
    secs = sum(e - s for n, s, e in t.kernels if any(g in n.lower() for g in GEMM)) / 1e6
    return 1e3 * secs / steps
