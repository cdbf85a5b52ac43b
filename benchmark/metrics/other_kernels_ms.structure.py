"""Device milliseconds per 100 sampler steps of the structure network in
every kernel but the IPA attention kernel and the matrix products: the
LayerNorms, activations, frame updates and other elementwise work, the
noise and the reverse step, the batch's context and its PDB conversion.
Steps are the IPA attention kernel's launches over the blocks a step."""

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
    secs = sum(e - s for n, s, e in t.kernels
               if KERNEL not in n and not any(g in n.lower() for g in GEMM)) / 1e6
    return 1e3 * secs / steps * 100
