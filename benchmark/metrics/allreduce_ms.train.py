"""Device milliseconds per training step in the gradient and loss-sum
all-reduce (NCCL kernels), the exchange without the wait for the slowest
rank: the k-th all-reduce on every card is the same collective, and each is
taken on the card where it ran shortest, the last to arrive, whose kernel
waits for no peer. Nothing where the cards traced different counts."""


def read(record):
    t = record.trace
    if t is None:
        return None
    cards = [[e - s for n, s, e in sorted(c.kernels, key=lambda k: k[1]) if "nccl" in n]
             for c in record.card_traces or [t]]
    if not cards[0] or any(len(c) != len(cards[0]) for c in cards):
        return None
    _, fwd = t.kernel_s(["egnn_loop_fwd_kernel"])
    exchange_s = sum(min(k) for k in zip(*cards)) / 1e6
    return 1e3 * exchange_s / (fwd / 2) if fwd >= 2 else None
