"""The comparison that decides ``correct`` for the structure network's
cells: the program's sampling chain against the plain reference
(``model.py``), on the same weights and inputs.

As ``benchmark/reference/check.py::chain_gaps`` does for the EGNN, the
reference follows the program's chain from the program's own recorded
states: it draws the start noise and every step's noise from the batch's
generator seed, runs each segment of steps between two recorded states
with this network's score, and compares its state at the segment's end
with the program's (``chain_gap``: the 99th percentile over rows and
segments of each row's largest difference in quaternion, translation and
torsion components), then goes on from the program's state. The final
state to the PDB text is compared on its own (``pdb_gap_A``). A strided
chain (the few-step sampler) jumps between evenly spaced timesteps with
the schedule's scalars between them (``jump_scalars``). The
schedule, the noise, the reverse step, the batch and the PDB comparison
are the EGNN reference's, imported. The reference builds a batch's
context (z) once, as the program does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import model as diffusion
from benchmark.reference.check import _row_gap, model_batch, pdb_gap
from benchmark.reference_structure import model as ref


def timesteps(steps: int, num_steps: int | None = None) -> List[int]:
    """The chain's timesteps T, ..., 0: every one, or ``num_steps`` jumps
    evenly spaced (rounded, duplicates dropped) as the strided sampler
    takes them."""
    if num_steps is None or num_steps == steps:
        return list(range(steps, -1, -1))
    grid = np.unique(np.round(np.linspace(0.0, steps, num_steps + 1)).astype(np.int64))
    return [int(x) for x in grid[::-1]]


def jump_scalars(steps: int, t: int, s: int) -> tuple:
    """The reverse step's scalars of a jump t -> s: the schedule's formulas
    (``Schedule``) between t and s instead of t and t - 1."""
    beta = diffusion.BETA_MIN + (diffusion.BETA_MAX - diffusion.BETA_MIN) * np.array(
        [t, s], np.float64) / steps
    alpha, sigma = np.sqrt(1.0 - beta), np.sqrt(beta)
    alpha_ts = alpha[0] / alpha[1]
    sqr_sigma_ts = sigma[0] ** 2 - sigma[1] ** 2 * alpha_ts
    sigma_ts = np.sqrt(max(sqr_sigma_ts, 0.0))
    sigma_t2s = sigma_ts * sigma[1] / sigma[0] if sigma[0] > 0 else 0.0
    return tuple(float(np.float32(x)) for x in (beta[0], sigma[0], beta[1], alpha_ts,
                                                sqr_sigma_ts, sigma_t2s))


def chain_gaps(w, batch, seed: int, states: List[tuple], steps: int, n_real: int,
               cfg: dict = ref.CONFIG, num_steps: int | None = None) -> np.ndarray:
    """Each real row's gap at the end of each of the program's segments
    (``num_steps``: the strided chain's jumps)."""
    device = batch["mask"].device
    schedule = diffusion.Schedule(steps)
    ts = timesteps(steps, num_steps)
    g = torch.Generator(device=device).manual_seed(int(seed))
    B, N = batch["mask"].shape
    q, t, tors = diffusion.draw_noise(g, (B, N))
    mask = batch["mask"].bool()
    by_k = {k: (sq, st, stors) for k, sq, st, stors in states}
    if len(ts) - 1 not in by_k:
        raise ValueError(f"the program's chain states end at {max(by_k, default=0)}, "
                         f"not {len(ts) - 1}")
    gaps = []
    with torch.no_grad():
        ctx = ref.context(w, batch, cfg)
        for k, (step_t, step_s) in enumerate(zip(ts[:-1], ts[1:])):
            tm = torch.full((B,), step_t / steps, dtype=torch.float32, device=device)
            pred = ref.score(w, ctx, q, t, tors, tm, cfg)
            scalars = (schedule.step_scalars(step_t) if step_s == step_t - 1
                       else jump_scalars(steps, step_t, step_s))
            q, t, tors = diffusion.reverse_step((q, t, tors), pred, diffusion.draw_noise(g, (B, N)),
                                                scalars)
            if k + 1 in by_k:
                pq, pt, ptors = (x.to(device) for x in by_k[k + 1])
                gap = torch.stack((_row_gap(q, pq, mask), _row_gap(t, pt, mask),
                                   _row_gap(tors, ptors, mask))).amax(0)
                gaps.append(gap[:n_real].cpu())
                q, t, tors = pq.clone(), pt.clone(), ptors.clone()
    return torch.stack(gaps).numpy()


def check_sampling(w, pool, rows: Sequence[int], n_real: int, seed: int, states: List[tuple],
                   texts: Sequence[bytes], steps: int, device, cfg: dict = ref.CONFIG,
                   num_steps: int | None = None) -> Dict[str, float]:
    """``chain_gap`` and ``pdb_gap_A`` of one dispatched batch: ``rows`` are
    its pool rows with the padding, the first ``n_real`` real, ``texts``
    the answers of those (``num_steps``: a strided chain's jumps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = model_batch(pool, rows, device)
    gaps = chain_gaps(w, batch, seed, states, steps, n_real, cfg, num_steps)
    final = [x[:n_real] for x in states[-1][1:]]
    return {"chain_gap": float(np.quantile(gaps, 0.99)),
            "pdb_gap_A": pdb_gap(final, pool, rows[:n_real], texts)}
