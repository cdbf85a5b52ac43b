"""The comparisons that decide ``correct``: the program's outputs against the
plain reference on the same weights and inputs.

Sampling. The reverse chain amplifies rounding: two float32 chains of 1000
steps whose networks differ only in summation order end several Angstrom
apart on most rows, so the final structures of two correct programs differ.
The reference therefore follows the program's chain from the program's own
states: it starts from the noise it draws itself from the batch's generator
seed, runs each segment of steps between two of the program's recorded
states with the same per-step noise, and compares its state at the segment's
end with the program's (``chain_gap``: the 99th percentile over rows and
segments of each row's largest difference in quaternion, translation and
torsion components), then goes on from the program's state. The last stage,
the final state to the PDB text, is compared on its own: the atoms the
reference places from the program's final state against the atoms in the
answer (``pdb_gap_A``, Angstrom; the text has 3 decimals), chain M against
the request's own protein.

Training. Per step the mean total loss (``loss_gap``, relative, the worst
of the three steps), the first step's gradients as the optimizer got them
and the parameters' change over three steps, each by leaf: the gap between
the program's norm of the leaf and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. The change is taken by
the worst leaf (``delta_gap``), the gradient by the median leaf
(``grad_gap_median``): in fast-f32 one leaf's gradient (layer 2's attention
lin1 weight, a sum with much cancellation) can read 1.3e-2 on a sound run,
as much as the bf16 control reads, where the program's own fp32 path and a
float64 reference agree with the float32 reference to 2.4e-5 and 1.7e-7
(PERF.md). Leaves whose reference gradient is under a thousandth of the
median leaf's (a bias under the softmax, the unused feature MLP of layer 2)
move by round-off alone under Adam and are left out.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import atoms
from benchmark.reference import model as ref


def model_batch(pool: Dict[str, np.ndarray], rows: Sequence[int], device) -> Dict[str, torch.Tensor]:
    """The reference's batch of pool rows, on ``device``."""
    rows = np.asarray(rows)
    get = lambda k: torch.as_tensor(pool[k][rows]).to(device)  # noqa: E731
    f, pf = get("frames"), get("pocket_frames")
    return {"mask": get("mask").float(), "features": get("features"),
            "pocket_features": get("pocket_features"), "pocket_mask": get("pocket_mask").float(),
            "pocket_quats": pf[..., :4], "pocket_trans": pf[..., 4:], "quats": f[..., :4],
            "trans": f[..., 4:], "torsions": get("torsions"),
            "torsions_mask": get("torsions_mask").float()}


def _row_gap(a, b, mask):
    """Per row, the largest absolute difference over its real residues."""
    d = (a - b).abs().flatten(2).amax(-1)
    return d.masked_fill(~mask, 0.0).amax(-1)


def chain_gaps(w, batch, seed: int, states: List[tuple], steps: int, n_real: int) -> np.ndarray:
    """Each real row's gap at the end of each of the program's segments."""
    device = batch["mask"].device
    schedule = ref.Schedule(steps)
    g = torch.Generator(device=device).manual_seed(int(seed))
    B, N = batch["mask"].shape
    q, t, tors = ref.draw_noise(g, (B, N))
    mask = batch["mask"].bool()
    by_k = {k: (sq, st, stors) for k, sq, st, stors in states}
    if sorted(by_k) != sorted(set(by_k)) or steps not in by_k:
        raise ValueError(f"the program's chain states end at {max(by_k, default=0)}, not {steps}")
    gaps = []
    with torch.no_grad():
        for k, step_t in enumerate(range(steps, 0, -1)):
            tm = torch.full((B,), step_t / steps, dtype=torch.float32, device=device)
            pred = ref.score(w, batch, q, t, tors, tm)
            q, t, tors = ref.reverse_step((q, t, tors), pred, ref.draw_noise(g, (B, N)),
                                          schedule.step_scalars(step_t))
            if k + 1 in by_k:
                pq, pt, ptors = (x.to(device) for x in by_k[k + 1])
                gap = torch.stack((_row_gap(q, pq, mask), _row_gap(t, pt, mask),
                                   _row_gap(tors, ptors, mask))).amax(0)
                gaps.append(gap[:n_real].cpu())
                q, t, tors = pq.clone(), pt.clone(), ptors.clone()
    return torch.stack(gaps).numpy()


def pdb_gap(final_state, pool, rows: Sequence[int], texts: Sequence[bytes]) -> float:
    """The largest distance between an atom of an answer and the atom the
    reference places: chain P from the program's final state, chain M from
    the request's protein. Infinite for a missing or malformed answer."""
    q, t, tors = (x.detach().cpu().numpy() for x in final_state)
    worst = 0.0
    for r, (i, text) in enumerate(zip(rows, texts)):
        if not text:
            return float("inf")
        got = atoms.read_pdb(text)
        want_p = atoms.peptide_atoms(q[r], t[r], tors[r], pool["aatype"][i], pool["mask"][i])
        plen = int(pool["protein_len"][i])
        want_m = atoms.protein_atoms(pool["protein_aatype"][i, :plen],
                                     pool["protein_atom14_positions"][i, :plen],
                                     pool["protein_atom14_exists"][i, :plen])
        worst = max(worst, atoms.atoms_gap(got.get("P", []), want_p),
                    atoms.atoms_gap(got.get("M", []), want_m))
    return worst


def check_sampling(w, pool, rows: Sequence[int], n_real: int, seed: int, states: List[tuple],
                   texts: Sequence[bytes], steps: int, device) -> Dict[str, float]:
    """``chain_gap`` and ``pdb_gap_A`` of one dispatched batch: ``rows`` are
    its pool rows with the padding, the first ``n_real`` real, ``texts``
    the answers of those."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = model_batch(pool, rows, device)
    gaps = chain_gaps(w, batch, seed, states, steps, n_real)
    final = [x[:n_real] for x in states[-1][1:]]
    return {"chain_gap": float(np.quantile(gaps, 0.99)),
            "pdb_gap_A": pdb_gap(final, pool, rows[:n_real], texts)}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> np.ndarray:
    """Per leaf of ``keep``: |norm(got) - norm(want)| / max(norm(want), median leaf norm)."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keep}
    med = float(np.median(list(norms.values())))
    return np.array([abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k])
                     / max(norms[k], med) for k in keep])


def check_training(w, pool, rows: np.ndarray, t_seed: int, noise_seed: int, device,
                   losses: Sequence[float], grads: Dict[str, torch.Tensor],
                   delta: Dict[str, torch.Tensor], lr: float,
                   steps: int = ref.T_STEPS) -> Dict[str, float]:
    """The program's first steps against the reference's: ``rows`` [S, B]
    pool rows of each step, the timesteps drawn per example from a CPU
    generator seeded ``t_seed``, the noise from one on ``device`` seeded
    ``noise_seed``; ``losses`` the program's mean total loss of each step,
    ``grads`` its first gradients, ``delta`` its parameters' change over
    the steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tg = torch.Generator().manual_seed(int(t_seed))
    ng = torch.Generator(device=device).manual_seed(int(noise_seed))
    batches = [model_batch(pool, r, device) for r in rows]
    ts = [torch.randint(0, steps, (len(r),), generator=tg).to(device) for r in rows]
    ref_losses, ref_grads, params = ref.train_steps(w, batches, ts, ng, lr=lr, steps=steps)
    ref_delta = {k: params[k] - w[k] for k in w}
    gn = {k: float(torch.linalg.vector_norm(g)) for k, g in ref_grads.items()}
    med = float(np.median(list(gn.values())))
    keep = [k for k in w if gn[k] >= 1e-3 * med]
    cpu = lambda d: {k: v.detach().to(device) for k, v in d.items()}  # noqa: E731
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_gap_median": float(np.median(leaf_gaps(cpu(grads), ref_grads, keep))),
            "delta_gap": float(leaf_gaps(cpu(delta), ref_delta, keep).max())}
