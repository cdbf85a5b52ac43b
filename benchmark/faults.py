"""Faults planted under the timed path, to show that the output check fails
them: the control's and the faults' readings (``benchmark/control.py``) and
the tests (``benchmark/tests/test_bench_faults.py``). None runs in a
benchmark run.

- ``altered_answer``: the sampled frame of residue 1 of each batch's first
  row moved by 0.1 A after the chain, where the PDB arrays are made.
- ``half_batch``: sampling, the reverse step leaves the second half of the
  batch's rows as they were; training, the loss of the second half replaced
  by the first half's, so the mean is over the first half.
- ``unchanged_state``: sampling, the reverse step returns its state as it
  was; training, the optimizer's update left out.
- ``no_exchange``: on a mesh, the gradient all-reduce left out.
"""

from __future__ import annotations

import contextlib


def _patch(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn(old))
    return lambda: setattr(module, name, old)


def altered_answer():
    from pmhc_tpu_torch import serve

    def wrap(convert):
        def f(batch):
            out = convert(batch)
            out["trans"] = out["trans"].clone()
            out["trans"][0, 0, 0] += 0.1
            return out
        return f

    return _patch(serve, "convert_batch_for_pdb", wrap)


def half_batch():
    import torch

    from pmhc_tpu_torch.diffusion import sampler
    from pmhc_tpu_torch.geometry import RigidArray
    from pmhc_tpu_torch.train import trainer

    def wrap_step(step):
        def f(noised, predicted, random_noise, *scalars):
            out = step(noised, predicted, random_noise, *scalars)
            h = noised["torsions"].shape[0] // 2
            nf, of = noised["frames"], out["frames"]
            q = torch.cat((of.quats[:h], nf.quats[h:]))
            t = torch.cat((of.trans[:h], nf.trans[h:]))
            tors = torch.cat((out["torsions"][:h], noised["torsions"][h:]))
            return dict(out, frames=RigidArray(q, t), torsions=tors)
        return f

    def wrap_loss(loss):
        def f(*args, **kwargs):
            out = loss(*args, **kwargs)
            h = next(iter(out.values())).shape[0] // 2
            return {k: torch.cat((v[:h], v[:h])) for k, v in out.items()}
        return f

    undo = [_patch(sampler, "remove_noise_scalars", wrap_step),
            _patch(trainer, "diffusion_loss", wrap_loss)]
    return lambda: [u() for u in undo]


def unchanged_state():
    from pmhc_tpu_torch.diffusion import sampler
    from pmhc_tpu_torch.train import trainer

    undo = [_patch(trainer.Adam, "apply_", lambda apply_: lambda self, grads, update: None),
            _patch(sampler, "remove_noise_scalars", lambda step: lambda noised, *a: noised)]
    return lambda: [u() for u in undo]


def no_exchange():
    from pmhc_tpu_torch.train import trainer

    return _patch(trainer, "_reduce", lambda reduce: lambda grads, sums, mesh, cp: (grads, sums))


FAULTS = {f.__name__: f for f in (altered_answer, half_batch, unchanged_state, no_exchange)}


@contextlib.contextmanager
def planted(name):
    undo = FAULTS[name]() if name else None
    try:
        yield
    finally:
        if undo:
            undo()
