"""Rank bodies of the port's mesh tests (``tests/test_torch_parallel.py``,
``tests/test_torch_context_parallel.py``).

Each function runs in a process that ``parallel.distributed.spawn``
started, inside a gloo group on the CPU. This module imports the port
only (no JAX), so a rank starts quickly; arguments and results are numpy
arrays and plain Python values.
"""

import numpy as np
import torch
import torch.distributed as dist

from pmhc_tpu_torch.data.synthetic import prepare_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models import ScoreNetwork, ScoreNetworkConfig
from pmhc_tpu_torch.parallel import make_mesh
from pmhc_tpu_torch.parallel.mesh import data_rows, take_rows


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def model_from(state) -> ScoreNetwork:
    model = ScoreNetwork()
    model.load_state_dict({k: _t(v) for k, v in state.items()}, strict=True)
    return model


def mesh_shapes(combos):
    """``make_mesh(n_model=, n_context=)`` for each pair: (shape, this rank's coordinate)."""
    out = []
    for n_model, n_context in combos:
        mesh = make_mesh(n_model=n_model, n_context=n_context)
        out.append((tuple(mesh.shape), mesh.get_coordinate()))
    return out


def group_basics(state):
    """Two ranks: the group, ``loader_shard_args``, the tensor-parallel
    parts and their gather, and the errors a mesh raises."""
    from pmhc_tpu_torch.data.loader import PrefetchLoader
    from pmhc_tpu_torch.parallel import loader_shard_args
    from pmhc_tpu_torch.parallel.mesh import tp_gather, tp_shard_
    from pmhc_tpu_torch.train import Trainer

    out = {"backend": dist.get_backend(), "rank": dist.get_rank(),
           "world": dist.get_world_size(), "loader": loader_shard_args(),
           "order": PrefetchLoader(list(range(10)), batch_size=2,
                                   **loader_shard_args())._epoch_indices()}
    mesh = make_mesh(n_model=2)
    model = model_from(state)
    tp_shard_(model, mesh)
    names = [n for n, _ in model.named_parameters()]
    out["parts"] = {n: p.detach().numpy() for n, p in model.named_parameters()}
    out["whole"] = {n: t.numpy() for n, t in
                    zip(names, tp_gather(names, list(model.parameters()), mesh))}
    errors = {}
    for key, fn in (
            ("too_big", lambda: make_mesh(n_data=3)),
            ("cp_backend", lambda: Trainer(ScoreNetworkConfig(backend="xla"), device="cpu",
                                           mesh=make_mesh(n_context=2), context_parallel=True)),
            ("dp_tp_cp", lambda: Trainer(ScoreNetworkConfig(backend="cp"), device="cpu",
                                         mesh=make_mesh(n_model=2), tensor_parallel=True,
                                         context_parallel=True))):
        try:
            fn()
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    return out


def trainer_runs(configs, batches):
    """For each config (mesh shape, backend, tensor / context parallel,
    clip, per-sample t): a ``Trainer`` from seed 3 takes a step on each
    global batch; returns its losses and each whole tensor's change."""
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    out = []
    for shape, backend, tp, cp, clip, per_sample in configs:
        tr = Trainer(ScoreNetworkConfig(backend=backend), DiffusionConfig(t_per_batch=not per_sample),
                     TrainConfig(seed=3, grad_clip_norm=clip), device="cpu",
                     mesh=make_mesh(*shape), tensor_parallel=tp, context_parallel=cp)
        start = {k: v.clone() for k, v in tr.state_dict().items()}
        losses = [float(tr.train_batch(b)["total loss"]) for b in batches]
        out.append((losses, {k: (v - start[k]).numpy() for k, v in tr.state_dict().items()}))
    return out


def dp_first_step(state, batch, t, eps):
    """``train_step`` on a data-2 mesh with the given global batch, t and
    noise (numpy): the global loss sums."""
    from pmhc_tpu_torch.train import Adam, train_step

    mesh = make_mesh(2)
    model = model_from(state)
    B = len(batch["mask"])
    rows = data_rows(mesh, B)
    noise = {"frames": RigidArray(_t(eps[0][rows]), _t(eps[1][rows])), "torsions": _t(eps[2][rows])}
    sums = train_step(model, Adam(list(model.parameters()), 1e-3),
                      prepare_batch(take_rows(batch, rows), "cpu"), int(t), noise,
                      model_config=ScoreNetworkConfig(backend="auto"), mesh=mesh, global_batch=B)
    return {k: float(v) for k, v in sums.items()}


def cp_layer(shape, state, args, cot):
    """``egnn_layer_cp`` (layer 1 of the model ``state``, ``ring`` False and
    True) on a mesh of ``shape``, its neighbours split over ``context``:
    this rank's rows of the outputs, and the weight gradients of
    ``sum(outputs * cot)`` over its rows."""
    from pmhc_tpu_torch.models.score import relpos_edge_pre
    from pmhc_tpu_torch.parallel import egnn_layer_cp

    mesh = make_mesh(*shape)
    layer = model_from(state).gnn1
    q, t, tors, h, mask, ph, pq, pt, pmask = args
    rows = data_rows(mesh, len(mask))
    r = lambda x: _t(x[rows])  # noqa: E731
    out = {"rows": (rows.start, rows.stop), "coord": mesh.get_coordinate()}
    for ring in (False, True):
        edge = relpos_edge_pre(layer, mask.shape[1])
        f, o_tors, o_h = egnn_layer_cp(layer, RigidArray(r(q), r(t)), r(tors), r(h), edge, r(mask),
                                       r(ph), RigidArray(r(pq), r(pt)), r(pmask),
                                       group=mesh.get_group("context"), ring=ring)
        outs = (f.quats, f.trans, o_tors, o_h)
        loss = sum(torch.sum(o * r(c)) for o, c in zip(outs, cot))
        grads = torch.autograd.grad(loss, list(layer.parameters()))
        out[ring] = {"outs": [o.detach().numpy() for o in outs],
                     "grads": {n: g.numpy() for (n, _), g in zip(layer.named_parameters(), grads)}}
    return out


def cp_divisibility(state, cases):
    """The error ``egnn_layer_cp`` raises for each case (peptide nodes,
    pocket nodes, ring) split over the whole group, or None."""
    from pmhc_tpu_torch.models.score import relpos_edge_pre
    from pmhc_tpu_torch.parallel import egnn_layer_cp

    mesh = make_mesh(n_context=dist.get_world_size())
    layer = model_from(state).gnn1
    out = []
    for n_pep, n_pocket, ring in cases:
        frames = RigidArray(torch.zeros(1, n_pep, 4), torch.zeros(1, n_pep, 3))
        pocket = RigidArray(torch.zeros(1, n_pocket, 4), torch.zeros(1, n_pocket, 3))
        try:
            egnn_layer_cp(layer, frames, torch.zeros(1, n_pep, 7, 2), torch.zeros(1, n_pep, 23),
                          relpos_edge_pre(layer, n_pep), torch.ones(1, n_pep),
                          torch.zeros(1, n_pocket, 23), pocket, torch.ones(1, n_pocket),
                          group=mesh.get_group("context"), ring=ring)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def sharded_sample(shape, backend, state, batch, init, noise, T):
    """``sample_sharded`` with injected noise from ``init`` (q, t, tors)."""
    from pmhc_tpu_torch.diffusion.sampler import sample_sharded

    mesh = make_mesh(*shape)
    tb = prepare_batch(batch, "cpu")
    tb["frames"], tb["torsions"] = RigidArray(_t(init[0]), _t(init[1])), _t(init[2])
    inj = {"frames": RigidArray(_t(noise[0]), _t(noise[1])), "torsions": _t(noise[2])}
    out = sample_sharded(model_from(state), tb, DiffusionConfig(noise_step_count=T),
                         ScoreNetworkConfig(noise_step_count=T, backend=backend), mesh,
                         injected_noise=inj)
    return out["frames"].quats.numpy(), out["frames"].trans.numpy(), out["torsions"].numpy()
