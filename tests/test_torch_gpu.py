"""The port's CUDA kernels on the card: the fused EGNN layer, the
training neighbour loop (forward and backward) and the round-1 fused
layer (``pallas`` backend) against their plain PyTorch versions, and the
sampler's and the trainer's routes through them.

Each test skips without a card. This file imports neither JAX nor the JAX
package, so it runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) Inputs and
tolerances are those of ``chip_smoke.py`` phase 3. Fused layer: fp32
quats and torsions 5e-5, translations and features 2e-4 (sum order
only); bf16 one bf16 ulp of slack on top: quats and torsions 2e-3,
translations 2e-2, features 1e-2. Loop kernels, as a share of each
tensor's largest magnitude: fp32 forward 2e-5, gradients 2e-4; bf16
forward 2e-3, gradients 3e-2 (``LOOP_TOL``). Round-1 fused layer: the
fused layer's fp32 tolerances (``PALLAS_TOL``); its sampler against the
dense one: ``TRAJ_TOL``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    LOOP_TOL,
    PALLAS_TOL,
    TOL,
    layer_case,
    loop_case,
    loop_errors,
    loop_forward_errors,
    loop_named,
    loop_ragged,
    loop_run,
    loop_two_tiles,
    pallas_case,
    pallas_ragged,
    ragged_case,
    random_model,
    trajectory_check,
)
from pmhc_tpu_torch.data.synthetic import synthetic_batch
from pmhc_tpu_torch.ops import egnn_fused as ef
from pmhc_tpu_torch.ops import egnn_loop as el
from pmhc_tpu_torch.ops import egnn_pallas as ep
from pmhc_tpu_torch.serve import SamplerService, dummy_entry
from pmhc_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("batch_size", [5, 64])
def test_cuda_kernel_matches_plain(mode, batch_size):
    dev = _card()
    model = random_model(seed=0).to(dev)
    for seed, layer in enumerate(("gnn1", "gnn2")):
        args = layer_case(model, layer, seed=seed + 1, device=dev, batch_size=batch_size)
        got = ef.egnn_fused(*args, bf16=mode == "bf16")
        want = ef.egnn_fused_plain(*args, bf16=mode == "bf16")
        torch.cuda.synchronize()
        for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=TOL[mode][name],
                                       err_msg=f"{layer} {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_cuda_kernel_ragged_tile_matches_plain(mode):
    """NP = 90, the neighbours cut along their axis: the kernel's last mma
    row tile is partly zero padding, masked out of the fold."""
    dev = _card()
    args = ragged_case(layer_case(random_model(seed=0).to(dev), "gnn2", seed=2, device=dev))
    got = ef.egnn_fused(*args, bf16=mode == "bf16")
    want = ef.egnn_fused_plain(*args, bf16=mode == "bf16")
    torch.cuda.synchronize()
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=TOL[mode][name], err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_service_launches_the_kernel_twice_per_step(bf16):
    dev = _card()
    svc = SamplerService(random_model(seed=0), batch_size=4, noise_step_count=5, bf16=bf16)
    assert svc.device.type == dev.type
    ef.reset_launches()
    conv, n = svc.dispatch([dummy_entry(seed=i) for i in range(3)],
                           torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert ef.LAUNCHES == {"fp32": 0 if bf16 else 10, "bf16": 10 if bf16 else 0}
    q = conv["quats"][:n]
    assert torch.isfinite(q).all()
    torch.testing.assert_close(q.norm(dim=-1), torch.ones(q.shape[:-1], device=dev),
                               atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_cuda_kernel_takes_unaligned_inputs(mode):
    """Every input but the packed weights a view that starts 4 bytes into
    its storage: a_j, q_j and edge go by the kernel's 4-byte copies."""
    dev = _card()
    args = layer_case(random_model(seed=0).to(dev), "gnn1", seed=3, device=dev, batch_size=5)
    offset = [torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x) for x in args[1:]]
    assert all(x.data_ptr() % 16 for x in offset)
    got = ef.egnn_fused(args[0], *offset, bf16=mode == "bf16")
    want = ef.egnn_fused_plain(*args, bf16=mode == "bf16")
    torch.cuda.synchronize()
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=TOL[mode][name], err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("batch_size,n_neighbours", [(3, None), (64, None), (64, 90)])
def test_loop_kernels_match_plain(mode, batch_size, n_neighbours):
    """Forward outputs and every gradient of the loop kernels against the
    plain version and its autograd, both layer shapes; ``n_neighbours`` =
    90 (``loop_ragged``): the backward's second tile is partly padding."""
    dev = _card()
    model = random_model(seed=0).to(dev)
    for seed, layer in enumerate(("gnn1", "gnn2")):
        args, cts = loop_case(model, layer, seed=seed + 1, device=dev, batch_size=batch_size)
        if n_neighbours is not None:
            args = loop_ragged(args, n_neighbours)
        got = loop_run(args, cts, mode == "bf16", kernel=True)
        want = loop_run(args, cts, mode == "bf16", kernel=False)
        torch.cuda.synchronize()
        bad = {n: r for n, r in loop_errors(got, want, LOOP_TOL[mode]).items() if not r[3]}
        assert not bad, f"{layer}: {bad}"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_loop_forward_two_tiles_matches_plain(mode):
    """The loop forward at NP = 136 (``loop_two_tiles``: two 96-neighbour
    tiles per query row, the second ragged, merged online), batch 64,
    against the plain version. Forward only: the backward takes NP <= 96."""
    dev = _card()
    args, _ = loop_case(random_model(seed=0).to(dev), "gnn2", seed=2, device=dev)
    args = loop_two_tiles(args)
    bad = {n: r for n, r in loop_forward_errors(args, mode == "bf16", LOOP_TOL[mode]).items()
           if not r[3]}
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_loop_kernels_take_unaligned_inputs(mode):
    """Every input of both loop kernels a view that starts 4 bytes into its
    storage (a misaligned 16-byte ``cp.async`` faults): the kernels' 4-byte
    paths, against the plain version on the aligned inputs."""
    dev = _card()
    args, cts = loop_case(random_model(seed=0).to(dev), "gnn1", seed=3, device=dev, batch_size=5)
    off = lambda x: torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
    o_args = tuple(off(x) for x in args)
    assert all(x.data_ptr() % 16 for x in o_args)
    bf16 = mode == "bf16"
    lib = el._lib()
    outs = el.launch_fwd(lib, *o_args, bf16=bf16)
    got = loop_named(outs, el.launch_bwd(lib, *o_args, off(outs[0]), [off(c) for c in cts], bf16=bf16))
    want = loop_run(args, cts, bf16, kernel=False)
    torch.cuda.synchronize()
    bad = {n: r for n, r in loop_errors(got, want, LOOP_TOL[mode]).items() if not r[3]}
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_trainer_launches_two_loop_kernels_each_way_per_step(bf16):
    dev = _card()
    tr = Trainer(train_config=TrainConfig(seed=1), bf16=bf16)
    assert tr.device.type == dev.type
    el.reset_launches()
    for k in range(2):
        sums = tr.train_batch(synthetic_batch(batch_size=4, seed=k))
    torch.cuda.synchronize()
    mode = "bf16" if bf16 else "fp32"
    assert el.LAUNCHES == {k: (4 if k.endswith(mode) else 0) for k in el.LAUNCHES}
    assert all(torch.isfinite(v) for v in sums.values())


@pytest.mark.gpu
@pytest.mark.parametrize("batch_size", [5, 64])
def test_pallas_kernel_matches_plain(batch_size):
    """Kernel #3 at both layer shapes, on batches with fully masked rows,
    through the main path's entry (the layer's ``PallasContext``)."""
    dev = _card()
    model = random_model(seed=0).to(dev)
    for seed, layer in enumerate(("gnn1", "gnn2")):
        ctx, step = pallas_case(model, layer, seed=seed + 1, device=dev, batch_size=batch_size)
        assert int((ctx.msg_mask.sum(-1) == 0).sum()) > 0
        got = ctx(*step)
        want = ep.egnn_pallas_plain(*ctx.inputs(*step))
        torch.cuda.synchronize()
        for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=PALLAS_TOL[name],
                                       err_msg=f"{layer} {name}")


@pytest.mark.gpu
def test_pallas_kernel_ragged_matches_plain():
    """Kernel #3 with its neighbours cut to NP = 90 at batch 64
    (``pallas_ragged``): a partial last 32-neighbour block."""
    dev = _card()
    ctx, step = pallas_case(random_model(seed=0).to(dev), "gnn2", seed=2, device=dev)
    ctx = pallas_ragged(ctx)
    got = ctx(*step)
    want = ep.egnn_pallas_plain(*ctx.inputs(*step))
    torch.cuda.synchronize()
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=PALLAS_TOL[name], err_msg=name)


@pytest.mark.gpu
def test_pallas_sampler_matches_dense_sampler():
    """A 4-step trajectory through kernel #3 (2 launches per step) against
    the dense oracle with the same injected noise (``TRAJ_TOL``)."""
    trajectory_check(random_model(seed=1).to(_card()), torch.device("cuda"), "pallas")
