"""The fused sampler chain's step outside the layer kernels
(``ops/sampler_step.py``) on the CPU, where the wrappers take the plain
versions: each against the composition the kernels replace (the
concatenated neighbour inputs, relu and ``_project``; ``gen_noise``'s
transforms of the same raw draws, ``remove_noise_scalars`` and the next
step's time inputs), bit for bit in every mode; and a fused chain stepped
by ``FusedForward.kernel_step`` against ``Chain.step``'s plain composition
from the same generator, bit for bit over T = 12 and a strided K = 5.
The kernels themselves: ``test_torch_kernel_emulation.py`` (the CUDA
source under g++) and ``test_torch_gpu.py`` (the card)."""

import math

import pytest
import torch

from chip_smoke import copy_args, random_model, sampler_step_case
from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, gen_noise, remove_noise_scalars
from pmhc_tpu_torch.diffusion.sampler import Chain, _noise, fused_forward, model_time
from pmhc_tpu_torch.diffusion.schedule import step_tables
from pmhc_tpu_torch.geometry import RigidArray, angle_to_sin_cos, shoemake_quat
from pmhc_tpu_torch.models import ScoreNetworkConfig
from pmhc_tpu_torch.ops import egnn_fused as ef
from pmhc_tpu_torch.ops import sampler_step as ss

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_inter_layer_is_the_composition_it_replaces(mode):
    case = sampler_step_case(random_model(seed=0), seed=3, device=CPU, batch_size=3,
                             bf16=ef.FLAGS[mode])
    inner, q1, t1, wj_t, h2, aj, qj, tj = copy_args(case["inter"])
    N = inner.shape[1]
    want_h2 = torch.relu(inner)
    want_aj = torch.cat((ef._project(want_h2, wj_t, case["bf16"]), aj[:, N:]), dim=1)
    want_qj, want_tj = torch.cat((q1, qj[:, N:]), dim=1), torch.cat((t1, tj[:, N:]), dim=1)
    ss.LAUNCHES.update(fp32=0, bf16=0, high=0)
    ss.inter_layer(inner, q1, t1, wj_t, h2, aj, qj, tj, bf16=case["bf16"])
    for got, want in ((h2, want_h2), (aj, want_aj), (qj, want_qj), (tj, want_tj)):
        assert torch.equal(got, want)
    assert not any(ss.LAUNCHES.values())


@pytest.mark.parametrize("mode,k", [("fp32", 0), ("bf16", 500), ("high", 998), ("fp32", 999)])
def test_step_is_the_composition_it_replaces(mode, k):
    """At the chain's first steps, a middle one and its last (k = 999 of
    T = 1000: the next step's time inputs left as they were)."""
    case = sampler_step_case(random_model(seed=0), seed=5, device=CPU, batch_size=3,
                             bf16=ef.FLAGS[mode], k=k)
    (kk, xs, sched, q, t, tors, q_p, t_p, tors_p, draws, h1, aj_static, wj_time, aj, qj, tj,
     ticket) = copy_args(case["step"])
    N = q.shape[1]
    noise = {"frames": RigidArray(shoemake_quat(draws.shoemake), draws.normal * draws.scale),
             "torsions": angle_to_sin_cos(draws.angles * (2.0 * math.pi))}
    want = remove_noise_scalars({"frames": RigidArray(q, t), "torsions": tors},
                                {"frames": RigidArray(q_p, t_p), "torsions": tors_p}, noise,
                                *sched[k].unbind())
    want_h1, want_aj = h1.clone(), aj.clone()
    if k + 1 < xs.shape[0]:
        x = xs[k + 1:k + 2]
        want_h1 = torch.cat((h1[..., :-1], x.expand(*h1.shape[:2], 1)), dim=-1)
        want_aj = torch.cat((aj_static + x * wj_time, aj[:, N:]), dim=1)
    want_qj = torch.cat((want["frames"].quats, qj[:, N:]), dim=1)
    want_tj = torch.cat((want["frames"].trans, tj[:, N:]), dim=1)
    ss.step(kk, xs, sched, q, t, tors, q_p, t_p, tors_p, draws, h1, aj_static, wj_time, aj, qj,
            tj, ticket, bf16=case["bf16"])
    assert int(kk) == k + 1 and int(ticket) == 0
    for got, w in ((q, want["frames"].quats), (t, want["frames"].trans), (tors, want["torsions"]),
                   (h1, want_h1), (aj, want_aj), (qj, want_qj), (tj, want_tj)):
        assert torch.equal(got, w)


def test_draws_are_gen_noise_s():
    """``FusedForward.draw`` into its buffers gives ``gen_noise``'s numbers
    from the same generator state, and leaves the generator where
    ``gen_noise`` leaves it."""
    cfg = DiffusionConfig()
    fwd = fused_forward(random_model(seed=0), _batch(2), ScoreNetworkConfig(), False)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    draws = fwd.draw(g1, cfg)
    assert all(d is b for d, b in zip(draws, fwd.draws))
    want = gen_noise(g2, (2, 16), cfg)
    got = ss.noise_of(draws)
    assert torch.equal(got["frames"].quats, want["frames"].quats)
    assert torch.equal(got["frames"].trans, want["frames"].trans)
    assert torch.equal(got["torsions"], want["torsions"])
    assert torch.equal(g1.get_state(), g2.get_state())


def _batch(B: int, seed: int = 2, pocket: int = 24):
    nb = synthetic_batch(batch_size=B, seed=seed)
    nb["mask"][1, 4:] = False
    for key in ("pocket_frames", "pocket_mask", "pocket_features"):
        nb[key] = nb[key][:, :pocket]
    mb = prepare_batch(nb, CPU)
    start = gen_noise(torch.Generator().manual_seed(seed), (B, 16), DiffusionConfig())
    mb["frames"], mb["torsions"] = start["frames"], start["torsions"]
    return mb


@pytest.mark.parametrize("num_steps,bf16", [(None, False), (5, False), (None, True),
                                            (5, "high")])
def test_kernel_step_chain_matches_chain_step(num_steps, bf16):
    """A T = 12 chain (or its strided K = 5) stepped by the kernels' body
    (``start``, then ``Chain.step`` with each step's ``Draws``) against the
    plain composition's (``Chain.step`` with ``gen_noise``'s noise) from
    one generator seed: the same states after every step, and the
    generators in the same place."""
    cfg = DiffusionConfig(noise_step_count=12)
    mc = ScoreNetworkConfig(noise_step_count=12)
    model = random_model(seed=1)
    ts, sched = step_tables(cfg, num_steps)
    xs = model_time("fused", ts, 12)
    mb = _batch(3)
    chains, gens = {}, {}
    for kernels in (True, False):
        fwd = fused_forward(model, mb, mc, bf16)
        chain = Chain(mb, xs, sched)
        g = gens[kernels] = torch.Generator().manual_seed(77)
        if kernels:
            fwd.start(chain)
        chains[kernels] = states = []
        for _ in range(len(ts)):
            chain.step(fwd, fwd.draw(g, cfg) if kernels else _noise(g, (3, 16), cfg, None))
            states.append((chain.q.clone(), chain.t.clone(), chain.tors.clone()))
        assert int(chain.k) == len(ts)
    for got, want in zip(chains[True], chains[False]):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(gens[True].get_state(), gens[False].get_state())
    assert not any(ss.LAUNCHES.values())


def test_wrappers_check_their_inputs():
    case = sampler_step_case(random_model(seed=0), seed=3, device=CPU, batch_size=2, pocket=8)
    inner, q1, t1, wj_t, h2, aj, qj, tj = case["inter"]
    with pytest.raises(ValueError, match="shape"):
        ss.inter_layer(inner, q1, t1, wj_t, h2[:, :, :-1], aj, qj, tj)
    with pytest.raises(TypeError):
        ss.inter_layer(inner.double(), q1, t1, wj_t, h2, aj, qj, tj)
    with pytest.raises(ValueError, match="contiguous"):
        ss.inter_layer(inner.transpose(0, 1).contiguous().transpose(0, 1), q1, t1, wj_t, h2,
                       aj, qj, tj)
    step = list(case["step"])
    bad = {0: step[0].int(), 16: step[16].long(), 3: step[3][:, :8].contiguous(),
           9: step[9]._replace(angles=step[9].angles[..., :3].contiguous())}
    for i, x in bad.items():
        args = list(step)
        args[i] = x
        with pytest.raises((ValueError, TypeError)):
            ss.step(*args)
