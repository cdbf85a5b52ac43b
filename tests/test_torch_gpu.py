"""The port's CUDA kernels on the card: the fused EGNN layer, the
training neighbour loop (forward and backward) and the round-1 fused
layer (``pallas`` backend) against their plain PyTorch versions, and the
sampler's and the trainer's routes through them.

The chain and the train step from CUDA graphs (``utils/graphs.py``)
against the same bodies run eagerly: the sampler's trajectories within
``TRAJ_TOL`` (the graphs replay the eager step's kernels, so they are
expected to agree exactly; chip_smoke.py reports whether they do); the
trainer's losses within rtol 1e-4 and the change of its parameters and
EMA from their start within 2e-2 of the eager change, over all tensors
and for the median one (``chip_smoke.py``'s ``GRAPH_TRAIN_TOL``: the loop
backward sums with atomics, in an order that changes from run to run). A
replayed generator draws what an eager one of the same state draws,
exactly.

Each test skips without a card. This file imports neither JAX nor the JAX
package, so it runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) Inputs and
tolerances are those of ``chip_smoke.py`` phase 3. Fused layer: fp32
quats and torsions 5e-5, translations and features 2e-4 (sum order
only); bf16 one bf16 ulp of slack on top: quats and torsions 2e-3,
translations 2e-2, features 1e-2. Loop kernels, as a share of each
tensor's largest magnitude: fp32 forward 2e-5, gradients 2e-4; bf16
forward 2e-3, gradients 3e-2 (``LOOP_TOL``). The high (``--fast-f32``)
modes of both: the fp32 tolerances (the kernel and the plain version
split the same operands into the same bf16 halves), the loop forward 5e-5
(the tensor cores' own summation order, amplified by the softmax's exp).
Round-1 fused layer: the
fused layer's fp32 tolerances (``PALLAS_TOL``); its sampler against the
dense one: ``TRAJ_TOL``. The sampler step's two kernels against their
plain versions: ``SAMPLER_STEP_TOL``; the fused chain they step against
the plain composition's (the body before them): ``TRAJ_TOL``, a T = 12
chain end to end and a T = 1000 chain per 10-step segment from the same
state (whole float32 chains drift apart on summation order alone).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    GRAPH_TRAIN_TOL,
    LOOP_TOL,
    PALLAS_TOL,
    SAMPLER_STEP_TOL,
    TOL,
    TRAJ_TOL,
    change_close,
    change_errors,
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
    request_entry,
    sampler_step_case,
    sampler_step_errors,
    trainer_state,
    trajectory_check,
)
from pmhc_tpu_torch.data.realistic import realistic_packed
from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, gen_noise, sample
from pmhc_tpu_torch.diffusion import sampler
from pmhc_tpu_torch.diffusion.schedule import step_tables
from pmhc_tpu_torch.models import ScoreNetworkConfig
from pmhc_tpu_torch.ops import egnn_fused as ef
from pmhc_tpu_torch.ops import egnn_loop as el
from pmhc_tpu_torch.ops import egnn_pallas as ep
from pmhc_tpu_torch.ops import sampler_step as ss
from pmhc_tpu_torch.serve import SamplerService, dummy_entry
from pmhc_tpu_torch.train import TrainConfig, Trainer
from pmhc_tpu_torch.utils.graphs import GraphCache, Step

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
@pytest.mark.parametrize("batch_size", [5, 64])
def test_cuda_kernel_matches_plain(mode, batch_size):
    dev = _card()
    model = random_model(seed=0).to(dev)
    for seed, layer in enumerate(("gnn1", "gnn2")):
        args = layer_case(model, layer, seed=seed + 1, device=dev, batch_size=batch_size)
        got = ef.egnn_fused(*args, bf16=ef.FLAGS[mode])
        want = ef.egnn_fused_plain(*args, bf16=ef.FLAGS[mode])
        torch.cuda.synchronize()
        for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=TOL[mode][name],
                                       err_msg=f"{layer} {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_cuda_kernel_ragged_tile_matches_plain(mode):
    """NP = 90, the neighbours cut along their axis: the kernel's last mma
    row tile is partly zero padding, masked out of the fold."""
    dev = _card()
    args = ragged_case(layer_case(random_model(seed=0).to(dev), "gnn2", seed=2, device=dev))
    got = ef.egnn_fused(*args, bf16=ef.FLAGS[mode])
    want = ef.egnn_fused_plain(*args, bf16=ef.FLAGS[mode])
    torch.cuda.synchronize()
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=TOL[mode][name], err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True, "high"])
def test_service_launches_the_kernel_twice_per_step(bf16):
    """``bf16`` "high": ``fast_f32=True``."""
    dev = _card()
    svc = SamplerService(random_model(seed=0), batch_size=4, noise_step_count=5, bf16=bf16 is True,
                         fast_f32=bf16 == "high")
    assert svc.device.type == dev.type
    ef.reset_launches()
    ss.reset_launches()
    handle = svc.dispatch([dummy_entry(seed=i) for i in range(3)],
                          torch.Generator(device=dev).manual_seed(0))
    handle.wait()
    assert ef.LAUNCHES == {m: 10 if m == ef.mode_of(bf16) else 0 for m in ef.LAUNCHES}
    assert ss.LAUNCHES == ef.LAUNCHES  # the sampler step's kernels, as often
    q = handle.conv["quats"][:handle.n]
    assert torch.isfinite(q).all()
    torch.testing.assert_close(q.norm(dim=-1), torch.ones(q.shape[:-1]), atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_cuda_kernel_takes_unaligned_inputs(mode):
    """Every input but the packed weights a view that starts 4 bytes into
    its storage: a_j, q_j and edge go by the kernel's 4-byte copies."""
    dev = _card()
    args = layer_case(random_model(seed=0).to(dev), "gnn1", seed=3, device=dev, batch_size=5)
    offset = [torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x) for x in args[1:]]
    assert all(x.data_ptr() % 16 for x in offset)
    got = ef.egnn_fused(args[0], *offset, bf16=ef.FLAGS[mode])
    want = ef.egnn_fused_plain(*args, bf16=ef.FLAGS[mode])
    torch.cuda.synchronize()
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=TOL[mode][name], err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
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
        got = loop_run(args, cts, ef.FLAGS[mode], kernel=True)
        want = loop_run(args, cts, ef.FLAGS[mode], kernel=False)
        torch.cuda.synchronize()
        bad = {n: r for n, r in loop_errors(got, want, LOOP_TOL[mode]).items() if not r[3]}
        assert not bad, f"{layer}: {bad}"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_loop_forward_two_tiles_matches_plain(mode):
    """The loop forward at NP = 136 (``loop_two_tiles``: two 96-neighbour
    tiles per query row, the second ragged, merged online), batch 64,
    against the plain version. Forward only: the backward takes NP <= 96."""
    dev = _card()
    args, _ = loop_case(random_model(seed=0).to(dev), "gnn2", seed=2, device=dev)
    args = loop_two_tiles(args)
    bad = {n: r for n, r in loop_forward_errors(args, ef.FLAGS[mode], LOOP_TOL[mode]).items()
           if not r[3]}
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_loop_kernels_take_unaligned_inputs(mode):
    """Every input of both loop kernels a view that starts 4 bytes into its
    storage (a misaligned 16-byte ``cp.async`` faults): the kernels' 4-byte
    paths, against the plain version on the aligned inputs."""
    dev = _card()
    args, cts = loop_case(random_model(seed=0).to(dev), "gnn1", seed=3, device=dev, batch_size=5)
    off = lambda x: torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
    o_args = tuple(off(x) for x in args)
    assert all(x.data_ptr() % 16 for x in o_args)
    bf16 = ef.FLAGS[mode]
    lib = el._lib()
    outs = el.launch_fwd(lib, *o_args, bf16=bf16)
    got = loop_named(outs, el.launch_bwd(lib, *o_args, off(outs[0]), [off(c) for c in cts], bf16=bf16))
    want = loop_run(args, cts, bf16, kernel=False)
    torch.cuda.synchronize()
    bad = {n: r for n, r in loop_errors(got, want, LOOP_TOL[mode]).items() if not r[3]}
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True, "high"])
def test_trainer_launches_two_loop_kernels_each_way_per_step(bf16):
    """``bf16`` "high": ``fast_f32=True``."""
    dev = _card()
    tr = Trainer(train_config=TrainConfig(seed=1), bf16=bf16 is True, fast_f32=bf16 == "high")
    assert tr.device.type == dev.type
    el.reset_launches()
    for k in range(2):
        sums = tr.train_batch(synthetic_batch(batch_size=4, seed=k))
    torch.cuda.synchronize()
    mode = ef.mode_of(bf16)
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


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        for k, v in w.items():
            if k != "name":
                assert g[k].device.type == "cuda"
                np.testing.assert_array_equal(g[k].cpu().numpy(), np.asarray(v), err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("on_device", [False, True])
def test_train_cli_loader_on_card_matches_cpu_loader(on_device):
    """The loader as the train CLI builds it (shuffled, seeded, two epochs)
    on the card, over the packed arrays (pinned copies) or the arrays
    resident there (``--device-data``), gives the CPU loader's batches."""
    from pmhc_tpu_torch.data import DeviceDataset, PrefetchLoader

    dev = _card()
    packed = realistic_packed(37)
    data = DeviceDataset(packed, dev) if on_device else packed
    kw = dict(batch_size=8, shuffle=True, seed=3)
    on_card, on_cpu = PrefetchLoader(data, device=dev, **kw), PrefetchLoader(packed, **kw)
    for _ in range(2):
        got = list(on_card)
        torch.cuda.synchronize()
        _assert_batches_equal(got, list(on_cpu))


@pytest.mark.gpu
def test_pinned_non_blocking_loader_matches_synchronous_copies():
    """20 batches copied from fresh pinned buffers with ``non_blocking``
    while the card is kept busy, held to synchronous copies of the same
    batches: no buffer is reused before its copy has landed."""
    from pmhc_tpu_torch.data import PrefetchLoader

    dev = _card()
    packed = realistic_packed(80, seed=1)
    kw = dict(batch_size=4, shuffle=True, seed=9, prefetch=4)
    busy = torch.randn(2048, 2048, device=dev)
    got = []
    for batch in PrefetchLoader(packed, device=dev, **kw):
        for _ in range(4):
            busy = torch.tanh(busy @ busy)  # the copies queue behind this work
        got.append({k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in batch.items()})
    torch.cuda.synchronize()
    want = list(PrefetchLoader(packed, **kw))
    assert len(got) == 20
    _assert_batches_equal(got, want)


def _noised_batch(dev, B: int, seed: int):
    """A synthetic model batch on the card (row 1 a 4-residue peptide), its
    peptide state replaced by noise drawn from ``seed``."""
    nb = synthetic_batch(batch_size=B, seed=seed)
    nb["mask"][1, 4:] = False
    mb = prepare_batch(nb, dev)
    start = gen_noise(torch.Generator(device=dev).manual_seed(seed), (B, 16), DiffusionConfig())
    mb["frames"], mb["torsions"] = start["frames"], start["torsions"]
    return mb


@pytest.mark.gpu
@pytest.mark.parametrize("backend,bf16", [("fused", False), ("fused", True), ("pallas", False),
                                          ("dense", False), ("fused", "high")])
def test_graphed_sampler_matches_eager(backend, bf16, monkeypatch):
    """The chain from CUDA graphs against the eager chain with the same
    generator seed: T = 12 (twice: the second batch goes through the cached
    graph, its context copied in), strided K = 5, and 4 steps per graph
    (``sampler.STEPS_PER_GRAPH``: three 4-step replays, and 1-step graphs
    for the rest); the kernel launched twice a step either way, the
    caller's generator left where the eager chain leaves it."""
    dev = _card()
    model = random_model(seed=2).to(dev)
    cfg = DiffusionConfig(noise_step_count=12)
    mc = ScoreNetworkConfig(noise_step_count=12, backend=backend)
    counter = {"fused": ef.LAUNCHES, "pallas": ep.LAUNCHES, "dense": None}[backend]
    mode = ef.mode_of(bf16)
    cache = GraphCache()
    for seed, K, S in ((1, None, 1), (2, None, 1), (3, 5, 1), (4, None, 4)):
        mb = _noised_batch(dev, 6, seed)
        steps = len(step_tables(cfg, K)[0])
        runs, states = {}, {}
        for graphs in (True, False):
            gen = torch.Generator(device=dev).manual_seed(100 + seed)
            ef.reset_launches()
            ep.reset_launches()
            ss.reset_launches()
            monkeypatch.setattr(sampler, "STEPS_PER_GRAPH", S)
            runs[graphs] = sample(model, mb, cfg, mc, generator=gen, bf16=bf16, num_steps=K,
                                  graphs=graphs, graph_cache=cache)
            torch.cuda.synchronize()
            states[graphs] = gen.get_state()
            if counter is not None:
                assert counter[mode] == 2 * steps, (graphs, dict(counter))
            # the sampler step's kernels: on the fused chain only, 2 a step
            want = {m: 2 * steps if backend == "fused" and m == mode else 0 for m in ss.LAUNCHES}
            assert ss.LAUNCHES == want, (graphs, dict(ss.LAUNCHES))
        assert torch.equal(states[True], states[False])
        for name, get in (("q", lambda r: r["frames"].quats), ("t", lambda r: r["frames"].trans),
                          ("tors", lambda r: r["torsions"])):
            err = float((get(runs[True]) - get(runs[False])).abs().max())
            assert err <= TRAJ_TOL[name], (seed, name, err)
    assert len(cache) == 2  # T = 12 (1 and 4 steps a graph) and K = 5


@pytest.mark.gpu
@pytest.mark.parametrize("mode,k", [("fp32", 0), ("bf16", 500), ("high", 500), ("fp32", 999)])
def test_sampler_step_kernels_match_plain(mode, k):
    """Both kernels of ``csrc/sampler_step.cu`` at batch 64 (the main
    path's shapes) against their plain versions, at the chain's first step,
    a middle one and its last (the next step's inputs left as they were);
    each counted once under the chain's mode."""
    dev = _card()
    case = sampler_step_case(random_model(seed=0).to(dev), seed=11, device=dev,
                             bf16=ef.FLAGS[mode], k=k)
    ss.reset_launches()
    errs = sampler_step_errors(case, lambda *a: ss.inter_layer(*a, bf16=case["bf16"]),
                               lambda *a: ss.step(*a, bf16=case["bf16"]))
    for name, err in errs.items():
        assert err <= SAMPLER_STEP_TOL[name], (name, err)
    assert ss.LAUNCHES == {m: 2 if m == mode else 0 for m in ss.LAUNCHES}


# per 10-step segment of a T = 1000 chain: the two bodies differ by ulps
# each step (the projection's sum order, FMA contraction in the step
# kernel), which grow through acos where a normalised cosine or quaternion
# w lies near +-1 (a change of 2^-24 there moves the angle by up to
# 3.5e-4); measured up to 2.45e-4 in tors (high, H100), against TRAJ_TOL's
# 2e-4 for 4-step trajectories
SEGMENT_TOL = {name: 5 * tol for name, tol in TRAJ_TOL.items()}


def _plain_steps(model, mb, cfg, mc, bf16, chain, generator, n):
    """``n`` steps of the fused chain's plain composition (``Chain.step``
    with ``gen_noise``'s noise: the body before the sampler step kernels)."""
    fwd = sampler.fused_forward(model, mb, mc, bf16)
    for _ in range(n):
        chain.step(fwd, sampler._noise(generator, tuple(mb["mask"].shape), cfg, None))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, "high"])
def test_kernel_chain_matches_plain_composition(bf16):
    """A batch-64 T = 12 chain from graphs (four launches a step) against
    the plain composition from the same generator seed, end to end; then a
    T = 1000 chain stepped by the kernels eagerly against the plain
    composition per 10-step segment, both from the kernels' state and the
    same generator state at each segment's start (``SEGMENT_TOL``). fp32
    and high, whose
    projections are IEEE fp32: in bf16 mode the projection's other sum
    order (~1e-7) flips bf16 roundings inside #1 that a chain grows (0.025
    in q after 12 steps on the H100; the benchmark's bf16 control reads
    chain gaps of 0.25-1.7), so bf16 is held per kernel
    (``test_sampler_step_kernels_match_plain``)."""
    dev = _card()
    model = random_model(seed=2).to(dev)
    for T in (12, 1000):
        cfg = DiffusionConfig(noise_step_count=T)
        mc = ScoreNetworkConfig(noise_step_count=T)
        mb = _noised_batch(dev, 64, seed=T)
        ts, sched = step_tables(cfg)
        xs = sampler.model_time("fused", ts, T)
        plain = sampler.Chain(mb, xs, sched)
        if T == 12:
            got = sample(model, mb, cfg, mc, generator=torch.Generator(device=dev).manual_seed(5),
                         bf16=bf16)
            _plain_steps(model, mb, cfg, mc, bf16, plain,
                         torch.Generator(device=dev).manual_seed(5), T)
            pairs = [((got["frames"].quats, got["frames"].trans, got["torsions"]),
                      (plain.q, plain.t, plain.tors))]
        else:
            fwd = sampler.fused_forward(model, mb, mc, bf16)
            chain = sampler.Chain(mb, xs, sched)
            fwd.start(chain)
            g, g_plain = (torch.Generator(device=dev).manual_seed(6) for _ in range(2))
            pairs = []
            for _ in range(T // 10):
                g_plain.set_state(g.get_state())
                for x, y in zip((plain.q, plain.t, plain.tors), (chain.q, chain.t, chain.tors)):
                    x.copy_(y)
                for _ in range(10):
                    chain.step(fwd, fwd.draw(g, cfg))
                _plain_steps(model, mb, cfg, mc, bf16, plain, g_plain, 10)
                pairs.append(((chain.q.clone(), chain.t.clone(), chain.tors.clone()),
                              (plain.q.clone(), plain.t.clone(), plain.tors.clone())))
            assert int(chain.k) == int(plain.k) == T
        tol = TRAJ_TOL if T == 12 else SEGMENT_TOL
        for got_s, want_s in pairs:
            for name, x, y in zip(("q", "t", "tors"), got_s, want_s):
                err = float((x - y).abs().max())
                assert err <= tol[name], (T, name, err)


@pytest.mark.gpu
def test_graphed_service_matches_eager_service():
    """``SamplerService`` with graphs (its default on the card) and with
    ``graphs=False``, batch generators by number: the same PDB arrays; a
    short batch and a full one share the one capture."""
    _card()
    model = random_model(seed=0)
    svcs = {g: SamplerService(model, batch_size=4, noise_step_count=8, seed=3, graphs=g)
            for g in (None, False)}
    assert svcs[None].graphs and not svcs[False].graphs
    for counter, n in ((0, 3), (1, 4)):
        entries = [dummy_entry(seed=10 * counter + i) for i in range(n)]
        out = {g: svc.dispatch(entries, svc.batch_generator(counter)) for g, svc in svcs.items()}
        for h in out.values():
            h.wait()
        for k, tol in (("quats", TRAJ_TOL["q"]), ("trans", TRAJ_TOL["t"]), ("atom14", TRAJ_TOL["t"])):
            np.testing.assert_allclose(out[None].conv[k].numpy(), out[False].conv[k].numpy(),
                                       atol=tol, err_msg=k)
    assert len(svcs[None].graph_cache) == 1


def _assert_trainers_close(start, a: Trainer, b: Trainer, losses_a, losses_b):
    """``a`` against ``b``, both from the state ``start`` (``trainer_state``):
    losses, the change of parameters and EMA, and the counts."""
    for step, (x, y) in enumerate(zip(losses_a, losses_b)):
        assert abs(x - y) <= GRAPH_TRAIN_TOL["loss_rtol"] * abs(y), (step, x, y)
    err = change_errors(start, trainer_state(a), trainer_state(b))
    assert change_close(err), err
    assert a.optimizer.count == b.optimizer.count and a.global_step == b.global_step


@pytest.mark.gpu
@pytest.mark.parametrize("kw,per_sample_t,bf16", [
    ({}, False, False),
    ({}, False, True),
    ({"ema_decay": 0.99, "grad_clip_norm": 0.5, "lr_warmup_steps": 2, "lr_decay_steps": 6,
      "lr_final": 1e-4}, False, False),
    ({"grad_accum": 2, "ema_decay": 0.9}, True, False),
    ({}, False, "high"),
], ids=["adam", "adam_bf16", "ema_clip_schedule", "accum2_per_sample_t", "adam_fast_f32"])
def test_graphed_trainer_matches_eager(kw, per_sample_t, bf16):
    """``Trainer`` from CUDA graphs (its default on the card) against
    ``graphs=False`` from the same seed, on 5 batches of 8 and a partial
    batch of 5 (a second capture): losses, parameters, EMA and counts; 2
    forward and 2 backward loop launches a step either way."""
    dev = _card()
    trainers = {g: Trainer(ScoreNetworkConfig(backend="auto"),
                           DiffusionConfig(t_per_batch=not per_sample_t),
                           TrainConfig(seed=4, nan_check_every=3, **kw), bf16=bf16 is True,
                           fast_f32=bf16 == "high", graphs=g)
                for g in (None, False)}
    assert trainers[None].graphs and trainers[None].device == dev
    batches = [synthetic_batch(batch_size=8, seed=40 + k) for k in range(5)]
    batches.append(synthetic_batch(batch_size=5, seed=50))
    start = trainer_state(trainers[False])
    el.reset_launches()
    losses = {g: [float(tr.train_batch(b)["total loss"]) for b in batches]
              for g, tr in trainers.items()}
    mode = ef.mode_of(bf16)
    assert el.LAUNCHES == {k: (2 * 2 * len(batches) if k.endswith(mode) else 0) for k in el.LAUNCHES}
    _assert_trainers_close(start, trainers[None], trainers[False], losses[None], losses[False])


@pytest.mark.gpu
def test_train_indices_matches_train_batch_on_card():
    """``train_indices`` on a resident dataset (3 steps, each a replay that
    gathers its row) against 3 ``train_batch`` calls on the batches
    ``get_batch`` gathers."""
    from pmhc_tpu_torch.data import DeviceDataset

    dev = _card()
    data = DeviceDataset(realistic_packed(24, seed=3), dev)
    idx = np.random.default_rng(0).permutation(24).reshape(3, 8)
    a, b = (Trainer(train_config=TrainConfig(seed=6, ema_decay=0.9)) for _ in range(2))
    start = trainer_state(b)
    el.reset_launches()
    losses_a = [float(s["total loss"]) for s in a.train_indices(data, idx)]
    losses_b = [float(b.train_batch(data.get_batch(list(row)))["total loss"]) for row in idx]
    assert el.LAUNCHES["fwd_fp32"] == el.LAUNCHES["bwd_fp32"] == 2 * 2 * 3
    _assert_trainers_close(start, a, b, losses_a, losses_b)


@pytest.mark.gpu
def test_replayed_generator_draws_the_eager_stream_of_its_seed():
    """A generator registered with a graph, reseeded (or given another
    generator's state) between replays, draws exactly what an eager
    generator of that state draws, and its state advances the same way."""
    dev = _card()
    gen = torch.Generator(device=dev)
    out = torch.empty(1000, device=dev)
    step = Step(lambda: out.copy_(torch.randn(1000, generator=gen, device=dev)), [gen])

    def eager(seed, draws):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(1000, generator=g, device=dev) for _ in range(draws)], g

    gen.manual_seed(1)
    step()  # eager warm-up, then the capture
    assert step.graph is not None and torch.equal(out, eager(1, 1)[0][0])
    for seed in (5, 7):
        gen.manual_seed(seed)
        got = []
        for _ in range(3):
            step()
            got.append(out.clone())
        want, ref = eager(seed, 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(gen.get_state(), ref.get_state())
    src = torch.Generator(device=dev).manual_seed(11)
    torch.rand(10, generator=src, device=dev)
    gen.set_state(src.get_state())
    step()
    assert torch.equal(out, torch.randn(1000, generator=src, device=dev))


@pytest.mark.gpu
def test_a_capture_that_cannot_succeed_raises():
    """A body that reads a device value on the host runs eagerly (the
    warm-up) but cannot be captured: the step raises, keeps no graph and
    leaves the launch counters as they were; the card works on."""
    dev = _card()
    x = torch.ones(4, device=dev)
    step = Step(lambda: x.add_(float(x.sum())))
    ef.reset_launches()
    with pytest.raises(RuntimeError):
        step()
    assert step.graph is None and not any(ef.LAUNCHES.values())
    torch.cuda.synchronize()
    assert float(x.sum()) == 20.0  # the eager warm-up ran once


@pytest.mark.gpu
@pytest.mark.parametrize("backend,bf16", [("fused", False), ("fused", True), ("pallas", False)])
@pytest.mark.parametrize("fmt", ["executable", "stablehlo"])
def test_aot_roundtrip_on_card(tmp_path, backend, bf16, fmt):
    """An artifact of a service on the card (its kernel libraries, for
    ``fused`` the layer's and the sampler step's, and the PDB formatter, or
    their sources) loads into a service with other weights, which then
    samples the exporter's bytes."""
    from pmhc_tpu_torch.aot import load_sampler, read_artifact, save_sampler
    from pmhc_tpu_torch.ops import _build

    _card()
    kw = dict(batch_size=4, noise_step_count=6, backend=backend, bf16=bf16, seed=3)
    svc = SamplerService(random_model(seed=0), **kw)
    entries = [dummy_entry(seed=i) for i in range(3)]
    want = svc.sample_entries(entries, svc.batch_generator(0))
    path = str(tmp_path / "sampler.aot")
    save_sampler(svc, path, fmt=fmt)
    _, meta, _ = read_artifact(path)
    kernels = ("egnn_fused", "sampler_step") if backend == "fused" else ("egnn_pallas",)
    assert meta["platform"] == "cuda" and meta["device_name"] == torch.cuda.get_device_name(0)
    if fmt == "executable":
        assert {lib["name"] for lib in meta["libraries"]} == {*kernels, "pdb_formatter"}
        assert {lib["digest"] for lib in meta["libraries"]} == {
            _build.loaded(n).digest for n in (*kernels, "pdb_formatter")}
    fresh = SamplerService(random_model(seed=5), **kw)
    load_sampler(path, fresh)
    assert fresh.sample_entries(entries, fresh.batch_generator(0)) == want


@pytest.mark.gpu
@pytest.mark.parametrize("neighbour_block", [16, 32, 96])
def test_blockwise_matches_dense_on_card(neighbour_block):
    """The blockwise layer against the dense one at batch 64 on the card
    (``tests/unit/test_blockwise.py``'s tolerances: quats 5e-5, the rest
    2e-4), and a blockwise chain launches none of the kernels."""
    from pmhc_tpu_torch.models import egnn_forward
    from pmhc_tpu_torch.models.egnn_blockwise import egnn_forward_blockwise
    from pmhc_tpu_torch.models.score import relpos_edge_pre

    dev = _card()
    model = random_model(seed=0).to(dev)
    b = prepare_batch(synthetic_batch(batch_size=64, seed=17), dev)
    B, N = b["mask"].shape
    P = b["pocket_mask"].shape[-1]
    h = torch.cat((b["features"], torch.full((B, N, 1), 0.3, device=dev)), -1)
    ph = torch.cat((b["pocket_features"], torch.zeros((B, P, 1), device=dev)), -1)
    with torch.no_grad():
        args = (b["frames"], b["torsions"], h, relpos_edge_pre(model.gnn1, N), b["mask"].float(),
                ph, b["pocket_frames"], b["pocket_mask"].float())
        dense = egnn_forward(model.gnn1, *args)
        blk = egnn_forward_blockwise(model.gnn1, *args, neighbour_block=neighbour_block)
    (df, dt, dh), (bf, bt, bh) = dense, blk
    for name, g, w, tol in (("quats", bf.quats, df.quats, 5e-5), ("trans", bf.trans, df.trans, 2e-4),
                            ("torsions", bt, dt, 2e-4), ("features", bh, dh, 2e-4)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol, err_msg=name)
    for mod in (ef, el, ep):
        mod.reset_launches()
    svc = SamplerService(model, batch_size=4, noise_step_count=6, backend="blockwise", bf16=True)
    assert svc.precision == "f32"
    pdbs = svc.sample_entries([dummy_entry()], svc.batch_generator(0))
    assert pdbs[0].endswith(b"END\n")
    assert not any(v for mod in (ef, el, ep) for v in mod.LAUNCHES.values())


@pytest.mark.gpu
def test_native_formatter_taken_by_finalize_on_card(monkeypatch):
    from pmhc_tpu_torch.io import pdb_native

    _card()
    svc = SamplerService(random_model(seed=0), batch_size=4, noise_step_count=6, seed=3)
    entries = [request_entry(seed=i) for i in range(4)]  # proteins with atoms: chains P and M
    handle = svc.dispatch(entries, svc.batch_generator(0))
    pdb_native.reset_calls()
    native = svc.finalize(handle)
    assert pdb_native.CALLS["format_atoms"] == 2 * len(entries)
    monkeypatch.setenv("PMHC_PDB_FORMATTER", "python")
    assert svc.finalize(handle) == native


# -- the mesh paths (on a machine with four cards: ``python -m pytest
# tests/test_torch_gpu.py --noconftest -m gpu -k mesh``) ------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_mesh_rank_kernels_on_the_second_card(mode):
    """Every kernel with its tensors on cuda:1 and cuda:1 the current
    device, as rank 1 of a mesh has them, against its plain version: the
    launches go to the tensors' card and the loop backward sizes its grid
    from it."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(dev):
        model = random_model(seed=0).to(dev)
        bf16 = ef.FLAGS[mode]
        args = layer_case(model, "gnn1", seed=1, device=dev)
        got, want = ef.egnn_fused(*args, bf16=bf16), ef.egnn_fused_plain(*args, bf16=bf16)
        torch.cuda.synchronize(dev)
        for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
            assert g.device == dev
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=TOL[mode][name],
                                       err_msg=f"fused {name}")
        args, cts = loop_case(model, "gnn2", seed=2, device=dev)
        got = loop_run(args, cts, bf16, kernel=True)
        want = loop_run(args, cts, bf16, kernel=False)
        torch.cuda.synchronize(dev)
        bad = {n: r for n, r in loop_errors(got, want, LOOP_TOL[mode]).items() if not r[3]}
        assert not bad, f"loop: {bad}"
        if mode == "fp32":
            ctx, step = pallas_case(model, "gnn1", seed=3, device=dev)
            got, want = ctx(*step), ep.egnn_pallas_plain(*ctx.inputs(*step))
            torch.cuda.synchronize(dev)
            for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=PALLAS_TOL[name],
                                           err_msg=f"pallas {name}")


def _mesh_dp_cp(world: int) -> None:
    """One rank of ``test_mesh_dp_and_cp_match_one_card``."""
    from chip_smoke import mesh_layouts, mesh_vs_single
    from pmhc_tpu_torch.parallel import make_mesh

    layouts = mesh_layouts(world)
    mesh_vs_single("dp", make_mesh(*layouts["dp"]), "card test")
    for backend in ("cp", "ring"):
        mesh_vs_single(backend, make_mesh(*layouts[backend]), "card test", backend=backend,
                       context_parallel=True)


@pytest.mark.gpu
def test_mesh_dp_and_cp_match_one_card():
    """DP on every card, and CP and ring training on their ``chip_smoke``
    layouts, 5 graphed steps each at batch 64 a data rank, against a
    one-card ``Trainer`` from the same seed on the same batches
    (``GRAPH_TRAIN_TOL``), one process a card over NCCL."""
    from pmhc_tpu_torch.parallel.distributed import spawn

    _card()
    world = torch.cuda.device_count()
    spawn(_mesh_dp_cp, world, args=(world,), device="cuda", timeout=600)
