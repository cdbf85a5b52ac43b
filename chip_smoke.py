#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``pmhc_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. device check: a CUDA card must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles every CUDA source of the port from this checkout with
   nvcc, one process per source, all started together (``-Xptxas -v``:
   registers, shared memory, spills). The fused kernel's three
   instantiations (fp32, bf16, high), the loop kernels' six and kernel #3
   must not spill, and ``cuobjdump -sass`` must find tensor-core
   instructions (HMMA: mma.sync, 4,096 FLOP an HMMA.16816; HGMMA: wgmma,
   2,048 N an HGMMA.64xNx16) in the bf16 instantiations of the fused
   kernel and of the loop forward and backward, none in their fp32 ones,
   and in their high ones (``--fast-f32``: each product three passes on
   wgmma) HGMMA only, no HMMA, every HGMMA shape a multiple of three and
   at least 2.5 times the bf16 tensor-core FLOP; the sampler step's
   kernels (``csrc/sampler_step.cu``) must not spill;
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes (batch 64, both layer shapes, fp32, bf16 and high
   modes), with the tolerances stated below: the fused sampler layer, the
   training neighbour loop forward (its seven accumulators) and backward
   (every input's gradient and the loop weights'), and the round-1 fused
   layer (TPU kernel #3, fp32, on a batch with peptides shorter than 16,
   so some rows are fully masked). The fp32 kernels must fail the bf16
   tolerances against the bf16 plain version on some output, and the bf16
   kernels the high tolerances against the high plain version, so a mode
   that skipped its rounding or its split could not pass. The fused layer,
   the loop kernels and kernel #3 also run with their neighbours cut to
   NP = 90 (a ragged last row tile; for the loop backward a partial
   second 48-neighbour tile; for #3 a partial 32-neighbour block), and the
   fused layer and the loop forward with 40 neighbours more, NP = 136 (two
   96-neighbour tiles per query row, merged online; the loop backward
   takes NP <= 96); the fused layer also on inputs 4 bytes off 16-byte
   alignment (``unaligned_case``); the sampler step's two kernels
   (``sampler_step_case``: a chain's first, middle and last step, in every
   mode; ``SAMPLER_STEP_TOL``);
4. the main paths, which run from CUDA graphs (``utils/graphs.py``: a
   step captured once per shape and mode, then replayed; each replay adds
   the captured launches to the counters, so the counts below are
   launches on the card). Serving: ``SamplerService(batch_size=64,
   noise_step_count=1000)`` answers 3 requests, then two full batches of
   64, in fp32, bf16 and fast-f32; checks the PDBs parse with finite coordinates
   and the right chains, the quats are unit, and the kernel ran exactly
   2 x 1000 times per batch, the sampler step's kernels as often, in the
   mode (none on the mesh's sharded sampling, phase 6). Then a batch-64 strided 100-step trajectory
   from graphs is held against the eager one from the same batch
   generator (fused fp32, bf16 and high, pallas; ``TRAJ_TOL``, and logged
   whether bit-identical). Before it, a 4-step trajectory through the
   kernel (fp32 and high) is held against the dense oracle layer with the
   same injected noise. Training: ``Trainer`` at batch 64 takes 20 steps
   in each of fp32, bf16 and fast-f32 on synthetic batches; losses must
   be finite and the loop kernels must run exactly 2 forward and 2
   backward launches per step in the mode. Before it, a 5-step trajectory
   through the kernels (fp32 and high), with injected t and noise, is
   held against the dense autograd path; after it, 5 graphed steps
   against 5 eager ones from one seed, per mode
   (``GRAPH_TRAIN_TOL``, and logged whether bit-identical). The ``pallas``
   backend: a 4-step trajectory against the dense oracle; the HTTP server
   (``pmhc_tpu_torch.cli.serve_cli.create_server``, ``--backend pallas
   --batch-size 64 -T 1000``, weights from a ``.pth`` written here)
   answers ``/healthz``, 3 concurrent requests, one ``?samples=4`` and 64
   concurrent requests that fill one batch, every PDB parsed, kernel #3
   launched exactly 2 x 1000 times per dispatched batch and the fused
   kernel never; ``Trainer(backend="pallas")`` takes 5 batch-64 steps
   held against a dense ``Trainer`` from the same seed, 2 launches per step;
4b. the offline CLIs, in-process through ``main([...])`` with ``--device
   cuda`` at batch 64, T=1000 and the published width, on packed ``.npz``
   files of realistic entries built here (no HDF5): train 1,024, val 64,
   test 67 (a full batch and a short batch of 3). ``train_cli`` takes 2
   fp32 epochs with ``--val-hdf5 --ema-decay 0.999 --orbax-dir``: its
   ``.pth``, ``.ema.pth`` and three CSVs (2 rows each, finite), exactly
   2 x 32 backward and 2 x 32 + 2 x 2 x 1 x 2 forward loop launches (the
   steps, then one validation batch per epoch with raw and EMA weights),
   none of bf16; the same command for 1 more epoch must resume (3 CSV
   rows, checkpoint step 32 -> 48); then 2 bf16 epochs with
   ``--device-data --steps-per-dispatch 4`` (four ``train_indices`` calls
   of 4 graph replays an epoch; 2 x 32 launches each way, no fp32), and
   the same with ``--eager``; one ``--fast-f32`` epoch (16 x 2 high
   launches each way, no other mode). ``sample_cli`` (batch i's PDBs
   written while batch i+1 samples) writes 67 PDBs in fp32, in bf16, in
   fast-f32 and in fp32 with ``--eager`` (2 x 1000 x 2 fused launches
   each, none of another mode), then 134 with
   ``--bf16 --num-samples 2 --sample-steps 100`` (2 x 100 x 2 x 2); every
   PDB passes ``check_pdb``. Logged: seconds and examples/s per epoch, the
   seconds the step loop waited on the loader, the sample CLI's whole-call
   wall and PDBs/s, and per batch its sampling and PDB-writing seconds;
4c. the tool twins (``pmhc_tpu_torch/tools/``) through ``main([...])`` on
   4b's fp32 ``.pth`` (3 epochs) and its 67-entry test file, every kernel
   counter reset before each and its counts checked exactly:
   ``eval_rmsd`` at T=1000 in fp32, bf16, fast-f32 and ``--backend pallas``
   (67 finite RMSDs and pure-noise RMSDs; 2 launches a step and batch of
   #1/#2 in the mode, or of #3), ``rmsd_backends`` at T=200 on 16
   realistic entries (its five default configs; the verdict is logged,
   not required: its outcome is stochastic), ``bench_sampler`` (one T=1000
   batch of 64 after the first call; fused and pallas in fp32, fused in
   bf16 and fast-f32), ``bench_train`` (20 batch-64 steps per mode; fused
   and pallas in fp32), ``bench_serve`` (8 warm-up requests, then 64 at
   concurrency 64, every response a PDB) and ``flops`` on the rates they
   measured (achieved TFLOP/s and share of the H100's peak);
4d. the last single-card modules: the AOT artifact (``aot_main_path``:
   ``tools/bench_aot.py`` exports batch-64 strided services' executable
   artifacts here, fused fp32, fused bf16 and pallas; a fresh process on a
   copy of the package with an empty build directory and no reachable
   nvcc loads each and samples the exported PDB arrays and bytes bit for
   bit, launching 2 x ``OFFLINE_SAMPLE_STEPS`` of #1, #2 or #3 and nothing
   else; its first-result time beside a cold process (nvcc builds) and a
   warm one (libraries copied in), and a doctored ``device_name`` refused
   before sampling); the ``blockwise`` backend (a batch-64 strided chain
   and 5 optimizer steps that launch no kernel, the layer against the
   dense one per neighbour block, ``BLOCKWISE_TOL``, and the peak memory
   of a batch-64 layer forward, dense and blockwise at 16, 32 and 96
   neighbours a block); the native PDB formatter (``finalize`` of a batch
   of 64 takes it, 2 calls an entry, with the Python path's bytes; both
   timed); the HDF5 decoder logged as skipped without a libhdf5;
5. times: each kernel (the sampler step's two: their sum a step) and its
   plain version per launch (``time_ms``:
   N launches captured in a CUDA graph, its replay timed between CUDA
   events, so no wrapper's host work is in it), beside the bound reckoned
   from this run's shapes (for the
   fused layer and the loop forward also ``gemm_ms``, the yardstick of
   their dominant product alone: one ``torch.matmul`` of [B*N*NP, 64] @
   [64, 256] in the mode's precision, three bf16 ones for high, which the
   port never calls); the
   wall seconds per batch-64 trajectory, per 64-request HTTP batch and per
   optimizer step; then, from graphs and eager, the wall of strided
   100-step batch-64 sampling runs (fused fp32, bf16 and high, pallas) and
   of 20 training steps per mode, and ``torch.profiler`` over them (10 of
   the training steps): device time by kernel, idle share; and the
   sample CLI's overlap loop over 3 T=1000 batches from graphs.
   (``chip_studies.py`` measures the choices behind the defaults: steps
   per sampler graph, and ``train_indices`` against one-step dispatch.)
6. the mesh paths (``multi_gpu_main_path``), on min(cards, 4) ranks, one
   process a card over NCCL (one card: every path on a mesh of one, logged
   as ``multi_gpu_world`` 1): DP training at batch 64 a rank, 20 graphed
   steps per mode with finite losses and exactly 2 forward and 2 backward
   loop launches a step on every rank, and 5 steps per mode held against a
   one-card ``Trainer`` on the same global batches and seed
   (``GRAPH_TRAIN_TOL``); CP (data x context 2) and ring (context = all)
   sampling: a 4-step injected-noise trajectory against the one-card dense
   sampler (``TRAJ_TOL``) and a batch-64 T=1000 chain whose PDBs pass
   ``check_pdb``, and CP and ring training, 5 steps each against one
   card; TP (model 2: the loop kernels on gathered weights, and
   the dense layer Megatron-style) and DP x TP x CP (model 2 x context 2,
   the cp layer with Megatron MLPs), 5 steps each against one card;
   ``train_cli --mesh-data`` (rank 0's ``.pth`` loads strict) and
   ``sample_cli --backend cp --mesh-context`` (every PDB once) on the
   group; then DP steps at 1, 2 and 4 ranks (64 a rank and 64 in all), the
   gradient all-reduce alone, and the CP and ring T=1000 chains beside the
   one-card dense one; last, ``train_cli --mesh-data`` on ranks started
   by ``torchrun``, every one ending its process within ``TORCHRUN_S``.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each ported kernel with its launches, error and times, and the
line before that is ``nvidia-smi``'s name and power limit of the card.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

B, STEPS = 64, 1000
# kernel vs plain version: fp32 sums in another order (~1e-6); in bf16
# mode one bf16 ulp (2^-8 relative) can flip where the two sum orders
# straddle a rounding boundary. Phase 3 also checks that the bf16
# tolerances reject the fp32 kernel held against the bf16 plain version
TOL = {"fp32": {"q": 5e-5, "t": 2e-4, "tors": 5e-5, "feat": 2e-4},
       "bf16": {"q": 2e-3, "t": 2e-2, "tors": 2e-3, "feat": 1e-2}}
# high: both sides split the same operands into the same bf16 halves;
# the sums differ in order, as in fp32 mode, hence fp32's tolerances
TOL["high"] = dict(TOL["fp32"])
MODES = ("fp32", "bf16", "high")
# what SamplerService.precision and the CLIs report for each mode
PRECISION = {"fp32": "f32", "bf16": "bf16", "high": "fast-f32"}
# 4-step kernel trajectory vs the dense oracle with injected noise
# (the JAX package's lane-sampler tolerances)
TRAJ_TOL = {"q": 2e-4, "t": 1e-3, "tors": 2e-4}
REPLACES = {"fp32": "pmhc_tpu/ops/egnn_pallas_lane.py:194",
            "bf16": "pmhc_tpu/ops/egnn_pallas_lane_g8.py:177",
            "high": "pmhc_tpu/ops/egnn_pallas_lane.py:194"}
# the training loop kernels (forward, backward) against their plain
# versions, as a share of each output's largest magnitude. fp32: sums in
# another order (atomics included). bf16: the forward rounds at the same
# points as the plain version (a flipped rounding moves one element by a
# bf16 ulp); the backward rounds the operands of its products, where the
# plain version's autograd multiplies unrounded gradients, one bf16 ulp
# (2^-8) per product, summed over up to 1,536 pairs per weight element.
# Measured (H100): up to 9.2e-3 and 2.4e-3 of the largest magnitude in two
# runs of the same inputs (the plain version's fp32 sums, and so its bf16
# roundings, vary between runs), hence 3e-2.
LOOP_TOL = {"fp32": {"fwd": 2e-5, "bwd": 2e-4}, "bf16": {"fwd": 2e-3, "bwd": 3e-2}}
# high: the kernels' products and the plain version's (forward and
# autograd, ops/egnn_fused.py::_split_mm) split the same operands; the sums
# differ in order, as in fp32 mode, hence fp32's gradient tolerance. The
# forward: measured (H100) up to 1.58e-5 of D's largest magnitude (layer 1;
# fp32 mode 8.5e-7): the tensor cores sum the three passes in their own
# order and exp(logit - m) turns a logit's absolute error into D's
# relative one, hence 5e-5, which the bf16 kernels still break (1e-3)
LOOP_TOL["high"] = {"fwd": 5e-5, "bwd": LOOP_TOL["fp32"]["bwd"]}
LOOP_REPLACES = {"fwd_fp32": "pmhc_tpu/ops/egnn_pallas_lane_vjp.py:157",
                 "fwd_bf16": "pmhc_tpu/ops/egnn_pallas_lane_vjp.py:589",
                 "bwd_fp32": "pmhc_tpu/ops/egnn_pallas_lane_vjp.py:237",
                 "bwd_bf16": "pmhc_tpu/ops/egnn_pallas_lane_vjp.py:678",
                 "fwd_high": "pmhc_tpu/ops/egnn_pallas_lane_vjp.py:157",
                 "bwd_high": "pmhc_tpu/ops/egnn_pallas_lane_vjp.py:237"}
# kernel #3 against its plain version: fp32 sums in another order, as the
# fused kernel's fp32 mode
PALLAS_TOL = TOL["fp32"]
PALLAS_REPLACES = "pmhc_tpu/ops/egnn_pallas.py:84"
# peptide lengths of kernel #3's check batches (padded rows fully masked)
PALLAS_LENGTHS = (9, 5, 1, 16, 12, 3, 9, 14)
# the sampler step's two kernels against their plain versions
# (ops/sampler_step.py), absolute: the inter-layer kernel's projection
# sums its 64 products in another order (~1e-6 of a_j ~ 1), its relu and
# copies are exact; the step kernel's new state comes from the same
# accurate sqrtf / acosf / sinf / cosf and IEEE divisions as PyTorch's
# CUDA kernels, where nvcc may contract a product and a sum into one FMA
# (under the CPU emulation: glibc's functions against PyTorch's vectorised
# ones), an ulp of a quaternion or an angle, grown where acos is steep;
# hence the fused layer's fp32 tolerances. The next step's a_j and time
# column, the counter and the copies: exact (0)
SAMPLER_STEP_TOL = {"h2": 0.0, "aj2": TOL["fp32"]["feat"], "qj2": 0.0, "tj2": 0.0, "k": 0.0,
                    "q": TOL["fp32"]["q"], "t": TOL["fp32"]["t"], "tors": TOL["fp32"]["tors"],
                    "h1": 0.0, "aj1": 0.0, "qj1": TOL["fp32"]["q"], "tj1": TOL["fp32"]["t"],
                    "ticket": 0.0}
TRAIN_STEPS = 20
# 5-step kernel trajectory vs the dense autograd path (Adam, lr 1e-3):
# losses relative; parameters loosely, absolute: Adam moves a parameter by
# up to ~lr per step whatever its gradient's size, so where a gradient is
# cancellation noise (attention lin2 bias) the two paths may drift by
# O(lr) per step; the bound is the 5 steps' budget
TRAIN_LR = 1e-3
TRAIN_TOL = {"loss_rtol": 5e-4, "param_atol": 5 * TRAIN_LR}
# graphed against eager training (the same kernels, replayed; the loop
# backward's atomics still sum in an order that varies): losses relative,
# and the parameters' (and the EMA's) change from their start, held as
# ||change_graphed - change_eager|| / ||change_eager|| over all of them
# and for the median tensor, where an update dropped or made with a stale
# learning rate or bias correction reads 0.2-1 (one step of 5 dropped:
# ~0.2); both must have moved. Measured (H100): at batch 64, 5 steps,
# losses equal, the change 2.8e-3 / 3.3e-3 fp32 over all tensors and
# 4.6e-6 the median one (the atomics' noise in the few tensors whose
# gradients cancel), 6.5e-8 to 1.2e-5 bf16, hence 2e-2; at batch 8 in
# bf16 (``test_torch_gpu.py``) the losses up to 1.5e-5 apart (a flipped
# bf16 rounding moves an element by 2^-8), hence 1e-4
GRAPH_TRAIN_TOL = {"loss_rtol": 1e-4, "change_rtol": 2e-2}
# phase 4b's packed files (entries, seed): 16 training batches of 64, one
# validation batch, a test set of a full batch and a short batch of 3
OFFLINE_SETS = {"train": (1024, 0), "val": (64, 1), "test": (67, 2)}
OFFLINE_SAMPLE_STEPS = 100  # the strided sampling run's jumps
RMSD_BACKENDS_T = 200  # phase 4c's rmsd_backends run (the JAX tool's default T)
# phase 4d: the blockwise layer against the dense one (tests/unit/test_blockwise.py's)
BLOCKWISE_TOL = {"q": 5e-5, "t": 2e-4, "tors": 2e-4, "feat": 2e-4}
NEIGHBOUR_BLOCKS = (16, 32, 96)
# phase 6: steps held against one card; the timed DP steps per world; the
# gradient all-reduce's repeats; the CLIs' packed files (entries, seed)
MESH_STEPS = 5
MESH_TIMED_STEPS = 20
ALLREDUCE_ITERS = 200
MESH_SETS = {"train": (256, 3), "test": (67, 2)}
MESH_SAMPLE_STEPS = 100  # the sample CLI's strided jumps on the mesh
TORCHRUN_S = 240  # the train CLI under torchrun, start to the last rank's exit


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card (``tools.card_line``)."""
    from pmhc_tpu_torch.tools import card_line as line

    return line("cuda")


def random_model(seed: int):
    """ScoreNetwork at the published widths, weights U(+-1/sqrt(fan_in))
    drawn from ``seed`` (on the CPU, so every card gets the same weights)."""
    import torch

    from pmhc_tpu_torch.models import ScoreNetwork

    return ScoreNetwork(generator=torch.Generator().manual_seed(seed))


def request_entry(seed: int, protein_len: int = 120):
    """A request entry: synthetic peptide/pocket plus a full protein whose
    atom14 slots exist where the residue type has them."""
    import numpy as np

    from pmhc_tpu_torch import constants as rc
    from pmhc_tpu_torch.serve import dummy_entry

    rng = np.random.default_rng(seed)
    e = dummy_entry(protein_len=protein_len, seed=seed)
    aat = rng.integers(0, 20, size=protein_len).astype(np.int32)
    e["protein_aatype"] = aat
    e["protein_atom14_positions"] = (rng.normal(size=(protein_len, 14, 3)) * 20).astype(np.float32)
    e["protein_atom14_exists"] = rc.restype_atom14_mask[aat] > 0.5
    return e


def egnn_case(model, layer: str, seed: int, device, batch_size: int = B, lengths=None):
    """``(layer module, egnn_forward's arguments)`` for one layer shape
    (layer 1: H=23, O=64; layer 2: H=64, O=1), batch 64 unless asked
    otherwise: noised frames and torsions, 9-residue peptides, or
    ``lengths`` residues cycled over the batch (padded rows fully masked)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
    from pmhc_tpu_torch.diffusion import DiffusionConfig, gen_noise
    from pmhc_tpu_torch.models import relpos_edge_pre

    nb = synthetic_batch(batch_size=batch_size, peptide_len=9 if lengths is None else 16, seed=seed)
    for b in range(batch_size if lengths else 0):
        nb["mask"][b, lengths[b % len(lengths)]:] = False
        nb["features"][b, lengths[b % len(lengths)]:] = 0.0
    mb = prepare_batch(nb, device)
    noise = gen_noise(torch.Generator(device=device).manual_seed(seed), (batch_size, 16),
                      DiffusionConfig())
    rng = np.random.default_rng(seed)
    if layer == "gnn1":
        h = torch.cat((mb["features"], torch.full((batch_size, 16, 1), 0.5, device=device)), -1)
        ph = F.pad(mb["pocket_features"], (0, 1))
    else:
        h = np.maximum(rng.normal(size=(batch_size, 16, 64)), 0).astype(np.float32)
        h = torch.from_numpy(h).to(device)
        ph = F.pad(mb["pocket_features"], (0, 64 - 22))
    mod = getattr(model, layer)
    with torch.no_grad():
        edge_pre = relpos_edge_pre(mod, 16)
    return mod, (noise["frames"], noise["torsions"], h, edge_pre, mb["mask"].float(), ph,
                 mb["pocket_frames"], mb["pocket_mask"].float())


def layer_case(model, layer: str, seed: int, device, batch_size: int = B):
    """The fused layer's pre-projected inputs for one layer shape."""
    import torch

    from pmhc_tpu_torch.ops.egnn_fused import layer_inputs

    mod, args = egnn_case(model, layer, seed, device, batch_size)
    with torch.no_grad():
        return layer_inputs(mod, *args)


def ragged_case(args, n_neighbours: int = 90):
    """The fused layer's inputs cut to ``n_neighbours`` along the neighbour
    axis (a_j, q_j, t_j, edge, mask): NP not a multiple of 16, so the
    kernel's last mma row tile is partly padding."""
    w, h, q_i, t_i, tors, a_j, q_j, t_j, edge, mask = args
    cut = lambda x, axis: x.narrow(axis, 0, n_neighbours).contiguous()
    return (w, h, q_i, t_i, tors, cut(a_j, 1), cut(q_j, 1), cut(t_j, 1), cut(edge, 1), cut(mask, 2))


def unaligned_case(args):
    """The fused layer's inputs with every tensor but the packed weights a
    view that starts 4 bytes into its storage: not 16-byte aligned, so the
    kernel copies a_j, q_j and edge in 4-byte pieces."""
    import torch

    def off(x):
        v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        v.copy_(x)
        return v

    return (args[0],) + tuple(off(x) for x in args[1:])


def sampler_step_case(model, seed: int, device, batch_size: int = B, bf16=False, k: int = 0,
                      steps: int = STEPS, pocket=None) -> dict:
    """The sampler step kernels' inputs, from a real chain at step ``k`` of
    T = ``steps`` (the last when ``k`` = steps - 1): a noised batch of
    9-residue peptides (row 1 of 4: padded rows), its ``FusedForward``
    with the step's inputs written (``start``), layer 1's outputs on its
    state and layer 2's predictions on those (the main path's layer), and
    the step's draws; ``pocket`` cuts the pocket to that many residues.
    The kernels' outputs (h2, the peptide rows of both layers' neighbour
    inputs, h1's time column) hold a sentinel. Returns ``{"inter": the
    inter-layer arguments, "step": the step's, "bf16": the mode flag}``."""
    import torch

    from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
    from pmhc_tpu_torch.diffusion import DiffusionConfig, gen_noise
    from pmhc_tpu_torch.diffusion.noise import draw_noise
    from pmhc_tpu_torch.diffusion.sampler import Chain, fused_forward, model_time
    from pmhc_tpu_torch.diffusion.schedule import step_tables
    from pmhc_tpu_torch.models import ScoreNetworkConfig

    nb = synthetic_batch(batch_size=batch_size, seed=seed)
    nb["mask"][1 % batch_size, 4:] = False
    if pocket is not None:
        for key in ("pocket_frames", "pocket_mask", "pocket_features"):
            nb[key] = nb[key][:, :pocket]
    mb = prepare_batch(nb, device)
    cfg = DiffusionConfig(noise_step_count=steps)
    g = torch.Generator(device=device).manual_seed(seed)
    start = gen_noise(g, (batch_size, 16), cfg)
    mb["frames"], mb["torsions"] = start["frames"], start["torsions"]
    ts, sched = step_tables(cfg)
    with torch.no_grad():
        fwd = fused_forward(model, mb, ScoreNetworkConfig(noise_step_count=steps), bf16)
        chain = Chain(mb, model_time("fused", ts, steps), sched)
        chain.k.fill_(k)
        fwd.start(chain)
        c1, c2 = fwd.ctx1, fwd.ctx2
        q1, t1, tors1, inner = c1.run(fwd.h1, chain.q, chain.t, chain.tors)
        h2 = torch.relu(inner)
        q2, t2, tors2, _ = c2(h2, q1, t1, tors1, c2.project(h2))
        draws = draw_noise(g, (batch_size, 16), cfg)
        for ctx in (c1, c2):
            for x in (ctx.aj, ctx.qj, ctx.tj):
                x[:, :16] = -7.0
        fwd.h1[..., -1] = -7.0
        fwd.h2.fill_(-7.0)
    return {"inter": (inner, q1, t1, c2.wj_t, fwd.h2, c2.aj, c2.qj, c2.tj),
            "step": (chain.k, chain.xs, chain.sched, chain.q, chain.t, chain.tors, q2, t2, tors2,
                     draws, fwd.h1, fwd.aj1_static, fwd.wj1_time, c1.aj, c1.qj, c1.tj, fwd.ticket),
            "bf16": c1.bf16}


def copy_args(args) -> tuple:
    """A copy of a sampler step kernel's arguments (a ``Draws``' tensors too)."""
    from pmhc_tpu_torch.diffusion.noise import Draws

    return tuple(Draws(*(x.clone() for x in a[:3]), a.scale) if isinstance(a, Draws)
                 else a.clone() for a in args)


def sampler_step_errors(case: dict, run_inter, run_step) -> dict:
    """Both sampler step kernels, ``run_inter(*args)`` and
    ``run_step(*args)``, against their plain versions, each side on its own
    copy of ``case``'s inputs: the largest absolute difference of each
    output they write (names of ``SAMPLER_STEP_TOL``)."""
    import torch

    from pmhc_tpu_torch.ops import sampler_step as ss

    got_i, want_i, got_s, want_s = (copy_args(case[k]) for k in ("inter", "inter", "step", "step"))
    run_inter(*got_i)
    ss.inter_layer_plain(*want_i, bf16=case["bf16"])
    run_step(*got_s)
    ss.step_plain(*want_s[:-1])
    if got_s[0].device.type == "cuda":
        torch.cuda.synchronize()
    err = lambda g, w: float((g.double() - w.double()).abs().max())  # noqa: E731
    out = {n: err(got_i[i], want_i[i]) for n, i in (("h2", 4), ("aj2", 5), ("qj2", 6), ("tj2", 7))}
    out.update({n: err(got_s[i], want_s[i]) for n, i in (
        ("k", 0), ("q", 3), ("t", 4), ("tors", 5), ("h1", 10), ("aj1", 13), ("qj1", 14),
        ("tj1", 15), ("ticket", 16))})
    return out


def bound_of(split_flops: float, other_flops: float, nbytes: float, mode: str):
    """(bound ms, bound_by) of work whose tensor-core products take
    ``split_flops`` and the rest ``other_flops``: the larger of the bytes
    over 3.35 TB/s and the operations over the mode's peaks (fp32: all at
    the fp32 peak; bf16: all at the bf16 peak; high: the split products
    three times at the bf16 peak, the rest at the fp32 peak; the H100's
    peaks, ``tools/flops.py``)."""
    from pmhc_tpu_torch.tools.flops import PEAK_BF16, PEAK_BYTES, PEAK_FP32

    if mode == "high":
        t_ops = 3 * split_flops / PEAK_BF16 + other_flops / PEAK_FP32
    else:
        t_ops = (split_flops + other_flops) / (PEAK_BF16 if mode == "bf16" else PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def work_of(args, mode: str):
    """(FLOP, bytes, bound ms, bound_by) the layer needs for these inputs:
    every matmul MAC as 2 operations (per pair: head lin1 4T x T and lin2
    13 x T, the products a high mode splits; the rot term 4 x T; per node:
    a_i, torsion term, feature MLP), each input read once and each output
    written once."""
    w, h, q_i, t_i, tors, a_j, q_j, t_j, edge, mask = args
    Bn, N, H = h.shape
    NP, T = a_j.shape[1], a_j.shape[2]
    pairs = Bn * N * NP
    split = 2 * pairs * (4 * T * T + 13 * T)
    other = 2 * (pairs * 4 * T + Bn * N * (T * H + T * 14 + T * H + T * T + w.O * T)) + pairs * 3 * T
    in_bytes = sum(x.numel() * 4 for x in (w.buf, h, q_i, t_i, tors, a_j, q_j, t_j, edge, mask))
    out_bytes = Bn * N * (4 + 3 + 14 + w.O) * 4
    return (split + other, in_bytes + out_bytes) + bound_of(split, other, in_bytes + out_bytes, mode)


def pallas_case(model, layer: str, seed: int, device, batch_size: int = B):
    """Kernel #3's static context (``ops/egnn_pallas.py::pallas_context``,
    the main path's entry) and the peptide state ``(h, q, t, tors)`` it is
    called with, for one layer shape, with peptides of ``PALLAS_LENGTHS``
    residues. ``ctx.inputs(*step)`` are the kernel's ten inputs."""
    import torch

    from pmhc_tpu_torch.ops.egnn_pallas import pallas_context

    mod, (frames, tors, h, edge_pre, mask, ph, pf, pm) = egnn_case(
        model, layer, seed, device, batch_size, lengths=PALLAS_LENGTHS)
    with torch.no_grad():
        ctx = pallas_context(mod, edge_pre, mask, ph, pf, pm)
    return ctx, (h.contiguous(), frames.quats.contiguous(), frames.trans.contiguous(),
                 tors.contiguous())


def pallas_ragged(ctx, n_neighbours: int = 90):
    """Kernel #3's context with its neighbours cut to ``n_neighbours`` (the
    last pocket slots dropped from h_pocket, q_pocket, t_pocket, edge and
    the mask): NP not a multiple of 32, so the kernel's last 32-neighbour
    block is partial, and at H = 23 the batch elements' h_all blocks do not
    start 16-byte aligned."""
    import dataclasses

    n_pocket = n_neighbours - ctx.msg_mask.shape[1]
    cut = lambda x, axis, n: x.narrow(axis, 0, n).contiguous()
    return dataclasses.replace(
        ctx, h_pocket=cut(ctx.h_pocket, 1, n_pocket), q_pocket=cut(ctx.q_pocket, 1, n_pocket),
        t_pocket=cut(ctx.t_pocket, 1, n_pocket), edge=cut(ctx.edge, 1, n_neighbours),
        msg_mask=cut(ctx.msg_mask, 2, n_neighbours))


def work_of_pallas(args):
    """(FLOP, bytes, bound ms, bound_by) of one launch of kernel #3 on these
    inputs: the operations the layer needs. Per (b, i, j) pair, in
    multiply-adds: the message lin2 T x M, the attention lin1 (M + 2) x T,
    the rotation lin1 (M + 4) x T, the torsion and translation lin1 M x T
    each, the four lin2 13 x T; per query row: a_i H x T, the torsion node
    term 14 x T, the feature MLP (H + M) x T + T x O; per (b, j) neighbour:
    its projection h_j H x T (the kernel repeats it for every query row,
    as the TPU kernel does; the function needs it once). Each MAC is 2
    operations; each input is read once and each output written once."""
    from pmhc_tpu_torch.tools.flops import PEAK_BYTES, PEAK_FP32

    w, h, h_all, q_i, t_i, q_j, t_j, tors, mask, edge = args
    Bn, N, NP = mask.shape
    H, T, M = h.shape[-1], edge.shape[-1], edge.shape[-1]
    pair = T * M + (M + 2) * T + (M + 4) * T + 2 * M * T + 13 * T
    row = H * T + 14 * T + (H + M) * T + T * w.O
    flops = 2 * (Bn * N * NP * pair + Bn * N * row + Bn * NP * H * T)
    in_bytes = sum(x.numel() * 4 for x in (w.buf,) + tuple(args[1:]))
    out_bytes = Bn * N * (4 + 3 + 14 + w.O) * 4
    t_ops, t_bytes = flops / PEAK_FP32, (in_bytes + out_bytes) / PEAK_BYTES
    return flops, in_bytes + out_bytes, max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def loop_case(model, layer: str, seed: int, device, batch_size: int = B):
    """The loop kernels' inputs for one layer shape, pre-projected as the
    training layer projects them (``ops/egnn_loop.py``), and cotangents of
    (D, GD, TA, TR, HID) drawn from ``seed``."""
    import torch

    from pmhc_tpu_torch.ops.egnn_loop import loop_weights

    _, h, q_i, t_i, tors, a_j, q_j, t_j, edge, mask = layer_case(model, layer, seed, device,
                                                                 batch_size)
    mod = getattr(model, layer)
    Bn, N, H = h.shape
    M = mod.message_mlp[2].out_features
    with torch.no_grad():
        msg0 = mod.message_mlp[0]
        a_i = (h @ msg0.weight[:, :H].T + msg0.bias).contiguous()
        tor_node = (tors.reshape(Bn, N, 14) @ mod.torsion_mlp[0].weight[:, M:].T).contiguous()
        w = loop_weights(mod).contiguous()
    g = torch.Generator(device=device).manual_seed(seed)
    cts = [torch.randn((Bn, N) + s, generator=g, device=device) for s in ((), (4,), (7,), (3,), (64,))]
    return (w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, mask), cts


def loop_ragged(args, n_neighbours: int = 90):
    """The loop kernels' inputs cut to ``n_neighbours`` along the neighbour
    axis (``ragged_case``'s slice of a_j, q_j, t_j, edge and the mask): the
    backward's last 48-neighbour tile is partly padding."""
    w, a_i, tor, q_i, t_i, a_j, q_j, t_j, edge, mask = args
    cut = lambda x, axis: x.narrow(axis, 0, n_neighbours).contiguous()
    return (w, a_i, tor, q_i, t_i, cut(a_j, 1), cut(q_j, 1), cut(t_j, 1), cut(edge, 1), cut(mask, 2))


def loop_two_tiles(args, extra: int = 40):
    """The loop kernels' inputs (batch >= 2) with ``extra`` more neighbours:
    perturbed copies of pocket slots 20 .. 20 + extra, a random mask, and
    query row (1, 3) fully masked. NP = 96 + extra: the forward folds two
    96-neighbour tiles per query row, the second ragged over rows the first
    wrote (the backward takes NP <= 96)."""
    import numpy as np
    import torch

    w, a_i, tor, q_i, t_i, a_j, q_j, t_j, edge, mask = args
    rng = np.random.default_rng(6)
    noise = lambda s: torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)).to(mask.device)
    more = lambda x, axis: torch.cat((x, x.narrow(axis, 20, extra) + noise(x.narrow(axis, 20, extra).shape)),
                                     axis).contiguous()
    m = torch.from_numpy((rng.random(mask.shape[:2] + (extra,)) > 0.3).astype(np.float32)).to(mask.device)
    mask = torch.cat((mask, m), 2).contiguous()
    mask[1, 3] = 0.0
    return w, a_i, tor, q_i, t_i, more(a_j, 1), more(q_j, 1), more(t_j, 1), more(edge, 1), mask


def loop_forward_errors(args, bf16: bool, tol: dict):
    """``loop_errors`` of the loop forward (``egnn_loop``, the kernel on a
    card) against ``egnn_loop_plain`` on ``args``, outputs only."""
    import torch

    from pmhc_tpu_torch.ops import egnn_loop as el

    with torch.no_grad():
        got = dict(zip((f"out {n}" for n in el.OUT_NAMES), el.egnn_loop(*args, bf16=bf16)))
        want = dict(zip((f"out {n}" for n in el.OUT_NAMES), el.egnn_loop_plain(*args, bf16=bf16)))
    return loop_errors(got, want, tol)


def loop_run(args, cts, bf16: bool, kernel: bool):
    """The loop's seven outputs and the gradients of <outputs, cts> with
    respect to its nine differentiable inputs (the loop weights as their
    ten named parts): through the kernels (``egnn_loop``) or through the
    plain version and autograd. Returns one dict of named tensors."""
    import torch

    from pmhc_tpu_torch.ops import egnn_loop as el

    inp = [x.detach().clone().requires_grad_(True) for x in args[:9]]
    fn = el.egnn_loop if kernel else el.egnn_loop_plain
    outs = fn(*inp, args[9], bf16=bf16)
    return loop_named(outs, torch.autograd.grad(outs[1:6], inp, cts))


def loop_named(outs, grads) -> dict:
    """The loop's outputs ("out m", ...) and gradients ("dW whm", ...,
    "da_i", ...) by name."""
    from pmhc_tpu_torch.ops import egnn_loop as el

    named = {f"out {n}": o.detach() for n, o in zip(el.OUT_NAMES, outs)}
    named.update({f"dW {n}": g for n, g in el.loop_views(grads[0]).items()})
    named.update({f"d{n}": g for n, g in zip(("a_i", "tor_node", "q_i", "t_i", "a_j", "q_j", "t_j",
                                              "edge"), grads[1:])})
    return named


def loop_errors(got: dict, want: dict, tol: dict):
    """{name: (max abs err, its share of the reference's largest magnitude,
    tolerance, ok)} for the forward ("out ...") and gradient tensors."""
    import torch

    res = {}
    for name, w in want.items():
        g = got[name]
        err = float((g - w).abs().max())
        ref = max(float(w.abs().max()), 1e-6)
        t = tol["fwd" if name.startswith("out ") else "bwd"]
        ok = bool(torch.isfinite(g).all()) and err <= t * ref
        res[name] = (err, err / ref, t, ok)
    return res


def work_of_loop(args, m, cts, kind: str, mode: str):
    """(FLOP, bytes, bound ms, bound_by) of one loop-kernel launch on these
    inputs. Per (b, i, j) pair the forward does the head lin1 (4T x T
    MACs), the lin2 rows (13 x T) and the rotation term (4 x T), each MAC
    2 operations, plus the pre add, relu and HID sum (3T). The backward
    recomputes that and adds the whm outer product and whm^T d(pre_heads)
    (2 x 4T x T MACs), dW2 and w2^T d(out) (2 x 13 x T) and dwrq and
    wrq^T d(rot) (2 x 4 x T). The products of whm and w2 are the ones a
    high mode splits (``bound_of``). Each input is read once, each output
    written once."""
    w, a_i, tor, q_i, t_i, a_j, q_j, t_j, edge, mask = args
    Bn, N, NP = mask.shape
    T = a_i.shape[-1]
    split = 2 * (4 * T * T + 13 * T) * (1 if kind == "fwd" else 3)
    other = (2 * 4 * T + 3 * T) + (0 if kind == "fwd" else 2 * 2 * 4 * T)
    pairs = Bn * N * NP
    nbytes = lambda xs: sum(x.numel() * 4 for x in xs)
    if kind == "fwd":
        moved = nbytes(args) + Bn * N * (1 + 1 + 4 + 7 + 3 + T + 1) * 4
    else:
        moved = nbytes(args) + nbytes([m] + list(cts)) + nbytes(args[:9])
    return (pairs * (split + other), moved) + bound_of(pairs * split, pairs * other, moved, mode)


def check_loop_kernels(model, dev):
    """Phase 3, training loop: both kernels against their plain versions
    at batch 64 with each layer's weights and on layer 2's inputs cut to
    NP = 90, in each mode, forward outputs and every gradient; the forward
    also on layer 2's inputs grown to NP = 136 (``loop_two_tiles``). Returns
    the two layers' cases and the max abs error per mode and kernel."""
    cases = {layer: loop_case(model, layer, seed=10 + k, device=dev)
             for k, layer in enumerate(("gnn1", "gnn2"))}
    # and a ragged last backward tile: layer 2's neighbours cut to NP = 90
    checks = {**cases, "gnn2 NP=90": (loop_ragged(cases["gnn2"][0]), cases["gnn2"][1])}
    import torch

    from pmhc_tpu_torch.ops.egnn_fused import FLAGS

    max_err = {}
    for mode in MODES:
        bf16 = FLAGS[mode]
        worst = {"fwd": 0.0, "bwd": 0.0}
        for layer, (args, cts) in checks.items():
            got = loop_run(args, cts, bf16, kernel=True)
            want = loop_run(args, cts, bf16, kernel=False)
            torch.cuda.synchronize()
            for name, (err, rel, t, ok) in loop_errors(got, want, LOOP_TOL[mode]).items():
                log(f"check loop {mode} {layer} {name}: max_abs_err {err:.3e} = {rel:.2e} of max "
                    f"(tol {t:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"loop kernel {mode} {layer} {name} disagrees with plain version")
                kind = "fwd" if name.startswith("out ") else "bwd"
                worst[kind] = max(worst[kind], err)
            if mode != "bf16" and layer in cases:
                # the bf16 tolerances must catch a bf16 mode that skips its
                # rounding (the fp32 kernels against the bf16 plain version),
                # the high ones a high mode that rounds where it should split
                # (the bf16 kernels against the high plain version)
                other, against = ("fp32", "bf16") if mode == "fp32" else ("bf16", "high")
                got_o = got if other == mode else loop_run(args, cts, FLAGS[other], kernel=True)
                want_a = want if against == mode else loop_run(args, cts, FLAGS[against], kernel=False)
                over = [name for name, (err, rel, t, ok) in
                        loop_errors(got_o, want_a, LOOP_TOL[against]).items() if not ok]
                log(f"sensitivity loop {other} kernels vs {against} plain {layer}: {len(over)} outputs "
                    f"break the {against} tolerances: {', '.join(over[:8])}")
                if not over:
                    raise AssertionError(f"{against} loop tolerances cannot tell {other} from {against} "
                                         f"on {layer}")
        two = loop_two_tiles(cases["gnn2"][0])
        for name, (err, rel, t, ok) in loop_forward_errors(two, bf16, LOOP_TOL[mode]).items():
            log(f"check loop {mode} gnn2 NP={two[-1].shape[-1]} {name}: max_abs_err {err:.3e} = "
                f"{rel:.2e} of max (tol {t:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"loop forward {mode} NP=136 {name} disagrees with plain version")
            worst["fwd"] = max(worst["fwd"], err)
        max_err[mode] = worst
    return cases, max_err


def train_trajectory_check(dev, mode: str = "fp32") -> None:
    """Phase 4, training: 5 optimizer steps through the loop kernels in
    ``mode`` held against 5 through the dense layer's autograd, from the
    same weights, with the same batches, timesteps and noise."""
    import copy

    import torch

    from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
    from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, gen_noise
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.ops.egnn_fused import FLAGS
    from pmhc_tpu_torch.train import Adam, train_step

    dc = DiffusionConfig()
    tables = ScheduleTables(dc)
    base = random_model(seed=3).to(dev)
    models = {bk: copy.deepcopy(base) for bk in ("fused", "dense")}
    opts = {bk: Adam(list(m.parameters()), TRAIN_LR) for bk, m in models.items()}
    g = torch.Generator(device=dev).manual_seed(21)
    losses = {bk: [] for bk in models}
    for step, t in enumerate((999, 3, 517, 250, 760)):
        batch = prepare_batch(synthetic_batch(batch_size=B, seed=30 + step), dev)
        eps = gen_noise(g, (B, 16), dc)
        for bk, m in models.items():
            sums = train_step(m, opts[bk], batch, t, eps, model_config=ScoreNetworkConfig(backend=bk),
                              diffusion_config=dc, tables=tables, bf16=FLAGS[mode])
            losses[bk].append(float(sums["total loss"]))
    for step, (a, b) in enumerate(zip(losses["fused"], losses["dense"])):
        rel = abs(a - b) / abs(b)
        log(f"train trajectory {mode} step {step}: loss kernels {a:.6f} dense {b:.6f} rel {rel:.2e} "
            f"(rtol {TRAIN_TOL['loss_rtol']:.0e})")
        if not rel <= TRAIN_TOL["loss_rtol"]:
            raise AssertionError(f"training trajectory {mode} step {step}: loss disagrees with the "
                                 "dense path")
    worst, worst_name = 0.0, ""
    for (name, p), q in zip(models["fused"].named_parameters(), models["dense"].parameters()):
        diff = float((p.detach() - q.detach()).abs().max())
        if diff > worst:
            worst, worst_name = diff, name
    log(f"train trajectory {mode} parameters after 5 steps: max abs diff {worst:.2e} ({worst_name}; "
        f"tol {TRAIN_TOL['param_atol']:.0e})")
    if not worst <= TRAIN_TOL["param_atol"]:
        raise AssertionError(f"training trajectory {mode}: parameter {worst_name} off by {worst:.2e}")


def train_main_path(dev, card: str):
    """Phase 4, training: ``Trainer`` at batch 64 takes TRAIN_STEPS steps
    per mode with the launch counters reset just before. Returns the
    counts and the per-step walls."""
    import math

    import torch

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.diffusion import DiffusionConfig
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.train import MetricsRecord, TrainConfig, Trainer

    batches = [synthetic_batch(batch_size=B, seed=500 + k) for k in range(TRAIN_STEPS)]
    launches, walls = {}, {}
    for mode in MODES:
        tr = Trainer(ScoreNetworkConfig(backend="auto"), DiffusionConfig(),
                     TrainConfig(seed=5, nan_check_every=TRAIN_STEPS), bf16=mode == "bf16",
                     fast_f32=mode == "high")
        metrics = MetricsRecord()
        torch.cuda.synchronize()
        el.reset_launches()
        ef.reset_launches()
        walls[mode] = []
        for b in batches:
            t0 = time.monotonic()
            tr.train_batch(b, metrics)
            torch.cuda.synchronize()
            walls[mode].append(time.monotonic() - t0)
        counts = dict(el.LAUNCHES)
        want = {k: (2 * TRAIN_STEPS if k.endswith(mode) else 0) for k in counts}
        mean = metrics.mean()
        log(f"main path train {mode}: {TRAIN_STEPS} steps, launches {counts} (expected {want}), "
            f"mean losses {json.dumps({k: round(v, 4) for k, v in mean.items()})}")
        if counts != want or any(ef.LAUNCHES.values()):
            raise AssertionError(f"train {mode}: launches {counts}, expected {want}")
        if not all(math.isfinite(v) for v in mean.values()):
            raise AssertionError(f"train {mode}: non-finite losses {mean}")
        launches[mode] = counts
        log(json.dumps({"metric": "train_step_s", "mode": mode, "batch": B, "steps": TRAIN_STEPS,
                        "seconds": walls[mode], "card": card}))
    return launches, walls


def sampling_graphs_vs_eager(model, entries, card: str) -> None:
    """Phase 4: a batch-64 strided trajectory (``OFFLINE_SAMPLE_STEPS``
    steps) from CUDA graphs, the service's default, against the eager chain
    from the same batch generator, fused fp32, bf16 and high and ``pallas``: the
    kernel launched twice a step either way, the PDB arrays within
    ``TRAJ_TOL``. Logs the largest differences and whether the two are
    bit-identical."""
    import torch

    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_pallas as ep
    from pmhc_tpu_torch.serve import SamplerService

    k = OFFLINE_SAMPLE_STEPS
    tol = {"quats": TRAJ_TOL["q"], "trans": TRAJ_TOL["t"], "atom14": TRAJ_TOL["t"]}
    for backend, mode in (("auto", "fp32"), ("auto", "bf16"), ("auto", "high"), ("pallas", "fp32")):
        counter = ep.LAUNCHES if backend == "pallas" else ef.LAUNCHES
        out = {}
        for graphs in (True, False):
            svc = SamplerService(model, batch_size=B, noise_step_count=STEPS, num_steps=k,
                                 backend=backend, bf16=mode == "bf16", fast_f32=mode == "high",
                                 seed=7, graphs=graphs)
            torch.cuda.synchronize()
            ef.reset_launches()
            ep.reset_launches()
            handle = svc.dispatch(entries, svc.batch_generator(5))
            handle.wait()
            if counter[mode] != 2 * k or sum(ef.LAUNCHES.values()) + sum(ep.LAUNCHES.values()) != 2 * k:
                raise AssertionError(f"sampling {backend} {mode} graphs={graphs}: launches "
                                     f"{dict(ef.LAUNCHES)} {dict(ep.LAUNCHES)}, expected {2 * k}")
            out[graphs] = handle.conv
        diffs = {n: float((out[True][n] - out[False][n]).abs().max()) for n in tol}
        same = all(torch.equal(out[True][n], out[False][n]) for n in tol)
        log(json.dumps({"metric": "graphs_vs_eager_sampling", "backend": backend, "mode": mode,
                        "batch": B, "steps": k, "max_abs_diff": diffs, "bit_identical": same,
                        "tol": tol, "card": card}))
        if any(diffs[n] > tol[n] for n in tol):
            raise AssertionError(f"graphed {backend} {mode} sampling disagrees with eager: {diffs}")


def trainer_state(trainer) -> list:
    """Copies of a ``Trainer``'s parameters and EMA (if kept)."""
    ema = trainer.optimizer.ema or []
    return [p.detach().clone() for p in [*trainer.model.parameters(), *ema]]


def change_errors(start: list, got: list, want: list) -> dict:
    """How far ``got``'s change from ``start`` lies from ``want``'s (lists
    of tensors, as ``trainer_state`` gives): ``rel`` over all tensors,
    ``median_rel`` and ``worst_rel`` per tensor (a tensor ``want`` left
    where it was counts 0 if ``got`` did too, else inf), and the norms of
    both changes (``got_moved``, ``want_moved``)."""
    import torch

    diffs, norms, per = [], [], []
    for s0, g, w in zip(start, got, want):
        dw = (w - s0).double()
        d = float(((g - s0).double() - dw).norm())
        n = float(dw.norm())
        diffs.append(d)
        norms.append(n)
        per.append(d / n if n > 0 else (0.0 if d == 0 else float("inf")))
    total = float(torch.tensor(norms, dtype=torch.float64).norm())
    per.sort()
    return {"rel": float(torch.tensor(diffs, dtype=torch.float64).norm()) / max(total, 1e-300),
            "median_rel": per[len(per) // 2], "worst_rel": per[-1],
            "got_moved": float(torch.stack([(g - s0).double().norm() for s0, g in zip(start, got)])
                               .norm()),
            "want_moved": total}


def change_close(err: dict) -> bool:
    """``change_errors`` within ``GRAPH_TRAIN_TOL``, both having moved."""
    tol = GRAPH_TRAIN_TOL["change_rtol"]
    return (err["rel"] <= tol and err["median_rel"] <= tol and err["got_moved"] > 0
            and err["want_moved"] > 0)


def training_graphs_vs_eager(card: str, steps: int = 5) -> None:
    """Phase 4: ``steps`` batch-64 optimizer steps from CUDA graphs, the
    trainer's default, against the same steps eager, from one seed, per
    mode: losses and the parameters' change from their start within
    ``GRAPH_TRAIN_TOL``. Logs the differences and whether the two are
    bit-identical."""
    import torch

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    batches = [synthetic_batch(batch_size=B, seed=800 + k) for k in range(steps)]
    for mode in MODES:
        trainers = {g: Trainer(ScoreNetworkConfig(backend="auto"), train_config=TrainConfig(
            seed=12, learning_rate=TRAIN_LR, nan_check_every=0), bf16=mode == "bf16",
            fast_f32=mode == "high", graphs=g) for g in (True, False)}
        start = trainer_state(trainers[False])
        losses = {g: [float(tr.train_batch(b)["total loss"]) for b in batches]
                  for g, tr in trainers.items()}
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False]))
        got, want = trainer_state(trainers[True]), trainer_state(trainers[False])
        change = change_errors(start, got, want)
        worst = max(float((p - q).abs().max()) for p, q in zip(got, want))
        same = losses[True] == losses[False] and all(torch.equal(p, q) for p, q in zip(got, want))
        log(json.dumps({"metric": "graphs_vs_eager_training", "mode": mode, "batch": B,
                        "steps": steps, "losses": losses[True], "eager_losses": losses[False],
                        "loss_max_rel_diff": rel, "param_change": change,
                        "param_max_abs_diff": worst, "bit_identical": same,
                        "tol": GRAPH_TRAIN_TOL, "card": card}))
        if not (rel <= GRAPH_TRAIN_TOL["loss_rtol"] and change_close(change)):
            raise AssertionError(f"graphed {mode} training disagrees with eager: rel {rel:.2e}, "
                                 f"parameters' change {change}")


def cuobjdump_path() -> str:
    """``cuobjdump`` beside ``nvcc``, else the copy in Triton's package."""
    from pmhc_tpu_torch.ops import _build

    cand = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if os.path.exists(cand):
        return cand
    import triton

    cand = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")
    if not os.path.exists(cand):
        raise RuntimeError("cuobjdump not found beside nvcc nor in the triton package")
    return cand


def ptxas_entries(log: str, kind_of) -> dict:
    """{kind: {"registers", "spill_bytes", "smem_bytes"}} from an
    ``nvcc -Xptxas -v`` log, for each entry function that ``kind_of(mangled
    name)`` names (None: not reported). ``smem_bytes`` is the static shared
    memory (the kernels' tiles are dynamic)."""
    res, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            cur = kind_of(m.group(1))
            if cur:
                res.setdefault(cur, {"registers": None, "spill_bytes": 0, "smem_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            res[cur]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            res[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            res[cur]["smem_bytes"] = int(m.group(1))
    return res


def check_pallas_build(info: dict) -> dict:
    """Phase 2, kernel #3: ``egnn_pallas_kernel`` must be reported by
    ``ptxas -v`` and must not spill. Returns its registers, spill bytes and
    static shared memory."""
    res = ptxas_entries(info["log"], lambda name: "fp32" if "egnn_pallas_kernel" in name else None)
    log(f"build egnn_pallas kernel: {json.dumps(res)}")
    if set(res) != {"fp32"} or res["fp32"]["registers"] is None:
        raise AssertionError(f"egnn_pallas: ptxas did not report the kernel: {res}")
    if res["fp32"]["spill_bytes"]:
        raise AssertionError(f"egnn_pallas spills registers: {res}")
    return res["fp32"]


def check_sampler_step_build(info: dict) -> dict:
    """Phase 2, the sampler step's kernels: the inter-layer kernel's two
    instantiations (fp32 and high: ``false``; bf16: ``true``) and the step
    kernel must be reported by ``ptxas -v`` and must not spill."""
    def kind_of(name):
        if "sampler_inter_kernel" in name:
            return "inter_bf16" if "ILb1E" in name else "inter_fp32"
        return "step" if "sampler_step_kernel" in name else None

    res = ptxas_entries(info["log"], kind_of)
    log(f"build sampler_step kernels: {json.dumps(res)}")
    if set(res) != {"inter_fp32", "inter_bf16", "step"} or any(
            r["registers"] is None for r in res.values()):
        raise AssertionError(f"sampler_step: ptxas did not report every kernel: {res}")
    if any(r["spill_bytes"] for r in res.values()):
        raise AssertionError(f"sampler_step spills registers: {res}")
    return res


def check_sampler_step(model, dev) -> float:
    """Phase 3: both sampler step kernels against their plain versions at
    batch 64 in every mode, at the chain's first step, a middle one and its
    last (``SAMPLER_STEP_TOL``). Returns the largest error."""
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import sampler_step as ss

    worst = 0.0
    for mode in MODES:
        for k in (0, STEPS // 2, STEPS - 1):
            case = sampler_step_case(model, seed=30 + k, device=dev, bf16=ef.FLAGS[mode], k=k)
            errs = sampler_step_errors(case, lambda *a: ss.inter_layer(*a, bf16=case["bf16"]),
                                       lambda *a: ss.step(*a, bf16=case["bf16"]))
            bad = sorted(n for n, e in errs.items() if not e <= SAMPLER_STEP_TOL[n])
            log(json.dumps({"check": "sampler_step", "mode": mode, "k": k, "max_abs_err": errs,
                            "ok": not bad}))
            if bad:
                raise AssertionError(f"sampler_step {mode} k={k}: {bad} disagree with the plain "
                                     f"version")
            worst = max(worst, max(errs.values()))
    return worst


def work_of_sampler_step(case: dict) -> dict:
    """{kernel: (FLOP, bytes)} of one launch of each sampler step kernel on
    ``case``'s inputs: each input element read once, each output element
    written once (the rows it writes), the projection's MACs as 2 FLOP."""
    inner, q1, t1, wj_t, h2, aj2, qj2, tj2 = case["inter"]
    (k, xs, sched, q, t, tors, q_p, t_p, tors_p, draws, h1, aj_static, wj_time, aj1, qj1, tj1,
     ticket) = case["step"]
    R, H = inner.shape[0] * inner.shape[1], inner.shape[2]
    T = aj2.shape[2]
    inter = (2 * R * H * T, 4 * (R * H + R * 7 + H * T + R * H + R * T + R * 7))
    state = q.numel() + t.numel() + tors.numel()
    step = (0, 4 * (2 * state + state + sum(d.numel() for d in draws[:3]) + 6 + 1 + T
                    + aj_static.numel() + R * T + R * 7 + R) + 8 + 4)
    return {"inter": inter, "step": step}


def sampler_step_times(model, dev, launches: int, err: float, card: str) -> dict:
    """Phase 5: each sampler step kernel's ms per launch (``time_ms``) at
    batch 64 beside its plain version's (captured the same way) and its
    bound (the bytes at 3.35 TB/s; the projection's FLOP at the fp32 peak
    are below it); the kernels line's row, their sums per step."""
    from pmhc_tpu_torch.ops import _build
    from pmhc_tpu_torch.ops import sampler_step as ss
    from pmhc_tpu_torch.tools.flops import PEAK_BYTES, PEAK_FP32

    import torch

    lib = ss._lib()
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731 (a capture's own)
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name in ("inter", "step"):
        # a fresh chain at k = 0 for each side: 203 kernel and 23 plain steps, all below T
        case, plain = (sampler_step_case(model, seed=40, device=dev) for _ in range(2))
        if name == "inter":
            ms = time_ms(lambda: ss.launch_inter(lib, *case["inter"], bf16=False, stream=cur()), 100)
            plain_ms = time_ms(lambda: ss.inter_layer_plain(*plain["inter"]), 10)
        else:
            ms = time_ms(lambda: ss.launch_step(lib, *case["step"], stream=cur()), 100)
            plain_ms = time_ms(lambda: ss.step_plain(*plain["step"][:-1]), 10)
        flops, nbytes = work_of_sampler_step(case)[name]
        bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3
        log(json.dumps({"metric": "sampler_step_ms", "kernel": name, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes", "mbytes": nbytes / 1e6,
                        "mflop": flops / 1e6, "card": card}))
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound_ms
    return {"name": "sampler_step", "route": "cuda", "source": "pmhc_tpu_torch/csrc/sampler_step.cu",
            "replaces": None,  # XLA's fusions of sample_lane's scan body
            "launches": launches, "max_abs_err": err, **row, "bound_by": "bytes",
            "library_ms": None, "digest": _build.digest("sampler_step")}


# tensor-core FLOP of one SASS instruction: mma.sync m16n8k16 (HMMA.16816)
# and m16n8k8 (HMMA.1688); a wgmma m64nNk16 (HGMMA.64xNx16) is 2,048 N
HMMA_FLOP = {"16816": 2 * 16 * 8 * 16, "1688": 2 * 16 * 8 * 8}


def build_entries(info: dict, kind_of) -> dict:
    """``ptxas_entries`` of a built library, each with its tensor-core
    instructions in the library's SASS (``cuobjdump -sass``): ``hmma`` (the
    count of HMMA, mma.sync), ``hgmma`` ({N: count} of HGMMA.64xNx16,
    wgmma) and ``tc_flop`` (their FLOP, ``HMMA_FLOP`` and 2,048 N)."""
    res = ptxas_entries(info["log"], kind_of)
    for r in res.values():
        r.update(hmma=0, hgmma={}, tc_flop=0)
    sass = subprocess.run([cuobjdump_path(), "-sass", info["path"]], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    cur = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = kind_of(m.group(1))
            continue
        if not cur:
            continue
        m = re.search(r"\bHMMA\.(\d+)", ln)
        if m:
            if m.group(1) not in HMMA_FLOP:
                raise AssertionError(f"unknown HMMA shape in {cur}: {ln.strip()}")
            res[cur]["hmma"] += 1
            res[cur]["tc_flop"] += HMMA_FLOP[m.group(1)]
        m = re.search(r"\bHGMMA\.64x(\d+)x16\b", ln)
        if m:
            n = int(m.group(1))
            res[cur]["hgmma"][n] = res[cur]["hgmma"].get(n, 0) + 1
            res[cur]["tc_flop"] += 2 * 64 * n * 16
    return res


# the kernels' template argument per mode (csrc/egnn_common.cuh), as it
# appears in a mangled instantiation name (``egnn_fused_kernelILi2E...``)
MODE_ARGS = {"fp32": "0", "bf16": "1", "high": "2"}


def check_modes(res: dict, who: str, prefix: str = "") -> None:
    """The tensor-core rule of one kernel's three instantiations, in the
    tensor-core FLOP of their SASS (``build_entries``): fp32 has none (no
    TF32 either), bf16 some, and high, whose every tensor-core product is
    three passes over split operands on wgmma, HGMMA and no HMMA: each
    product issued as three passes, so each HGMMA shape comes a multiple of
    three times, and at least 2.5 times bf16's FLOP. Its static count
    measures code, not work, and its loops unroll otherwise than bf16's
    mma.sync tiles (the high kernels unroll a 64-row slab's four heads; the
    bf16 ones a head task's k-step), so no upper bound carries over.
    Neither fp32 nor bf16 under another name. None may spill."""
    fp32, bf16, high = (res[prefix + m]["tc_flop"] for m in ("fp32", "bf16", "high"))
    wgmma = res[prefix + "high"].get("hgmma") or {}
    hmma_high = res[prefix + "high"]["hmma"]
    ok_high = bool(wgmma) and not hmma_high and all(c % 3 == 0 for c in wgmma.values()) and high >= 2.5 * bf16
    if fp32 or not bf16 or not ok_high:
        raise AssertionError(f"{who}: tensor-core FLOP fp32 {fp32} (must be 0), bf16 {bf16} (> 0), high {high} "
                             f"(HGMMA by N {wgmma}, each a multiple of 3, at least 2.5x bf16; HMMA {hmma_high}, "
                             f"must be 0): {res}")
    if any(res[prefix + m]["spill_bytes"] for m in MODE_ARGS):
        raise AssertionError(f"{who} spills registers: {res}")


def check_loop_build(info: dict) -> dict:
    """Phase 2, the loop kernels' six instantiations (forward and backward,
    ``<0>`` fp32, ``<1>`` bf16, ``<2>`` high: on wgmma, HGMMA): registers
    and spills from ``ptxas -v`` and the tensor-core instructions in the
    SASS, held to ``check_modes``. Returns {kind: {"registers",
    "spill_bytes", "smem_bytes", "hmma", "hgmma", "tc_flop"}}."""
    def kind_of(name):
        for kind in ("fwd", "bwd"):
            for mode, arg in MODE_ARGS.items():
                if f"egnn_loop_{kind}_kernelILi{arg}E" in name:
                    return f"{kind}_{mode}"
        return None

    res = build_entries(info, kind_of)
    log(f"build egnn_loop instantiations: {json.dumps(res)}")
    kinds = {f"{k}_{m}" for k in ("fwd", "bwd") for m in MODE_ARGS}
    if set(res) != kinds or any(r["registers"] is None for r in res.values()):
        raise AssertionError(f"egnn_loop: ptxas did not report all six instantiations: {res}")
    for k in ("fwd", "bwd"):
        check_modes(res, f"egnn_loop {k}", prefix=f"{k}_")
    return res


def check_fused_build(info: dict) -> dict:
    """Phase 2, the fused kernel's three instantiations (``<0>`` fp32,
    ``<1>`` bf16, ``<2>`` high: on wgmma, HGMMA): registers and spills from
    ``ptxas -v``, and the tensor-core instructions in the built library's
    SASS, held to ``check_modes``. Returns {mode: {"registers",
    "spill_bytes", "smem_bytes", "hmma", "hgmma", "tc_flop"}}."""
    def mode_of(name):
        for mode, arg in MODE_ARGS.items():
            if f"egnn_fused_kernelILi{arg}E" in name:
                return mode
        return None

    res = build_entries(info, mode_of)
    log(f"build egnn_fused instantiations: {json.dumps(res)}")
    if set(res) != set(MODE_ARGS) or any(r["registers"] is None for r in res.values()):
        raise AssertionError(f"egnn_fused: ptxas did not report all three instantiations: {res}")
    check_modes(res, "egnn_fused")
    return res


def gemm_ms(args, mode: str) -> float:
    """ms of one ``torch.matmul`` of [B*N*NP, T] @ [T, 4T] in the mode's
    precision (fp32 without TF32, or bf16; high: three bf16 ones, its
    split's passes): the dominant product of the fused layer and of the
    loop forward alone, a yardstick the port never calls. ``args``:
    either's inputs (a_j at 5, the mask at 9)."""
    import torch

    _, h, _, _, _, a_j, _, _, _, mask = args
    T = a_j.shape[-1]
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    g = torch.Generator(device=h.device).manual_seed(0)
    x = torch.randn((mask.numel(), T), generator=g, device=h.device).to(dtype)
    wt = torch.randn((T, 4 * T), generator=g, device=h.device).to(dtype)
    passes = 3 if mode == "high" else 1
    return time_ms(lambda: [torch.matmul(x, wt) for _ in range(passes)], iters=100)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """ms per call of ``fn`` on the card: ``iters`` calls captured in one
    CUDA graph (after ``warmup`` eager calls on a side stream), the graph's
    replay timed between CUDA events. A replay launches the captured
    kernels only, so a wrapper's host work (checks, allocations, the
    ctypes call) is not in the time. ``fn`` launches on the current
    stream at call time; the launch counters do not move."""
    import torch

    from pmhc_tpu_torch.utils.graphs import capture, warm_up

    for _ in range(warmup):
        warm_up(fn)
    graph = capture(lambda: [fn() for _ in range(iters)]).graph
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(run) -> dict:
    """Where the device work of ``run()`` goes: timed on the host clock,
    then run again under ``torch.profiler`` for the device time of each
    kernel. The idle share is 1 - busy / the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            by_kernel[e.key[:60]] = by_kernel.get(e.key[:60], 0.0) + us / 1e3
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms,
            # None: the profiler saw no device time (not measured)
            "device_busy_ms": busy_ms or None,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top_kernels_ms": dict(top)}


def loop_times(cases, loop_err, train_launches, card: str) -> list:
    """Phase 5, loop kernels: ms per launch (CUDA events) of each kernel and
    mode beside its plain version and its bound, averaged over the two
    layer shapes; returns their rows of the kernels line."""
    import numpy as np
    import torch

    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops.egnn_fused import FLAGS

    lib = el._lib()
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731 (a capture's own)
    rows = []
    for kind in ("fwd", "bwd"):
        for mode in MODES:
            bf16 = FLAGS[mode]
            per = {"ms": [], "plain_ms": [], "bound_ms": [], "gemm_ms": []}
            bound_by = None
            for layer, (args, cts) in cases.items():
                m = el.launch_fwd(lib, *args, bf16=bf16, stream=cur())[0]
                gemm = None
                if kind == "fwd":
                    ms = time_ms(lambda: el.launch_fwd(lib, *args, bf16=bf16, stream=cur()), 50)
                    with torch.no_grad():
                        plain = time_ms(lambda: el.egnn_loop_plain(*args, bf16=bf16), 5)
                    gemm = gemm_ms(args, mode)
                    per["gemm_ms"].append(gemm)
                else:
                    ms = time_ms(lambda: el.launch_bwd(lib, *args, m, cts, bf16=bf16, stream=cur()), 20)
                    plain = time_ms(lambda: loop_run(args, cts, bf16, kernel=False), 3)
                flops, nbytes, bound_ms, bound_by = work_of_loop(args, m, cts, kind, mode)
                log(json.dumps({"metric": f"egnn_loop_{kind}_ms", "mode": mode, "layer": layer,
                                "ms": ms, "plain_ms": plain, "gemm_ms": gemm, "bound_ms": bound_ms,
                                "bound_by": bound_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                                "tflops": flops / ms / 1e9, "card": card}))
                per["ms"].append(ms)
                per["plain_ms"].append(plain)
                per["bound_ms"].append(bound_ms)
            name = f"{kind}_{mode}"
            row = {
                "name": f"egnn_loop_{name}", "route": "cuda",
                "source": "pmhc_tpu_torch/csrc/egnn_loop.cu", "replaces": LOOP_REPLACES[name],
                "launches": train_launches[mode][name], "max_abs_err": loop_err[mode][kind],
                "ms": float(np.mean(per["ms"])), "plain_ms": float(np.mean(per["plain_ms"])),
                "bound_ms": float(np.mean(per["bound_ms"])), "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes the loop
            }
            if per["gemm_ms"]:  # the forward's dominant product alone, a yardstick
                row["gemm_ms"] = float(np.mean(per["gemm_ms"]))
            rows.append(row)
    return rows


def train_breakdown(mode: str, graphs: bool) -> dict:
    """Device time by kernel and idle share over 10 batch-64 training steps
    in the mode, from CUDA graphs or eager (after 3 warm-up steps), and the
    median host-clock wall of TRAIN_STEPS steps, each ended by a
    synchronize."""
    import torch

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    tr = Trainer(ScoreNetworkConfig(backend="auto"), train_config=TrainConfig(seed=9, nan_check_every=0),
                 bf16=mode == "bf16", fast_f32=mode == "high", graphs=graphs)
    batches = [synthetic_batch(batch_size=B, seed=700 + k) for k in range(TRAIN_STEPS)]
    for b in batches[:3]:
        tr.train_batch(b)
    walls = []
    for b in batches:
        t0 = time.monotonic()
        tr.train_batch(b)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)

    def run():
        for b in batches[:10]:
            tr.train_batch(b)

    return {**device_breakdown(run), "median_step_s": sorted(walls)[len(walls) // 2],
            "step_s": walls}


def overlap_walls(model, entries, card: str, batches: int = 3) -> None:
    """Phase 5: the sample CLI's loop (batch i's PDBs serialized while batch
    i+1 samples) over ``batches`` batch-64 T=1000 fp32 trajectories from
    graphs (``sampler.STEPS_PER_GRAPH`` steps each): the whole wall, and per
    batch the seconds until ``dispatch`` handed back to the host, then
    waited for the batch's arrays, then in PDB text."""
    from pmhc_tpu_torch.diffusion import sampler
    from pmhc_tpu_torch.serve import SamplerService

    svc = SamplerService(model, batch_size=B, noise_step_count=STEPS, seed=7)
    svc.warmup()  # the capture
    stats, pending = [], None
    t_start = time.monotonic()
    for i in range(batches + 1):
        t0 = time.monotonic()
        handle = svc.dispatch(entries, svc.batch_generator(i)) if i < batches else None
        dispatch_s = time.monotonic() - t0
        if pending is not None:
            t1 = time.monotonic()
            pending.wait()
            t2 = time.monotonic()
            svc.finalize(pending)
            stats[-1].update(wait_s=t2 - t1, pdb_s=time.monotonic() - t2)
        if handle is not None:
            stats.append({"dispatch_s": dispatch_s})
        pending = handle
    log(json.dumps({"metric": "overlap_walls", "steps_per_graph": sampler.STEPS_PER_GRAPH,
                    "batch": B, "steps": STEPS, "batches": batches,
                    "wall_s": time.monotonic() - t_start, "per_batch": stats, "card": card}))


def trajectory_check(model, dev, backend: str, mode: str = "fp32") -> None:
    """Phase 4: a 4-step batch-4 trajectory through ``backend``'s kernel in
    ``mode`` held against the dense oracle with the same injected noise;
    the kernel must run 2 launches per step."""
    import torch

    from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
    from pmhc_tpu_torch.diffusion import DiffusionConfig, gen_noise, sample
    from pmhc_tpu_torch.geometry import RigidArray
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    cfg4 = DiffusionConfig(noise_step_count=4)
    nb = synthetic_batch(batch_size=4, seed=5)
    nb["mask"][1, 4:] = False  # a short peptide: fully masked rows
    mb = prepare_batch(nb, dev)
    g = torch.Generator(device=dev).manual_seed(11)
    start = gen_noise(g, (4, 16), cfg4)
    mb["frames"], mb["torsions"] = start["frames"], start["torsions"]
    inj = [gen_noise(g, (4, 16), cfg4) for _ in range(4)]
    inj = {"frames": RigidArray(torch.stack([n["frames"].quats for n in inj]),
                                torch.stack([n["frames"].trans for n in inj])),
           "torsions": torch.stack([n["torsions"] for n in inj])}
    counter = {"fused": ef.LAUNCHES, "pallas": ep.LAUNCHES}[backend]
    before = counter[mode]
    traj = {bk: sample(model, mb, cfg4, ScoreNetworkConfig(noise_step_count=4, backend=bk),
                       bf16=ef.FLAGS[mode], injected_noise=inj) for bk in (backend, "dense")}
    torch.cuda.synchronize()
    if counter[mode] - before != 2 * 4:
        raise AssertionError(f"{backend} {mode} trajectory: {counter[mode] - before} launches, "
                             "expected 8")
    for name, get in (("q", lambda r: r["frames"].quats), ("t", lambda r: r["frames"].trans),
                      ("tors", lambda r: r["torsions"])):
        err = float((get(traj[backend]) - get(traj["dense"])).abs().max())
        log(f"trajectory {backend} {mode} vs dense {name}: max_abs_err {err:.3e} "
            f"(tol {TRAJ_TOL[name]:.0e})")
        if not err <= TRAJ_TOL[name]:
            raise AssertionError(f"4-step {backend} {mode} trajectory {name} disagrees with the dense "
                                 "oracle")


def check_pallas_kernel(cases) -> float:
    """Phase 3, kernel #3: through the main path's entry (the layer's
    ``PallasContext``) against its plain version at batch 64, both layer
    shapes, fp32 tolerances (``PALLAS_TOL``). Returns the max abs error."""
    import torch

    from pmhc_tpu_torch.ops import egnn_pallas as ep

    worst = 0.0
    for layer, (ctx, step) in cases.items():
        got = ctx(*step)
        want = ep.egnn_pallas_plain(*ctx.inputs(*step))
        torch.cuda.synchronize()
        masked = int((ctx.msg_mask.sum(-1) == 0).sum())
        for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
            err = float((g - w).abs().max())
            ok = err <= PALLAS_TOL[name] and bool(torch.isfinite(g).all())
            log(f"check pallas {layer} {name}: max_abs_err {err:.3e} (tol {PALLAS_TOL[name]:.0e}; "
                f"{masked} fully masked rows) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel #3 {layer} {name} disagrees with its plain version")
            worst = max(worst, err)
    return worst


def split_models(pdb: bytes):
    """The models of a multi-MODEL PDB, each as a PDB ending in END."""
    bodies, cur = [], None
    for ln in pdb.decode().splitlines(keepends=True):
        if ln.startswith("MODEL "):
            cur = []
        elif ln.startswith("ENDMDL"):
            bodies.append(("".join(cur) + "END\n").encode())
            cur = None
        elif cur is not None:
            cur.append(ln)
    return bodies


def http_main_path(model, card: str):
    """Phase 4, serving over HTTP: the port's ``serve_cli.create_server`` on
    127.0.0.1 with ``--backend pallas --batch-size 64 -T 1000``, loading a
    ``.pth`` written from ``model``; ``/healthz``, 3 concurrent requests,
    one ``?samples=4``, then 64 concurrent requests that fill one batch.
    Every PDB must parse, kernel #3 must run 2 x 1000 times per dispatched
    batch and the fused kernel not at all. Returns the launches of the
    64-request batch and its wall seconds (request in, PDB out)."""
    import http.client
    import io
    import tempfile
    import threading

    import numpy as np
    import torch

    from pmhc_tpu_torch.cli.serve_cli import build_parser, create_server
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    def post(host, port, entry, query=""):
        buf = io.BytesIO()
        np.savez(buf, **entry)
        conn = http.client.HTTPConnection(host, port, timeout=600)
        conn.request("POST", "/sample" + query, buf.getvalue())
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        if resp.status != 200:
            raise AssertionError(f"POST /sample{query}: HTTP {resp.status} {body[:200]!r}")
        return body

    def concurrent(host, port, entries):
        out = [None] * len(entries)
        errors = []

        def client(k):
            try:
                out[k] = post(host, port, entries[k])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(len(entries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.pth")
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
        args = build_parser().parse_args([
            path, "--host", "127.0.0.1", "--port", "0", "--backend", "pallas",
            "--batch-size", str(B), "-T", str(STEPS), "--max-wait-ms", "2000", "--seed", "7"])
        torch.cuda.synchronize()
        ef.reset_launches()
        ep.reset_launches()
        t0 = time.monotonic()
        server = create_server(args)  # warm-up: one batch
        log(f"main path http: server up in {time.monotonic() - t0:.1f} s, warm-up launches "
            f"{ep.LAUNCHES['fp32']} (expected {2 * STEPS})")
        if ep.LAUNCHES["fp32"] != 2 * STEPS:
            raise AssertionError(f"http warm-up: {ep.LAUNCHES['fp32']} kernel #3 launches")
    batcher = server.batcher
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    try:
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        conn.close()
        log(f"main path http: GET /healthz {resp.status} {json.dumps(health)}")
        if resp.status != 200 or health["backend"] != "pallas" or health["batch_size"] != B \
                or health["precision"] != "f32":
            raise AssertionError(f"/healthz: {resp.status} {health}")
        entries3 = [request_entry(seed=300 + i) for i in range(3)]
        entries64 = [request_entry(seed=400 + i) for i in range(B)]
        results = {}
        for label, run, entries in (
                ("3 concurrent requests", lambda: concurrent(host, port, entries3), entries3),
                ("?samples=4", lambda: split_models(post(host, port, entries3[0], "?samples=4")),
                 [entries3[0]] * 4),
                (f"{B} concurrent requests", lambda: concurrent(host, port, entries64), entries64)):
            torch.cuda.synchronize()
            ef.reset_launches()
            ep.reset_launches()
            n0 = batcher.batches
            t0 = time.monotonic()
            pdbs = run()
            wall = time.monotonic() - t0
            batches = batcher.batches - n0
            count = ep.LAUNCHES["fp32"]
            log(f"main path http {label}: {len(pdbs)} PDBs in {wall:.2f} s, {batches} batches, "
                f"kernel #3 launches {count} (expected {2 * STEPS * batches}), fused "
                f"{sum(ef.LAUNCHES.values())}")
            if count != 2 * STEPS * batches or batches < 1 or any(ef.LAUNCHES.values()):
                raise AssertionError(f"http {label}: {count} launches for {batches} batches")
            if len(pdbs) != len(entries):
                raise AssertionError(f"http {label}: {len(pdbs)} PDBs for {len(entries)} requests")
            for pdb, e in zip(pdbs, entries):
                check_pdb(pdb, e)
            results[label] = (count, batches, wall)
    finally:
        server.shutdown()
        thread.join(timeout=60)
        batcher.close()
        server.server_close()
    count, batches, wall = results[f"{B} concurrent requests"]
    if batches != 1:
        raise AssertionError(f"{B} concurrent requests took {batches} batches, expected one")
    log(json.dumps({"metric": "http_batch_s", "backend": "pallas", "batch": B, "steps": STEPS,
                    "seconds": wall, "card": card}))
    return count, wall


def trainer_pallas_check(dev, card: str, steps: int = 5):
    """Phase 4, training with the ``pallas`` backend: ``Trainer`` at batch 64
    takes ``steps`` steps held against a ``Trainer`` on the dense autograd
    path from the same seed (weights, timesteps, noise), with kernel #3's
    counter reset just before; it must launch twice per step. Then the
    wall per step of both and the device breakdown of ``steps`` more
    ``pallas`` steps. Returns the launches."""
    import torch

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    trainers = {bk: Trainer(ScoreNetworkConfig(backend=bk), train_config=TrainConfig(
        seed=11, learning_rate=TRAIN_LR, nan_check_every=0)) for bk in ("pallas", "dense")}
    batches = [synthetic_batch(batch_size=B, seed=600 + k) for k in range(steps)]
    torch.cuda.synchronize()
    ep.reset_launches()
    el.reset_launches()
    losses, walls = {}, {}
    for bk, tr in trainers.items():
        losses[bk], walls[bk] = [], []
        for b in batches:
            t0 = time.monotonic()
            losses[bk].append(float(tr.train_batch(b)["total loss"]))  # float() syncs
            walls[bk].append(time.monotonic() - t0)
    torch.cuda.synchronize()
    count = ep.LAUNCHES["fp32"]
    log(f"main path train pallas: {steps} steps, kernel #3 launches {count} (expected {2 * steps}), "
        f"loop kernels {sum(el.LAUNCHES.values())}")
    if count != 2 * steps or any(el.LAUNCHES.values()):
        raise AssertionError(f"train pallas: {count} kernel #3 launches, expected {2 * steps}")
    for step, (a, b) in enumerate(zip(losses["pallas"], losses["dense"])):
        rel = abs(a - b) / abs(b)
        log(f"train pallas step {step}: loss kernel {a:.6f} dense {b:.6f} rel {rel:.2e} "
            f"(rtol {TRAIN_TOL['loss_rtol']:.0e})")
        if not rel <= TRAIN_TOL["loss_rtol"]:
            raise AssertionError(f"pallas training step {step}: loss disagrees with the dense path")
    worst, worst_name = 0.0, ""
    for (name, p), q in zip(trainers["pallas"].model.named_parameters(),
                            trainers["dense"].model.parameters()):
        diff = float((p.detach() - q.detach()).abs().max())
        if diff > worst:
            worst, worst_name = diff, name
    log(f"train pallas parameters after {steps} steps: max abs diff {worst:.2e} ({worst_name}; "
        f"tol {TRAIN_TOL['param_atol']:.0e})")
    if not worst <= TRAIN_TOL["param_atol"]:
        raise AssertionError(f"pallas training: parameter {worst_name} off by {worst:.2e}")
    log(json.dumps({"metric": "train_step_s", "backend": "pallas", "batch": B, "steps": steps,
                    "seconds": walls["pallas"], "dense_seconds": walls["dense"], "card": card}))

    def run():
        for b in batches:
            trainers["pallas"].train_batch(b)

    log(json.dumps({"metric": "device_breakdown", "path": "train", "backend": "pallas",
                    "batch": B, "steps": steps, **device_breakdown(run), "card": card}))
    return count


def pack_realistic(path: str, n_entries: int, seed: int) -> int:
    """Write ``n_entries`` realistic entries from ``seed`` as a packed
    ``.npz`` (no HDF5 on the card's machine); returns its size in bytes."""
    from pmhc_tpu_torch.data.realistic import realistic_packed

    realistic_packed(n_entries, seed).save(path)
    return os.path.getsize(path)


def csv_rows(path: str) -> list:
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def offline_train(args: list, want: dict, card: str, mode: str) -> dict:
    """One ``train_cli.main`` run with the loop kernels' counters reset just
    before; their counts must equal ``want`` (a mode left out: none).
    Returns the CLI's epoch stats."""
    import torch

    from pmhc_tpu_torch.cli import train_cli
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    torch.cuda.synchronize()
    el.reset_launches()
    ef.reset_launches()
    ep.reset_launches()
    t0 = time.monotonic()
    stats = train_cli.main(args + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = dict(el.LAUNCHES)
    want = {k: want.get(k, 0) for k in counts}
    log(f"offline train {mode}: {len(stats['epochs'])} epochs in {wall:.1f} s, loop launches "
        f"{counts} (expected {want})")
    if counts != want or any(ef.LAUNCHES.values()) or any(ep.LAUNCHES.values()):
        raise AssertionError(f"offline train {mode}: launches {counts}, expected {want}")
    for e in stats["epochs"]:
        log(json.dumps({"metric": "train_cli_epoch", "mode": mode, "batch": B, **e, "card": card}))
    return stats


def offline_sample(args: list, ds, out: str, mode: str, n_files: int, want: int, card: str):
    """One ``sample_cli.main`` run with the fused kernel's counters reset just
    before: exactly ``want`` launches in ``mode``, none in another, and
    ``n_files`` PDBs that pass ``check_pdb``."""
    import torch

    from pmhc_tpu_torch.cli import sample_cli
    from pmhc_tpu_torch.ops import egnn_fused as ef

    torch.cuda.synchronize()
    ef.reset_launches()
    t0 = time.monotonic()
    stats = sample_cli.main(args + ["--output-dir", out, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    others = {k: v for k, v in ef.LAUNCHES.items() if k != mode}
    files = sorted(os.listdir(out))
    log(f"offline sample {mode} {' '.join(args[2:])}: {len(files)} PDBs in {wall:.1f} s, fused "
        f"launches {ef.LAUNCHES[mode]} (expected {want}), other modes {others}")
    if ef.LAUNCHES[mode] != want or any(others.values()) or stats["precision"] != PRECISION[mode]:
        raise AssertionError(f"offline sample {mode}: launches {dict(ef.LAUNCHES)}, expected {want}")
    if len(files) != n_files:
        raise AssertionError(f"offline sample {mode}: {len(files)} PDB files, expected {n_files}")
    index = {n: i for i, n in enumerate(ds.entry_names)}
    for f in files:
        name = f.split(".")[0]
        entry = {"mask": ds[index[name]]["mask"], **ds.get_protein_positions([name])}
        entry = {k: v[0] if k.startswith("protein_") else v for k, v in entry.items()}
        with open(os.path.join(out, f), "rb") as fh:
            check_pdb(fh.read(), entry)
    # end to end: the whole call's wall and PDBs/s; per batch: its breakdown
    log(json.dumps({"metric": "sample_cli", "mode": mode, "args": " ".join(args[2:]),
                    "batch_size": B, "wall_s": stats["wall_s"], "pdbs": stats["pdbs"],
                    "pdbs_per_s": stats["pdbs_per_s"], "card": card}))
    for b in stats["batches"]:
        log(json.dumps({"metric": "sample_cli_batch", "mode": mode, "batch_size": B, **b,
                        "card": card}))
    return stats


def offline_main_path(card: str, work: str) -> dict:
    """Phase 4b: the offline entry points through ``main([...])`` of each CLI
    on the card, at batch 64, T = 1000 and the published width, on packed
    files of realistic entries built here (no HDF5) in ``work``. Returns
    the fp32 ``train_cli`` run's ``.pth`` and the 67-entry test file."""
    import math

    from pmhc_tpu_torch.data import PackedDataset
    from pmhc_tpu_torch.train import CheckpointManager

    t_phase = time.monotonic()
    paths = {}
    t0 = time.monotonic()
    for name, (n, seed) in OFFLINE_SETS.items():
        paths[name] = os.path.join(work, f"{name}.npz")
        size = pack_realistic(paths[name], n, seed)
        log(f"offline data {name}.npz: {n} realistic entries (seed {seed}), {size} bytes "
            f"({size / n / 1e3:.1f} KB an entry)")
    log(f"offline data built in {time.monotonic() - t0:.1f} s")
    steps = OFFLINE_SETS["train"][0] // B  # per epoch
    val_batches = -(-OFFLINE_SETS["val"][0] // B)

    # -- fp32: 2 epochs with validation (raw and EMA weights), then a resume
    model = os.path.join(work, "model.pth")
    ckdir = os.path.join(work, "ck")
    cmd = [paths["train"], "2", model, "--batch-size", str(B), "--val-hdf5", paths["val"],
           "--ema-decay", "0.999", "--orbax-dir", ckdir]
    fwd = 2 * steps * 2 + 2 * 2 * val_batches * 2  # layers x steps + layers x epochs x batches x weights
    stats = {"fp32": offline_train(cmd, {"fwd_fp32": fwd, "bwd_fp32": 2 * 2 * steps,
                                         "fwd_bf16": 0, "bwd_bf16": 0}, card, "fp32")}
    for suffix, rows in ((".pth", None), (".ema.pth", None), (".csv", 2), (".val.csv", 2),
                         (".val.ema.csv", 2)):
        path = model.replace(".pth", suffix)
        if not os.path.isfile(path):
            raise AssertionError(f"offline train: {path} missing")
        if rows is not None:
            got = csv_rows(path)
            bad = [r for r in got for k, v in r.items() if k != "epoch" and not math.isfinite(float(v))]
            log(f"offline train {os.path.basename(path)}: {len(got)} rows, last {got[-1]}")
            if len(got) != rows or bad:
                raise AssertionError(f"{path}: {len(got)} rows (expected {rows}), non-finite {bad}")
    offline_train(cmd[:1] + ["1"] + cmd[2:], {"fwd_fp32": 2 * steps + 2 * val_batches * 2,
                                              "bwd_fp32": 2 * steps, "fwd_bf16": 0,
                                              "bwd_bf16": 0}, card, "fp32 resume")
    latest = CheckpointManager(ckdir).latest_step()
    rows = len(csv_rows(model.replace(".pth", ".csv")))
    log(f"offline train resume: CSV {rows} rows, latest checkpoint step {latest} "
        f"(restored at {2 * steps}, then {steps} steps)")
    if rows != 3 or latest != 3 * steps:
        raise AssertionError(f"offline resume: CSV {rows} rows, checkpoint step {latest}")

    # -- bf16, the dataset resident on the card, 4 steps per call
    # 2 epochs: the first captures the step's graph, the second only replays
    bf16_cmd = [paths["train"], "2", os.path.join(work, "model_bf16.pth"), "--batch-size",
                str(B), "--bf16", "--device-data", "--steps-per-dispatch", "4"]
    bf16_want = {"fwd_fp32": 0, "bwd_fp32": 0, "fwd_bf16": 2 * 2 * steps,
                 "bwd_bf16": 2 * 2 * steps}
    stats["bf16"] = offline_train(bf16_cmd, bf16_want, card, "bf16")
    # the same epoch eager (a fresh model: the output file is removed)
    os.remove(bf16_cmd[2])
    stats["bf16 eager"] = offline_train(bf16_cmd + ["--eager"], bf16_want, card, "bf16 eager")
    # -- fast-f32: one epoch of the default path (the loader, graphs)
    stats["fast-f32"] = offline_train(
        [paths["train"], "1", os.path.join(work, "model_high.pth"), "--batch-size", str(B),
         "--fast-f32"], {"fwd_high": 2 * steps, "bwd_high": 2 * steps}, card, "fast-f32")
    if stats["fast-f32"]["precision"] != "fast-f32":
        raise AssertionError(f"offline train --fast-f32 ran {stats['fast-f32']['precision']}")
    for mode in ("fp32", "bf16", "bf16 eager", "fast-f32"):
        log(json.dumps({"metric": "train_cli", "mode": mode, "batch": B,
                        "epoch_s": [e["seconds"] for e in stats[mode]["epochs"]],
                        "examples_per_s": [e["examples_per_s"] for e in stats[mode]["epochs"]],
                        "loader_wait_s": [e["loader_wait_s"] for e in stats[mode]["epochs"]],
                        "card": card}))

    # -- sampling: 67 entries = a full batch and a short batch of 3
    test = PackedDataset.load(paths["test"])
    n_test = len(test)
    n_batches = -(-n_test // B)
    for mode, extra in (("fp32", []), ("bf16", ["--bf16"]), ("high", ["--fast-f32"]),
                        ("fp32", ["--eager"])):
        offline_sample([model, paths["test"], "-b", str(B)] + extra, test,
                       os.path.join(work, f"sampled_{mode}{''.join(extra)}"), mode, n_test,
                       n_batches * STEPS * 2, card)
    k = OFFLINE_SAMPLE_STEPS
    offline_sample([model, paths["test"], "-b", str(B), "--bf16", "--num-samples", "2",
                    "--sample-steps", str(k)], test, os.path.join(work, f"sampled_k{k}"),
                   "bf16", 2 * n_test, n_batches * k * 2 * 2, card)
    log(json.dumps({"metric": "offline_phase_s", "seconds": time.monotonic() - t_phase,
                    "card": card}))
    return {"model": model, "test": paths["test"]}


def tool_launches(run, label: str, want):
    """``run()`` (a tool's ``main``) with every kernel counter reset just
    before; the counts after must equal ``want`` ({"fused": {mode: n},
    "pallas": n, "loop": {key: n}}; a counter left out: 0), or what
    ``want(out)`` gives for ``run``'s output ``out``. Returns ``out``."""
    import torch

    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    torch.cuda.synchronize()
    for mod in (ef, el, ep):
        mod.reset_launches()
    t0 = time.monotonic()
    printed = io.StringIO()  # the tool's own lines; logged below as metrics
    try:
        with contextlib.redirect_stdout(printed):
            out = run()
    except BaseException:
        print(printed.getvalue(), flush=True)
        raise
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    want = want(out) if callable(want) else want
    got = {"fused": dict(ef.LAUNCHES), "pallas": sum(ep.LAUNCHES.values()), "loop": dict(el.LAUNCHES)}
    expect = {"fused": {k: want.get("fused", {}).get(k, 0) for k in ef.LAUNCHES},
              "pallas": want.get("pallas", 0),
              "loop": {k: want.get("loop", {}).get(k, 0) for k in el.LAUNCHES}}
    log(f"tools {label}: {wall:.1f} s, launches {got}")
    if got != expect:
        raise AssertionError(f"tools {label}: launches {got}, expected {expect}")
    return out


def tools_main_path(card: str, model: str, test: str) -> None:
    """Phase 4c: the tool twins (``pmhc_tpu_torch/tools/``) through their
    ``main([...])`` on the card, on phase 4b's trained ``.pth`` and 67-entry
    test file, each with its kernel launches checked exactly."""
    import math

    from pmhc_tpu_torch.tools import bench_sampler, bench_serve, bench_train, eval_rmsd, flops
    from pmhc_tpu_torch.tools import rmsd_backends

    t_phase = time.monotonic()
    n_test = OFFLINE_SETS["test"][0]
    batches = -(-n_test // B)
    # eval_rmsd: 2 launches a step and batch, in the mode asked for
    for mode, extra in (("fp32", []), ("bf16", ["--bf16"]), ("high", ["--fast-f32"]),
                        ("pallas", ["--backend", "pallas"])):
        want = ({"pallas": 2 * STEPS * batches} if mode == "pallas"
                else {"fused": {mode: 2 * STEPS * batches}})
        rep = tool_launches(lambda: eval_rmsd.main([model, test, "-T", str(STEPS), "-b", str(B),
                                                    "--device", "cuda"] + extra),
                            f"eval_rmsd {mode}", want)
        bad = [n for n, r in rep["per_entry"].items() if not math.isfinite(r)]
        if rep["entries"] != n_test or bad or not math.isfinite(rep["mean_pure_noise_rmsd"]):
            raise AssertionError(f"eval_rmsd {mode}: {rep['entries']} entries, non-finite {bad}")
        if rep["precision"] != PRECISION["fp32" if mode == "pallas" else mode]:
            raise AssertionError(f"eval_rmsd {mode} ran {rep['precision']}")
        log(json.dumps({"metric": "eval_rmsd", "mode": mode, "backend": rep["backend"],
                        "entries": rep["entries"], "T": rep["T"],
                        "mean_backbone_rmsd": rep["mean_backbone_rmsd"],
                        "mean_pure_noise_rmsd": rep["mean_pure_noise_rmsd"],
                        "seconds": rep["seconds"], "card": card}))
    # rmsd_backends: T = 200 on 16 entries, every default config; the verdict is logged
    t_rb = RMSD_BACKENDS_T
    out = tool_launches(lambda: rmsd_backends.main(
        [model, "-T", str(t_rb), "--entries", "16", "--data", "realistic", "--device", "cuda"]),
        "rmsd_backends", {"fused": {m: 2 * t_rb for m in MODES}, "pallas": 2 * t_rb})
    log(json.dumps({"metric": "rmsd_backends", "T": t_rb, "entries": 16,
                    "verdict": out["verdict"], "failures": out["failures"],
                    "rmsd_mean": {f"{r['backend']}:{r['precision']}": r["rmsd_mean"]
                                  for r in out["rows"]}, "card": card}))
    # bench_sampler: one T=1000 batch of 64 after the first call, per mode
    rates = []
    for mode, backends, extra in (("fp32", "fused,pallas", []), ("bf16", "fused", ["--bf16"]),
                                  ("high", "fused", ["--fast-f32"])):
        n = 2 * 2 * STEPS  # the first call and one timed call
        want = {"fused": {mode: n}, "pallas": n if "pallas" in backends else 0}
        rows = tool_launches(lambda: bench_sampler.main(
            ["-b", str(B), "-T", str(STEPS), "--iters", "1", "--backends", backends,
             "--device", "cuda"] + extra), f"bench_sampler {mode}", want)
        for row in rows:
            log(json.dumps({"metric": "bench_sampler", **row}))
        rates += rows
    # bench_train: 20 steps per mode (a warm-up dispatch and 3 timed ones of 5 steps)
    for mode, backends, extra in (("fp32", "fused,pallas", []), ("bf16", "fused", ["--bf16"]),
                                  ("high", "fused", ["--fast-f32"])):
        want = {"loop": {f"fwd_{mode}": 2 * TRAIN_STEPS, f"bwd_{mode}": 2 * TRAIN_STEPS},
                "pallas": 2 * TRAIN_STEPS if "pallas" in backends else 0}
        rows = tool_launches(lambda: bench_train.main(
            ["--batches", str(B), "--backends", backends, "--steps-per-dispatch", "5",
             "--iters", "1", "--repeats", "3", "--device", "cuda"] + extra),
            f"bench_train {mode}", want)
        for row in rows:
            log(json.dumps({"metric": "bench_train", **row}))
        rates += rows
    # bench_serve: 64 concurrent requests; the service's warm-up batch, then
    # each batch the server dispatched, 2 x T launches
    rows = tool_launches(lambda: bench_serve.main(
        ["-b", str(B), "-T", str(STEPS), "--requests", "64", "--concurrency", "64",
         "--warmup-requests", "8", "--device", "cuda"]), "bench_serve",
        lambda rows: {"fused": {"fp32": 2 * STEPS * (1 + sum(r["batches"] for r in rows))}})
    for row in rows:
        log(json.dumps({"metric": "bench_serve", **row}))
        if row["ok"] != row["requests"] or row["errors"]:
            raise AssertionError(f"bench_serve: {row['ok']} of {row['requests']} ok, {row['errors']}")
    # flops: what the measured rates achieve of the H100's peaks
    for row in flops.from_bench_lines(json.dumps(r) for r in rates):
        log(json.dumps({"metric": "flops_achieved", **row}))
    log(json.dumps({"metric": "tools_phase_s", "seconds": time.monotonic() - t_phase,
                    "card": card}))


def aot_main_path(card: str) -> None:
    """Phase 4d, the AOT artifact: ``tools/bench_aot.py`` exports a batch-64
    strided service's executable artifact here (fused fp32, fused bf16,
    pallas), and fresh processes on copies of the package sample the same
    batch: the artifact with an empty build directory and nvcc out of
    reach, bit for bit the exported PDB arrays and bytes, with exactly 2
    launches a step of the backend's kernel in its mode and none else;
    for fp32 also a cold (nvcc builds) and a warm (built libraries copied
    in) process without the artifact, and a doctored ``device_name`` that
    the load must refuse before any sampling."""
    from pmhc_tpu_torch.tools import bench_aot

    k = OFFLINE_SAMPLE_STEPS
    base = ["-b", str(B), "-T", str(STEPS), "--sample-steps", str(k), "--device", "cuda"]
    for label, extra, arms, (kind, mode) in (
            ("fp32", [], "cold,warm,aot,mismatch", ("fused", "fp32")),
            ("bf16", ["--bf16"], "aot", ("fused", "bf16")),
            ("pallas", ["--backend", "pallas"], "aot", ("pallas", "fp32"))):
        rows = bench_aot.main(base + extra + ["--arms", arms])
        for row in rows[1:]:
            if row["arm"] == "mismatch":
                log(f"aot {label}: a doctored device_name was refused before sampling: "
                    f"{row['refused'][-120:]}")
                continue
            got = row["launches"]
            want = {"fused": {m: 0 for m in got["fused"]}, "pallas": {"fp32": 0},
                    "loop": {m: 0 for m in got["loop"]}, "pdb_native": {"format_atoms": 2 * B}}
            want[kind][mode] = 2 * k
            if got != want or not row["bit_identical"]:
                raise AssertionError(f"aot {label} {row['arm']}: launches {got}, expected {want}")
            log(json.dumps({"metric": "aot_first_result_s", "backend": label, "arm": row["arm"],
                            "first_result_s": row["first_result_s"], "process_s": row["process_s"],
                            "batch": B, "steps": k, "nvcc": row["nvcc"], "card": card}))


def blockwise_main_path(model, entries, card: str) -> None:
    """Phase 4d, the ``blockwise`` backend (plain PyTorch: the JAX function
    reaches no Pallas kernel): a batch-64 strided chain and 5 optimizer
    steps with every kernel counter reset just before and still 0 after;
    the layer against the dense one at batch 64 per neighbour block
    (``BLOCKWISE_TOL``); the peak memory of one batch-64 layer forward,
    dense and blockwise."""
    import math

    import torch

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.models import ScoreNetworkConfig, egnn_forward
    from pmhc_tpu_torch.models.egnn_blockwise import egnn_forward_blockwise
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep
    from pmhc_tpu_torch.serve import SamplerService
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    dev = torch.device("cuda")
    k = OFFLINE_SAMPLE_STEPS
    svc = SamplerService(model, batch_size=B, noise_step_count=STEPS, num_steps=k,
                         backend="blockwise", bf16=True, seed=7)
    if svc.precision != "f32":
        raise AssertionError(f"blockwise reports precision {svc.precision}")
    trainer = Trainer(ScoreNetworkConfig(backend="blockwise"),
                      train_config=TrainConfig(seed=11, nan_check_every=0))
    batches = [synthetic_batch(batch_size=B, seed=700 + i) for i in range(5)]
    torch.cuda.synchronize()
    for mod in (ef, el, ep):
        mod.reset_launches()
    t0 = time.monotonic()
    pdbs = svc.sample_entries(entries, torch.Generator(device=dev).manual_seed(5))
    sample_s = time.monotonic() - t0
    walls, losses = [], []
    for b in batches:
        t0 = time.monotonic()
        losses.append(float(trainer.train_batch(b)["total loss"]))  # float() syncs
        walls.append(time.monotonic() - t0)
    moved = {n: dict(mod.LAUNCHES) for n, mod in (("fused", ef), ("loop", el), ("pallas", ep))}
    log(f"main path blockwise: {len(pdbs)} PDBs in {sample_s:.2f} s ({k} steps), 5 train steps, "
        f"kernel launches {moved}")
    if any(v for c in moved.values() for v in c.values()):
        raise AssertionError(f"blockwise launched a kernel: {moved}")
    for pdb, e in zip(pdbs, entries):
        check_pdb(pdb, e)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"blockwise training: non-finite losses {losses}")
    log(json.dumps({"metric": "blockwise_main_path", "batch": B, "sample_steps": k,
                    "sample_s": sample_s, "train_step_s": walls, "losses": losses, "card": card}))

    layer, args = egnn_case(model, "gnn1", seed=31, device=dev)
    with torch.no_grad():
        df, dt, dh = egnn_forward(layer, *args)
        for nb in NEIGHBOUR_BLOCKS:
            bf, bt, bh = egnn_forward_blockwise(layer, *args, neighbour_block=nb)
            errs = {n: float((g - w).abs().max()) for n, g, w in (
                ("q", bf.quats, df.quats), ("t", bf.trans, df.trans), ("tors", bt, dt),
                ("feat", bh, dh))}
            log(f"check blockwise neighbour_block={nb} against dense: {errs} (tol {BLOCKWISE_TOL})")
            if not all(errs[n] <= BLOCKWISE_TOL[n] for n in errs):
                raise AssertionError(f"blockwise {nb} disagrees with the dense layer: {errs}")

    def peak_mib(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - before) / 2 ** 20

    memory = {"dense": peak_mib(lambda: egnn_forward(layer, *args))}
    for nb in NEIGHBOUR_BLOCKS:
        memory[f"blockwise_{nb}"] = peak_mib(
            lambda: egnn_forward_blockwise(layer, *args, neighbour_block=nb))
    log(json.dumps({"metric": "layer_forward_peak_mib", "layer": "gnn1", "batch": B,
                    **memory, "card": card}))


def pdb_text_main_path(model, entries, card: str) -> None:
    """Phase 4d, the native PDB formatter on the serving path: ``finalize``
    of a batch of 64 takes it (its calls counted: 2 an entry, chains P and
    M), and writes the Python formatter's bytes; both timed. The HDF5
    decoder is logged as skipped where no libhdf5 exists (the card's
    machine has no h5py; the CPU tests hold the decoder), else held against
    ``PmhcDataset.get_entry`` on a file written here."""
    import statistics

    import torch

    from pmhc_tpu_torch.data import native
    from pmhc_tpu_torch.io import pdb_native
    from pmhc_tpu_torch.serve import SamplerService

    if not pdb_native.is_available():
        raise AssertionError("the native PDB formatter is not available")
    svc = SamplerService(model, batch_size=B, noise_step_count=STEPS,
                         num_steps=OFFLINE_SAMPLE_STEPS, seed=7)
    handle = svc.dispatch(entries, torch.Generator(device="cuda").manual_seed(9))
    handle.wait()
    times = {"native": [], "python": []}
    out = {}
    for _ in range(3):
        for path in ("native", "python"):
            if path == "python":
                os.environ["PMHC_PDB_FORMATTER"] = "python"
            pdb_native.reset_calls()
            try:
                t0 = time.monotonic()
                out[path] = svc.finalize(handle)
                times[path].append(time.monotonic() - t0)
            finally:
                os.environ.pop("PMHC_PDB_FORMATTER", None)
            want = 2 * len(entries) if path == "native" else 0
            if pdb_native.CALLS["format_atoms"] != want:
                raise AssertionError(f"pdb {path}: {pdb_native.CALLS} native calls, expected {want}")
    if out["native"] != out["python"]:
        raise AssertionError("the native formatter's PDB bytes differ from the Python path's")
    log(json.dumps({"metric": "pdb_text_s", "batch": len(entries), "native_s": times["native"],
                    "python_s": times["python"],
                    "speedup": statistics.median(times["python"]) / statistics.median(times["native"]),
                    "bytes": sum(len(p) for p in out["native"]), "card": card}))
    if not native.is_available():
        log("hdf5 decoder: skipped, no libhdf5 (h5py) on this machine; the CPU tests hold it "
            "(tests/test_torch_native_decoder.py)")
        return
    import tempfile

    import numpy as np

    from pmhc_tpu_torch.data import PmhcDataset, write_synthetic_hdf5

    with tempfile.TemporaryDirectory() as d:
        h5 = os.path.join(d, "t.hdf5")
        write_synthetic_hdf5(h5, n_entries=8, seed=0)
        ds = PmhcDataset(h5)
        got = native.decode_packed(h5, ds.entry_names)
        for key, v in got.items():
            np.testing.assert_array_equal(v, np.stack([ds.get_entry(n)[key] for n in ds.entry_names]))
    log("hdf5 decoder: 8 entries bit-exact against PmhcDataset.get_entry")


def pallas_times(cases, launches: int, err: float, card: str) -> dict:
    """Phase 5, kernel #3: ms per launch (CUDA events) beside its plain
    version and its bound, averaged over the two layer shapes; returns its
    row of the kernels line."""
    import numpy as np
    import torch

    from pmhc_tpu_torch.ops import egnn_pallas as ep

    lib = ep._lib()
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731 (a capture's own)
    per = {"ms": [], "plain_ms": [], "bound_ms": []}
    bound_by = None
    for layer, (ctx, step) in cases.items():
        args = ctx.inputs(*step)
        ms = time_ms(lambda: ep.launch(lib, *args, stream=cur()), 50)
        plain = time_ms(lambda: ep.egnn_pallas_plain(*args), 5)
        flops, nbytes, bound_ms, bound_by = work_of_pallas(args)
        log(json.dumps({"metric": "egnn_pallas_ms", "layer": layer, "ms": ms, "plain_ms": plain,
                        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
                        "mbytes": nbytes / 1e6, "tflops": flops / ms / 1e9, "card": card}))
        per["ms"].append(ms)
        per["plain_ms"].append(plain)
        per["bound_ms"].append(bound_ms)
    return {"name": "egnn_pallas_fp32", "route": "cuda",
            "source": "pmhc_tpu_torch/csrc/egnn_pallas.cu", "replaces": PALLAS_REPLACES,
            "launches": launches, "max_abs_err": err,
            # per launch, averaged over the two layer shapes of one step
            "ms": float(np.mean(per["ms"])), "plain_ms": float(np.mean(per["plain_ms"])),
            "bound_ms": float(np.mean(per["bound_ms"])), "bound_by": bound_by,
            "library_ms": None}  # no single PyTorch call computes this layer


# -- 6. multi-GPU -------------------------------------------------------------------


def mesh_layouts(world: int) -> dict:
    """Phase 6's meshes (data, model, context) for ``world`` ranks; at one
    rank every path runs on a mesh of one."""
    m = min(2, world)
    return {"dp": (world, 1, 1), "cp": (world // m, 1, m), "ring": (1, 1, world),
            "tp": (world // m, m, 1), "dp_tp_cp": (1, m, world // m)}


def mesh_say(msg: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        log(msg)


def mesh_counts(mode: str, steps: int) -> dict:
    """Every rank's loop-kernel counts (all_gather_object) against
    ``steps`` x 2 forward and 2 backward launches in ``mode``, none of #1-#3."""
    import torch.distributed as dist

    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    mine = {**el.LAUNCHES, "other": sum(ef.LAUNCHES.values()) + sum(ep.LAUNCHES.values())}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    want = {k: (2 * steps if k.endswith(mode) else 0) for k in mine}
    for rank, counts in enumerate(every):
        if counts != want:
            raise AssertionError(f"rank {rank}: launches {counts}, expected {want}")
    return every[0]


def mesh_state(trainer) -> list:
    """A trainer's whole parameters (gathered over ``model``; every rank calls it)."""
    return [t.detach().clone() for t in trainer.state_dict().values()]


def mesh_vs_single(label: str, mesh, card: str, mode: str = "fp32", backend: str = "auto",
                   tensor_parallel: bool = False, context_parallel: bool = False) -> None:
    """``MESH_STEPS`` graphed steps of a mesh ``Trainer`` on global batches
    of 64 per data rank, held on rank 0 against a one-card ``Trainer`` from
    the same seed on the same batches (``GRAPH_TRAIN_TOL``: losses, and the
    parameters' change from their start)."""
    import torch
    import torch.distributed as dist

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    kw = dict(train_config=TrainConfig(seed=12, learning_rate=TRAIN_LR, nan_check_every=0),
              bf16=mode == "bf16", fast_f32=mode == "high")
    batches = [synthetic_batch(batch_size=B * mesh.size(0), seed=700 + k) for k in range(MESH_STEPS)]
    tr = Trainer(ScoreNetworkConfig(backend=backend), mesh=mesh, tensor_parallel=tensor_parallel,
                 context_parallel=context_parallel, **kw)
    start = mesh_state(tr)
    losses = [float(tr.train_batch(b)["total loss"]) for b in batches]
    got = mesh_state(tr)
    if dist.get_rank() == 0:
        single = "dense" if backend in ("xla", "cp", "ring") else backend
        ref = Trainer(ScoreNetworkConfig(backend=single), **kw)
        want_l = [float(ref.train_batch(b)["total loss"]) for b in batches]
        want = [p.detach().clone() for p in ref.model.parameters()]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_l))
        change = change_errors(start, got, want)
        log(json.dumps({"metric": "mesh_vs_one_card", "path": label, "mesh": list(mesh.shape),
                        "backend": backend, "mode": mode, "batch": B * mesh.size(0),
                        "steps": MESH_STEPS, "losses": losses, "one_card_losses": want_l,
                        "loss_max_rel_diff": rel, "param_change": change,
                        "tol": GRAPH_TRAIN_TOL, "card": card}))
        if not (rel <= GRAPH_TRAIN_TOL["loss_rtol"] and change_close(change)):
            raise AssertionError(f"{label} on {tuple(mesh.shape)} disagrees with one card: "
                                 f"rel {rel:.2e}, change {change}")
    torch.cuda.synchronize()
    dist.barrier()


def mesh_dp_main_path(world: int, card: str) -> dict:
    """DP on ``world`` ranks: ``TRAIN_STEPS`` graphed steps per mode at
    batch 64 a rank, with every counter zeroed just before; finite losses
    and exactly 2 forward and 2 backward loop launches a step on every
    rank in the mode. Returns rank 0's counts by mode."""
    import math

    import torch
    import torch.distributed as dist

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep
    from pmhc_tpu_torch.parallel import make_mesh
    from pmhc_tpu_torch.train import MetricsRecord, TrainConfig, Trainer

    mesh = make_mesh(*mesh_layouts(world)["dp"])
    batches = [synthetic_batch(batch_size=B * world, seed=900 + k) for k in range(TRAIN_STEPS)]
    launches = {}
    for mode in MODES:
        tr = Trainer(ScoreNetworkConfig(backend="auto"), train_config=TrainConfig(
            seed=5, nan_check_every=TRAIN_STEPS), bf16=mode == "bf16", fast_f32=mode == "high",
            mesh=mesh)
        metrics = MetricsRecord()
        torch.cuda.synchronize()
        dist.barrier()
        el.reset_launches()
        ef.reset_launches()
        ep.reset_launches()
        walls = []
        for b in batches:
            t0 = time.monotonic()
            tr.train_batch(b, metrics)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        counts = mesh_counts(mode, TRAIN_STEPS)
        mean = metrics.mean()
        if not all(math.isfinite(v) for v in mean.values()):
            raise AssertionError(f"mesh DP {mode}: non-finite losses {mean}")
        mesh_say(f"mesh DP {mode}: {world} ranks x batch {B}, {TRAIN_STEPS} steps, launches per "
                 f"rank {counts}, mean losses {json.dumps({k: round(v, 4) for k, v in mean.items()})}")
        mesh_say(json.dumps({"metric": "mesh_dp_step_s", "mode": mode, "world": world,
                             "batch_per_rank": B, "seconds": walls, "card": card}))
        launches[mode] = {k: v for k, v in counts.items() if k != "other"}
    for mode in MODES:
        mesh_vs_single("dp", mesh, card, mode)
    return launches


def mesh_sampling(world: int, card: str, model, backend: str) -> float:
    """CP or ring sampling: a 4-step batch-4 trajectory with injected noise
    held against the one-card dense sampler (``TRAJ_TOL``), then a batch-64
    T=1000 chain through ``sample_cli.sharded_service`` (from CUDA graphs;
    the first batch captures) whose PDBs pass ``check_pdb``. Returns the
    second chain's wall."""
    import torch
    import torch.distributed as dist

    from pmhc_tpu_torch.cli.sample_cli import sharded_service
    from pmhc_tpu_torch.diffusion import gen_noise, sample
    from pmhc_tpu_torch.diffusion.sampler import sample_sharded
    from pmhc_tpu_torch.geometry import RigidArray
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.ops import sampler_step as ss
    from pmhc_tpu_torch.parallel import make_mesh
    from pmhc_tpu_torch.serve import SamplerService

    dev = torch.device("cuda", torch.cuda.current_device())
    model = model.to(dev).eval()
    mesh = make_mesh(*mesh_layouts(world)[backend])
    one = SamplerService(model, batch_size=4, noise_step_count=4, backend="dense", device=dev)
    mb, _ = one.build_model_batch([request_entry(seed=300 + i) for i in range(4)],
                                  torch.Generator(device=dev).manual_seed(11))
    g = torch.Generator(device=dev).manual_seed(12)
    inj = [gen_noise(g, (4, 16), one.diffusion_config) for _ in range(4)]
    inj = {"frames": RigidArray(torch.stack([n["frames"].quats for n in inj]),
                                torch.stack([n["frames"].trans for n in inj])),
           "torsions": torch.stack([n["torsions"] for n in inj])}
    got = sample_sharded(model, mb, one.diffusion_config,
                         ScoreNetworkConfig(noise_step_count=4, backend=backend), mesh,
                         injected_noise=inj)
    if dist.get_rank() == 0:
        want = sample(model, mb, one.diffusion_config, one.model_config, injected_noise=inj)
        for name, get in (("q", lambda r: r["frames"].quats), ("t", lambda r: r["frames"].trans),
                          ("tors", lambda r: r["torsions"])):
            err = float((get(got) - get(want)).abs().max())
            log(f"mesh {backend} {tuple(mesh.shape)} 4-step trajectory vs one-card dense {name}: "
                f"max_abs_err {err:.3e} (tol {TRAJ_TOL[name]:.0e})")
            if not err <= TRAJ_TOL[name]:
                raise AssertionError(f"mesh {backend} trajectory {name} disagrees with dense")
    entries64 = [request_entry(seed=200 + i) for i in range(B)]
    svc = sharded_service(mesh)(model, batch_size=B, noise_step_count=STEPS, backend=backend,
                                seed=7, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    svc.sample_entries(entries64, gen)  # the capture
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.monotonic()
    handle = svc.dispatch(entries64, gen)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    pdbs = svc.finalize(handle)
    if dist.get_rank() == 0:
        for pdb, e in zip(pdbs, entries64):
            check_pdb(pdb, e)
    if any(ss.LAUNCHES.values()):
        raise AssertionError(f"mesh {backend}: the sampler step kernels ran: {dict(ss.LAUNCHES)}")
    mesh_say(f"mesh {backend} {tuple(mesh.shape)}: batch {B}, T={STEPS}, {len(pdbs)} PDBs "
             f"checked, chain {wall:.3f} s")
    dist.barrier()
    return wall


def one_card_chain(model) -> float:
    """The one-card dense sampler's batch-64 T=1000 chain wall (graphed,
    after a capturing first chain), on rank 0 while the others wait."""
    import torch
    import torch.distributed as dist

    from pmhc_tpu_torch.serve import SamplerService

    wall = 0.0
    if dist.get_rank() == 0:
        dev = torch.device("cuda", torch.cuda.current_device())
        entries64 = [request_entry(seed=200 + i) for i in range(B)]
        one = SamplerService(model.to(dev).eval(), batch_size=B, noise_step_count=STEPS,
                             backend="dense", seed=7, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1234)
        one.sample_entries(entries64, gen)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        one.dispatch(entries64, gen)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    dist.barrier()
    return wall


def mesh_timings(world: int, card: str) -> None:
    """DP steps at every world w <= ``world`` of 1, 2, 4 (64 a rank, and 64
    in all), fp32, from graphs (median of ``MESH_TIMED_STEPS``, the first
    step, its capture, left out); the gradient all-reduce alone (79,195
    fp32 and the 5 loss sums, eager, between CUDA events)."""
    import torch
    import torch.distributed as dist

    from pmhc_tpu_torch.data.synthetic import synthetic_batch
    from pmhc_tpu_torch.models import ScoreNetwork, ScoreNetworkConfig
    from pmhc_tpu_torch.parallel import make_mesh
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    for w in (n for n in (1, 2, 4) if n <= world):
        for scaling, global_batch in (("weak", B * w), ("strong", B)):
            mesh = make_mesh(w)
            if mesh.get_coordinate() is not None:
                tr = Trainer(ScoreNetworkConfig(backend="auto"),
                             train_config=TrainConfig(seed=5, nan_check_every=0), mesh=mesh)
                batches = [synthetic_batch(batch_size=global_batch, seed=1000 + k)
                           for k in range(MESH_TIMED_STEPS)]
                walls = []
                for b in batches:
                    t0 = time.monotonic()
                    tr.train_batch(b)
                    torch.cuda.synchronize()
                    walls.append(time.monotonic() - t0)
                med = sorted(walls[1:])[len(walls[1:]) // 2]
                mesh_say(json.dumps({"metric": "mesh_dp_scaling", "scaling": scaling, "world": w,
                                     "global_batch": global_batch, "median_step_ms": med * 1e3,
                                     "examples_per_s": global_batch / med,
                                     "steps_ms": [x * 1e3 for x in walls], "card": card}))
            dist.barrier()
    n = sum(p.numel() for p in ScoreNetwork().parameters()) + 5
    buf = torch.ones(n, device=torch.device("cuda", torch.cuda.current_device()))
    for _ in range(10):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.monotonic()
    start.record()
    for _ in range(ALLREDUCE_ITERS):
        dist.all_reduce(buf)
    end.record()
    torch.cuda.synchronize()
    mesh_say(json.dumps({"metric": "mesh_grad_allreduce", "world": world, "floats": n,
                         "bytes": 4 * n, "us": start.elapsed_time(end) / ALLREDUCE_ITERS * 1e3,
                         "host_us": (time.monotonic() - t0) / ALLREDUCE_ITERS * 1e6,
                         "card": card}))


def mesh_clis(world: int, card: str, work: str) -> None:
    """The CLIs on the group: ``train_cli --mesh-data world`` one epoch
    (rank 0's ``.pth`` loads strict; 2 forward and 2 backward fp32 loop
    launches a step on every rank), and ``sample_cli --backend cp
    --mesh-context min(2, world)`` (every PDB once, each passing ``check_pdb``)."""
    import torch
    import torch.distributed as dist

    from pmhc_tpu_torch.cli import sample_cli, train_cli
    from pmhc_tpu_torch.data import PackedDataset
    from pmhc_tpu_torch.models import ScoreNetwork
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    train, test = (os.path.join(work, f"{k}.npz") for k in ("train", "test"))
    model = os.path.join(work, "mesh.pth")
    torch.cuda.synchronize()
    dist.barrier()
    el.reset_launches()
    ef.reset_launches()
    ep.reset_launches()
    stats = train_cli.main([train, "1", model, "--mesh-data", str(world), "-b", str(B * world),
                            "--device", "cuda"])
    steps = -(-MESH_SETS["train"][0] // (B * world))
    counts = mesh_counts("fp32", steps)
    if dist.get_rank() == 0:
        ScoreNetwork().load_state_dict(torch.load(model, map_location="cpu", weights_only=True),
                                       strict=True)
        log(json.dumps({"metric": "mesh_train_cli", "world": world, "global_batch": B * world,
                        "steps": steps, "launches": counts, **stats["epochs"][0], "card": card}))
    out = os.path.join(work, "sampled")
    stats = sample_cli.main([model, test, "--backend", "cp", "--mesh-context", str(min(2, world)),
                             "-b", str(B), "--sample-steps", str(MESH_SAMPLE_STEPS),
                             "--output-dir", out, "--device", "cuda"])
    if dist.get_rank() == 0:
        ds = PackedDataset.load(test)
        files = sorted(os.listdir(out))
        if len(files) != len(ds) or stats["pdbs"] != len(ds):
            raise AssertionError(f"sample CLI on the mesh: {len(files)} PDBs for {len(ds)} entries")
        index = {n: i for i, n in enumerate(ds.entry_names)}
        for f in files:
            name = f.split(".")[0]
            entry = {"mask": ds[index[name]]["mask"], **ds.get_protein_positions([name])}
            entry = {k: v[0] if k.startswith("protein_") else v for k, v in entry.items()}
            with open(os.path.join(out, f), "rb") as fh:
                check_pdb(fh.read(), entry)
        log(json.dumps({"metric": "mesh_sample_cli", "world": world,
                        "mesh_context": min(2, world), "pdbs": stats["pdbs"],
                        "wall_s": stats["wall_s"], "card": card}))
    dist.barrier()


def torchrun_cli(world: int, card: str, work: str) -> None:
    """``train_cli --mesh-data world`` on ranks that ``torchrun`` starts,
    as the README shows: every rank joins the group, trains, and ends its
    process (``parallel.distributed.leave``) within ``TORCHRUN_S``; rank
    0's ``.pth`` loads strict. The process group of ``torchrun`` is killed
    if it outlives the deadline."""
    import signal

    import torch

    from pmhc_tpu_torch.models import ScoreNetwork
    from pmhc_tpu_torch.parallel.distributed import free_port

    model = os.path.join(work, "torchrun.pth")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
           "--master-addr", "localhost", "--master-port", str(free_port()),
           "-m", "pmhc_tpu_torch.cli.train_cli", os.path.join(work, "train.npz"), "1", model,
           "--mesh-data", str(world), "-b", str(B * world), "--device", "cuda"]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TORCHRUN_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train_cli exit {proc.returncode} after {wall:.1f} s:\n"
                             f"{out[-4000:]}")
    ScoreNetwork().load_state_dict(torch.load(model, map_location="cpu", weights_only=True),
                                   strict=True)
    log(json.dumps({"metric": "mesh_torchrun_cli", "world": world, "global_batch": B * world,
                    "wall_s": wall, "card": card}))


def mesh_rank(card: str, world: int, work: str) -> dict:
    """One rank of phase 6 (``multi_gpu_main_path``)."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pmhc_tpu_torch.parallel import make_mesh

    layouts = mesh_layouts(world)
    mesh_say(f"mesh ranks: {world}, layouts {layouts}, rank 0 on cuda:{torch.cuda.current_device()}")
    launches = mesh_dp_main_path(world, card)
    mesh_vs_single("cp", make_mesh(*layouts["cp"]), card, backend="cp", context_parallel=True)
    for backend in ("auto", "xla"):
        mesh_vs_single("tp", make_mesh(*layouts["tp"]), card, backend=backend, tensor_parallel=True)
    mesh_vs_single("dp_tp_cp", make_mesh(*layouts["dp_tp_cp"]), card, backend="xla",
                   tensor_parallel=True, context_parallel=True)
    mesh_clis(world, card, work)
    mesh_timings(world, card)
    # the ring last: its hops are the only point-to-point sends in a graph
    model = random_model(seed=0)
    walls = {"cp": mesh_sampling(world, card, model, "cp")}
    mesh_vs_single("ring", make_mesh(*layouts["ring"]), card, backend="ring", context_parallel=True)
    walls["ring"] = mesh_sampling(world, card, model, "ring")
    walls["one_card_dense"] = one_card_chain(model)
    mesh_say(json.dumps({"metric": "mesh_sample_chain_s", "world": world, "batch": B,
                         "steps": STEPS, "meshes": {k: layouts[k] for k in ("cp", "ring")},
                         **walls, "card": card}))
    return {"rank": dist.get_rank(), "launches": launches}


def multi_gpu_main_path(card: str, world: int) -> dict:
    """Phase 6: the mesh paths on ``world`` cards, one process each over
    NCCL (``parallel.distributed.spawn``): DP training with its launch
    counts exact per rank and against one card, CP and ring sampling and
    training, TP,
    DP x TP x CP, both CLIs on the group, and the timings; then the train
    CLI under ``torchrun``. Returns rank 0's loop-kernel counts of the DP
    main path by mode."""
    import shutil

    import torch

    from pmhc_tpu_torch.parallel.distributed import spawn

    log(json.dumps({"metric": "multi_gpu_world", "world": world,
                    "cards": torch.cuda.device_count(), "card": card}))
    t_phase = time.monotonic()
    work = os.path.join(REPO, ".chip_scratch", "mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        for name, (n, seed) in MESH_SETS.items():
            pack_realistic(os.path.join(work, f"{name}.npz"), n, seed)
        res = spawn(mesh_rank, world, args=(card, world, work), device="cuda", timeout=600)
        torchrun_cli(world, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"metric": "phase_6_s", "world": world, "seconds": time.monotonic() - t_phase,
                    "card": card}))
    return res[0]["launches"]


def check_pdb(pdb: bytes, entry) -> None:
    """ATOM records parse with finite coordinates; chain P holds one
    residue per peptide position, chain M the entry's existing atoms."""
    import math

    lines = pdb.decode().splitlines()
    atoms = [ln for ln in lines if ln.startswith("ATOM  ")]
    if not atoms or lines[-1] != "END":
        raise AssertionError("PDB without ATOM records or END")
    p_res = set()
    n_m = 0
    for ln in atoms:
        xyz = [float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
        if not all(math.isfinite(v) for v in xyz):
            raise AssertionError(f"non-finite coordinate: {ln!r}")
        if ln[21] == "P":
            p_res.add(int(ln[22:26]))
        else:
            n_m += 1
    want_p = int(entry["mask"].sum())
    if len(p_res) != want_p:
        raise AssertionError(f"chain P has {len(p_res)} residues, expected {want_p}")
    if n_m != int(entry["protein_atom14_exists"].sum()):
        raise AssertionError(f"chain M has {n_m} atoms, expected {int(entry['protein_atom14_exists'].sum())}")


def main() -> int:
    # -- 1. device check ------------------------------------------------------
    if not os.path.isdir(os.path.join(REPO, "pmhc_tpu_torch")):
        print("chip_smoke: pmhc_tpu_torch/ not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pmhc_tpu_torch.ops import _build
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import sampler_step as ss

    # -- 2. build: one nvcc per source, all started together -------------------------
    sources = ("egnn_fused", "egnn_loop", "egnn_pallas", "sampler_step")
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as pool:
        infos = dict(zip(sources, pool.map(lambda n: _build.build(n, ptxas_verbose=True), sources)))
    log(f"build: {time.monotonic() - t0:.1f} s for {len(sources)} sources in parallel")
    for name, info in infos.items():
        log(f"build {name}: {info['seconds']:.1f} s -> {os.path.relpath(info['path'], REPO)}")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"  ptxas: {ln.strip()}")
    check_fused_build(infos["egnn_fused"])
    check_loop_build(infos["egnn_loop"])
    check_pallas_build(infos["egnn_pallas"])
    check_sampler_step_build(infos["sampler_step"])

    # -- 3. kernel vs plain version ---------------------------------------------
    model = random_model(seed=0).to(dev).eval()
    cases = {layer: layer_case(model, layer, seed=i + 1, device=dev)
             for i, layer in enumerate(("gnn1", "gnn2"))}
    # and a ragged last row tile: layer 2's neighbours cut to NP = 90; two
    # tiles a row: layer 1's grown to NP = 136 (loop_two_tiles: the fused
    # layer's neighbour inputs sit where the loop's do); layer 1's inputs 4
    # bytes off 16-byte alignment
    checks = {**cases, "gnn2 NP=90": ragged_case(cases["gnn2"]),
              "gnn1 NP=136": loop_two_tiles(cases["gnn1"]), "gnn1 unaligned": unaligned_case(cases["gnn1"])}
    max_err = {}
    for mode in MODES:
        bf16 = ef.FLAGS[mode]
        errs = []
        for layer, args in checks.items():
            got = ef.egnn_fused(*args, bf16=bf16)
            want = ef.egnn_fused_plain(*args, bf16=bf16)
            torch.cuda.synchronize()
            for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
                err = float((g - w).abs().max())
                ok = err <= TOL[mode][name] and bool(torch.isfinite(g).all())
                log(f"check {mode} {layer} {name}: max_abs_err {err:.3e} (tol {TOL[mode][name]:.0e})"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel {mode} {layer} {name} disagrees with plain version")
                errs.append(err)
            if mode != "bf16" and layer in cases:
                # the bf16 tolerances must be tight enough to catch a bf16 mode
                # that skips its rounding (the fp32 kernel, held against the
                # bf16 plain version, has to fail them on some output), and
                # the high ones a high mode that rounds where it should split
                # (the bf16 kernel against the high plain version)
                other, against = ("fp32", "bf16") if mode == "fp32" else ("bf16", "high")
                got_o = got if other == mode else ef.egnn_fused(*args, bf16=ef.FLAGS[other])
                want = ef.egnn_fused_plain(*args, bf16=ef.FLAGS[against])
                over = []
                for name, g, w in zip(("q", "t", "tors", "feat"), got_o, want):
                    err = float((g - w).abs().max())
                    log(f"sensitivity {other} kernel vs {against} plain {layer} {name}: max_abs_err "
                        f"{err:.3e} ({against} tol {TOL[against][name]:.0e})")
                    if err > TOL[against][name]:
                        over.append(name)
                if not over:
                    raise AssertionError(f"{against} tolerances cannot tell {other} from {against} "
                                         f"on {layer}")
        max_err[mode] = max(errs)
    loop_cases, loop_err = check_loop_kernels(model, dev)
    pallas_cases = {layer: pallas_case(model, layer, seed=20 + i, device=dev)
                    for i, layer in enumerate(("gnn1", "gnn2"))}
    # and a partial last neighbour block: layer 2's neighbours cut to NP = 90
    pallas_err = check_pallas_kernel({**pallas_cases, "gnn2 NP=90": (
        pallas_ragged(pallas_cases["gnn2"][0]), pallas_cases["gnn2"][1])})
    step_err = check_sampler_step(model, dev)

    # -- 4. the main paths ----------------------------------------------------------
    from pmhc_tpu_torch.serve import SamplerService

    trajectory_check(model, dev, "fused")
    trajectory_check(model, dev, "fused", "high")

    entries3 = [request_entry(seed=100 + i) for i in range(3)]
    entries64 = [request_entry(seed=200 + i) for i in range(B)]
    launches = {}
    for mode in MODES:
        svc = SamplerService(model, batch_size=B, noise_step_count=STEPS, bf16=mode == "bf16",
                             fast_f32=mode == "high", seed=7)
        if svc.precision != PRECISION[mode]:
            raise AssertionError(f"SamplerService {mode} reports precision {svc.precision}")
        gen = torch.Generator(device=dev).manual_seed(1234)
        walls = []  # (dispatch s, finalize s, dispatch's return s) of each batch of 64
        for label, entries in (("3 requests", entries3), ("batch of 64", entries64),
                               ("batch of 64", entries64)):
            torch.cuda.synchronize()
            ef.reset_launches()
            ss.reset_launches()
            t0 = time.monotonic()
            handle = svc.dispatch(entries, gen)
            t_ret = time.monotonic()
            torch.cuda.synchronize()
            t1 = time.monotonic()
            pdbs = svc.finalize(handle)
            t2 = time.monotonic()
            conv, n = handle.conv, handle.n
            count = ef.LAUNCHES[mode]
            other = sum(v for k, v in ef.LAUNCHES.items() if k != mode)
            log(f"main path {mode} {label}: {len(pdbs)} PDBs in {t2 - t0:.2f} s "
                f"(sampling {t1 - t0:.2f} s, PDB text {t2 - t1:.2f} s), "
                f"kernel launches {count} (expected {2 * STEPS})")
            if len(entries) == B:
                walls.append((t1 - t0, t2 - t1, t_ret - t0))
            if count != 2 * STEPS or other != 0:
                raise AssertionError(f"{mode}: {count} kernel launches, expected {2 * STEPS}")
            # the sampler step's kernels: as many as the layer's, in the mode
            if ss.LAUNCHES != {m: count if m == mode else 0 for m in ss.LAUNCHES}:
                raise AssertionError(f"{mode}: sampler step launches {dict(ss.LAUNCHES)}, "
                                     f"expected {count}")
            if len(pdbs) != len(entries):
                raise AssertionError("one PDB per request expected")
            for pdb, e in zip(pdbs, entries):
                check_pdb(pdb, e)
            qn = conv["quats"][:n].norm(dim=-1)
            if not bool(torch.isfinite(conv["quats"]).all()) or float((qn - 1).abs().max()) > 1e-3:
                raise AssertionError(f"{mode}: sampled quats not unit (max |norm-1| "
                                     f"{float((qn - 1).abs().max()):.3e})")
            launches[mode] = count
        # dispatch_return_s: when dispatch handed back to the host (the card
        # still sampling) of the sampling_s it took to the card's end
        log(json.dumps({"metric": "trajectory_s", "mode": mode, "batch": B, "steps": STEPS,
                        "seconds": [d + f for d, f, _ in walls],
                        "sampling_s": [d for d, _, _ in walls], "pdb_s": [f for _, f, _ in walls],
                        "dispatch_return_s": [r for _, _, r in walls], "card": card}))

    sampling_graphs_vs_eager(model, entries64, card)

    train_trajectory_check(dev)
    train_trajectory_check(dev, "high")
    train_launches, train_walls = train_main_path(dev, card)
    training_graphs_vs_eager(card)

    # the pallas path: its trajectory, the HTTP server, the trainer
    trajectory_check(model, dev, "pallas")
    pallas_launches, _ = http_main_path(model, card)
    trainer_pallas_check(dev, card)

    # -- 4b. the offline CLIs; 4c. the tools, on 4b's trained weights -------------------
    import shutil

    work = os.path.join(REPO, ".chip_scratch", "offline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        offline = offline_main_path(card, work)
        tools_main_path(card, offline["model"], offline["test"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 4d. the AOT artifact, the blockwise backend, the native PDB formatter ---------
    t_phase = time.monotonic()
    aot_main_path(card)
    blockwise_main_path(model, entries64, card)
    pdb_text_main_path(model, entries64, card)
    log(json.dumps({"metric": "phase_4d_s", "seconds": time.monotonic() - t_phase, "card": card}))

    # -- 5. times -------------------------------------------------------------------
    kernels = []
    # launched as the loop and pallas kernels are timed: through the library
    # alone, the launches captured in a graph and replayed (time_ms)
    fused_lib = ef._lib()
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731 (a capture's own)
    for mode in MODES:
        bf16 = ef.FLAGS[mode]
        per = {"ms": [], "plain_ms": [], "bound_ms": [], "gemm_ms": []}
        bound_by = None
        for layer, args in cases.items():
            ms = time_ms(lambda: ef.launch(fused_lib, *args, bf16=bf16, stream=cur()), iters=100)
            plain = time_ms(lambda: ef.egnn_fused_plain(*args, bf16=bf16), iters=10)
            gemm = gemm_ms(args, mode)
            flops, nbytes, bound_ms, bound_by = work_of(args, mode)
            log(json.dumps({"metric": "egnn_fused_ms", "mode": mode, "layer": layer, "ms": ms,
                            "plain_ms": plain, "gemm_ms": gemm, "bound_ms": bound_ms,
                            "bound_by": bound_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                            "tflops": flops / ms / 1e9, "card": card}))
            per["ms"].append(ms)
            per["plain_ms"].append(plain)
            per["bound_ms"].append(bound_ms)
            per["gemm_ms"].append(gemm)
        kernels.append({
            "name": f"egnn_fused_{mode}", "route": "cuda",
            "source": "pmhc_tpu_torch/csrc/egnn_fused.cu", "replaces": REPLACES[mode],
            "launches": launches[mode], "max_abs_err": max_err[mode],
            # per launch, averaged over the two layer shapes of one step
            "ms": float(np.mean(per["ms"])), "plain_ms": float(np.mean(per["plain_ms"])),
            "bound_ms": float(np.mean(per["bound_ms"])), "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this layer
            # its dominant product alone, a yardstick (not the layer's function)
            "gemm_ms": float(np.mean(per["gemm_ms"])),
        })

    kernels.append(sampler_step_times(model, dev, launches["fp32"], step_err, card))
    kernels += loop_times(loop_cases, loop_err, train_launches, card)
    kernels.append(pallas_times(pallas_cases, pallas_launches, pallas_err, card))

    # device busy and idle share over a strided K=100 batch-64 run (same
    # per-step work as T=1000, a trace 10x shorter)
    # with CUDA graphs (the default) and eager: the wall of a strided batch-64
    # dispatch and its device busy time and idle share
    steps_k = 100
    gen = torch.Generator(device=dev).manual_seed(99)
    for backend, mode in (("auto", "fp32"), ("auto", "bf16"), ("auto", "high"), ("pallas", "fp32")):
        for graphs in (True, False):
            svc = SamplerService(model, batch_size=B, noise_step_count=STEPS, num_steps=steps_k,
                                 backend=backend, bf16=mode == "bf16", fast_f32=mode == "high",
                                 seed=7, graphs=graphs)
            svc.sample_entries(entries64[:1])  # warm-up: the kernels' first load, the capture
            bd = device_breakdown(lambda: svc.dispatch(entries64, gen))
            log(json.dumps({"metric": "device_breakdown", "path": "sample", "backend": backend,
                            "mode": mode, "graphs": graphs, "batch": B, "steps": steps_k, **bd,
                            "card": card}))
    overlap_walls(model, entries64, card)
    for mode in MODES:
        w = sorted(train_walls[mode][1:])  # the first step loads the kernels and captures
        log(json.dumps({"metric": "train_step_s_median", "mode": mode, "graphs": True, "batch": B,
                        "median_s": w[len(w) // 2], "card": card}))
    for mode in MODES:
        for graphs in (True, False):
            log(json.dumps({"metric": "device_breakdown", "path": "train", "mode": mode,
                            "graphs": graphs, "batch": B, "steps": 10,
                            **train_breakdown(mode, graphs), "card": card}))

    # -- 6. the mesh paths, one process a card over NCCL ----------------------------
    torch.cuda.empty_cache()
    multi_gpu_main_path(card, min(torch.cuda.device_count(), 4))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
