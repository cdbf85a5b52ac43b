#!/usr/bin/env python3
"""Measure, on one card, the two host-path choices behind the port's
defaults: how many sampler steps a CUDA graph holds
(``diffusion/sampler.py::STEPS_PER_GRAPH``), and whether the train CLI's
``--device-data --steps-per-dispatch K`` branch (``Trainer.train_indices``)
is faster than one step a dispatch; and the port's sampling quality after
training in each precision.

    python3 chip_studies.py [steps-per-graph] [device-data] [quality] [--seeds 0,1,2]

(the first two when none is named; ``quality``'s outcome is stochastic and
it takes minutes, so it runs only when named). ``steps-per-graph``: the strided batch-64
bf16 chain of 100 steps (the fastest kernel, so the most host-bound) from
graphs of 1, 10 and 100 steps, each from a new cache: the first call's
seconds (its eager steps and the capture), then over 3 calls the host's
milliseconds per step to queue the chain and the wall per step to its
end; then ``chip_smoke.overlap_walls`` (the sample CLI's loop, 3 T=1000
fp32 batches) from graphs of 1 and 10 steps, in turns 1, 10, 10, 1.
``device-data``: ``train_cli`` in bf16 with ``--device-data`` over 4,096
realistic entries (64 batches of 64 an epoch, 3 epochs, a new model each
run) at ``--steps-per-dispatch`` 1 and 4, in turns 1, 4, 4, 1, with the
loop kernels' launches checked; epoch 0 holds the captures.
``quality`` (the JAX package's long-horizon study, ``docs/parity.md``):
for each of ``--seeds`` (default 0), ``train_cli`` trains three arms,
fp32, ``--bf16`` and ``--fast-f32``, from the same initial weights (a
``.pth`` drawn from the seed, copied to each arm's output so the CLI
resumes from it; the CLI's ``--seed`` the same) on 2,048 realistic
entries (data seed 0): batch 64, lr 1e-3, T=1000, ``QUALITY_EPOCHS`` epochs of 32 steps
(9,984 steps), ``--clip-grad-norm 1.0``, the data on the card
(``--device-data --steps-per-dispatch 4``). Each arm, and the untrained
weights as the anchor, is scored on 128 held-out realistic entries (seed
1): the held-out loss (the dense fp32 layer, the mean over 32 fixed draws
of t and noise), and ``tools/eval_rmsd`` at T=1000 in the arm's own mode
(the anchor in fp32): mean and largest backbone RMSD and pure-noise
RMSD; a bf16 or fast-f32 arm is also scored in fp32 from the same noise.
Then, on each arm's weights, its fused kernel (#1 in fp32 or high, #2 in
bf16) held against its plain version at ``chip_smoke.TOL`` on phase 3's
inputs, and ``tools/rmsd_backends`` at T=1000 (its default configs) over
the same 128 held-out entries. An arm whose training stops on a NaN loss
is reported as such; any other error fails the study.
One JSON line per measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STUDIES = ("steps-per-graph", "device-data", "quality")
DEFAULT_STUDIES = ("steps-per-graph", "device-data")
QUALITY_EPOCHS = 312  # x 32 steps of batch 64 over 2,048 entries: 9,984 steps
QUALITY_SETS = {"train": (2048, 0), "held_out": (128, 1)}
QUALITY_ARMS = (("fp32", []), ("bf16", ["--bf16"]), ("fast-f32", ["--fast-f32"]))
ARM_MODE = {"fp32": "fp32", "bf16": "bf16", "fast-f32": "high"}  # chip_smoke.MODES


def steps_per_graph(model, entries, card: str, k: int = 100) -> None:
    import torch

    import chip_smoke as cs
    from pmhc_tpu_torch.diffusion import sample, sampler
    from pmhc_tpu_torch.serve import SamplerService
    from pmhc_tpu_torch.utils.graphs import GraphCache

    default = sampler.STEPS_PER_GRAPH
    svc = SamplerService(model, batch_size=cs.B, noise_step_count=cs.STEPS, num_steps=k, bf16=True,
                         seed=7)
    gen = torch.Generator(device=svc.device).manual_seed(5)
    mb, _ = svc.build_model_batch(entries, gen)
    try:
        for S in (1, 10, k):
            sampler.STEPS_PER_GRAPH = S
            cache = GraphCache()

            def run():
                sample(svc.model, mb, svc.diffusion_config, svc.model_config, svc.tables,
                       generator=gen, bf16=True, num_steps=k, graph_cache=cache)

            torch.cuda.synchronize()
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            first = time.monotonic() - t0
            queue, wall = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                run()
                t1 = time.monotonic()
                torch.cuda.synchronize()
                queue.append((t1 - t0) * 1e3 / k)
                wall.append((time.monotonic() - t0) * 1e3 / k)
            cs.log(json.dumps({"metric": "steps_per_graph", "steps_per_graph": S, "steps": k,
                               "batch": cs.B, "mode": "bf16", "first_call_s": first,
                               "queue_ms_per_step": queue, "wall_ms_per_step": wall, "card": card}))
        for S in (1, 10, 10, 1):
            sampler.STEPS_PER_GRAPH = S
            cs.overlap_walls(model, entries, card)
    finally:
        sampler.STEPS_PER_GRAPH = default


def device_data(card: str, n_entries: int = 4096, epochs: int = 3) -> None:
    import chip_smoke as cs

    work = os.path.join(REPO, ".chip_scratch", "studies")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        data = os.path.join(work, "train.npz")
        cs.pack_realistic(data, n_entries, seed=0)
        steps = epochs * (n_entries // cs.B)
        want = {"fwd_fp32": 0, "bwd_fp32": 0, "fwd_bf16": 2 * steps, "bwd_bf16": 2 * steps}
        model = os.path.join(work, "model.pth")
        for K in (1, 4, 4, 1):
            if os.path.exists(model):
                os.remove(model)
            stats = cs.offline_train([data, str(epochs), model, "--batch-size", str(cs.B), "--bf16",
                                      "--device-data", "--steps-per-dispatch", str(K)],
                                     want, card, f"bf16 device-data K={K}")
            cs.log(json.dumps({"metric": "device_data_steps_per_dispatch", "steps_per_dispatch": K,
                               "batch": cs.B, "entries": n_entries,
                               "examples_per_s": [e["examples_per_s"] for e in stats["epochs"]],
                               "epoch_s": [e["seconds"] for e in stats["epochs"]], "card": card}))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def held_out_loss(model_path: str, data_path: str, draws: int = 32, seed: int = 7000) -> float:
    """The mean total loss of ``model_path``'s weights over the entries of
    ``data_path``, ``draws`` times with fixed (t, noise) draws, through the
    dense fp32 layer (every arm measured the same way)."""
    import torch

    from pmhc_tpu_torch.data import PackedDataset
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.models.import_params import load_params
    from pmhc_tpu_torch.train import MetricsRecord, Trainer

    import chip_smoke as cs

    trainer = Trainer(ScoreNetworkConfig(backend="dense"), params=load_params(model_path))
    data = PackedDataset.load(data_path)
    batches = [data.get_batch(list(range(i, min(i + cs.B, len(data)))))
               for i in range(0, len(data), cs.B)]
    metrics = MetricsRecord()
    for d in range(draws):
        for j, batch in enumerate(batches):
            gen = torch.Generator(device=trainer.device).manual_seed(seed + 1000 * d + j)
            trainer.eval_batch(batch, gen, metrics)
    return float(metrics.mean()["total loss"])


def trained_kernel_check(model_path: str, arm: str) -> dict:
    """The arm's fused kernel (``ARM_MODE``) against its plain version on
    the arm's trained weights: phase 3's batch-64 inputs of both layer
    shapes; the max abs error per output, checked at ``chip_smoke.TOL``."""
    import torch

    import chip_smoke as cs
    from pmhc_tpu_torch.models.import_params import load_checkpoint
    from pmhc_tpu_torch.ops import egnn_fused as ef

    mode, dev = ARM_MODE[arm], torch.device("cuda")
    model = load_checkpoint(model_path).to(dev).eval()
    errs = {}
    for i, layer in enumerate(("gnn1", "gnn2")):
        args = cs.layer_case(model, layer, seed=i + 1, device=dev)
        got = ef.egnn_fused(*args, bf16=ef.FLAGS[mode])
        want = ef.egnn_fused_plain(*args, bf16=ef.FLAGS[mode])
        for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
            errs[f"{layer} {name}"] = err = float((g - w).abs().max())
            if not (err <= cs.TOL[mode][name] and bool(torch.isfinite(g).all())):
                raise AssertionError(f"{arm} weights: kernel {mode} {layer} {name} disagrees with "
                                     f"its plain version ({err:.3e} > {cs.TOL[mode][name]:.0e})")
    return errs


def quality_seed(card: str, seed: int, work: str, paths: dict, score) -> None:
    """One seed of the quality study: the untrained weights drawn from
    ``seed`` scored as the anchor, then each arm trained from them (the
    CLI's ``--seed``: batch order and noise), scored and cross-checked."""
    import torch

    import chip_smoke as cs
    from pmhc_tpu_torch.cli import train_cli
    from pmhc_tpu_torch.models import ScoreNetwork
    from pmhc_tpu_torch.tools import rmsd_backends

    init = os.path.join(work, f"init_{seed}.pth")
    torch.save(ScoreNetwork(generator=torch.Generator().manual_seed(seed)).state_dict(), init)
    anchor = {"held_out_loss": held_out_loss(init, paths["held_out"]), **score(init, [])}
    cs.log(json.dumps({"metric": "quality_anchor", "weights": "untrained", "seed": seed, **anchor,
                       "card": card}))
    steps = QUALITY_EPOCHS * (QUALITY_SETS["train"][0] // cs.B)
    for arm, flags in QUALITY_ARMS:
        model = os.path.join(work, f"{arm}_{seed}.pth")
        shutil.copyfile(init, model)  # the CLI resumes from its output file
        t0 = time.monotonic()
        row = {"metric": "quality_arm", "arm": arm, "seed": seed, "steps": steps, "batch": cs.B,
               "lr": 1e-3, "clip_grad_norm": 1.0, "T": cs.STEPS}
        try:
            stats = train_cli.main(
                [paths["train"], str(QUALITY_EPOCHS), model, "--batch-size", str(cs.B),
                 "--lr", "1e-3", "--clip-grad-norm", "1.0", "--device-data",
                 "--steps-per-dispatch", "4", "--seed", str(seed), "--device", "cuda"] + flags)
        except RuntimeError as e:
            if not str(e).startswith("NaN loss"):
                raise
            cs.log(json.dumps({**row, "failed": f"{type(e).__name__}: {e}",
                               "train_s": time.monotonic() - t0, "untrained": anchor,
                               "card": card}))
            continue
        train_s = time.monotonic() - t0
        t1 = time.monotonic()
        res = {"held_out_loss": held_out_loss(model, paths["held_out"]), **score(model, flags)}
        if flags:
            res["in_fp32"] = score(model, [])
        cs.log(json.dumps({**row, "ran": stats["precision"], **res, "train_s": train_s,
                           "train_examples_per_s": [e["examples_per_s"]
                                                    for e in stats["epochs"][-3:]],
                           "score_s": time.monotonic() - t1, "untrained": anchor,
                           "card": card}))
        cs.log(json.dumps({"metric": "quality_kernel_vs_plain", "arm": arm, "seed": seed,
                           "mode": ARM_MODE[arm], "max_abs_err": trained_kernel_check(model, arm),
                           "card": card}))
        out = rmsd_backends.main([model, "-T", str(cs.STEPS), "--entries",
                                  str(QUALITY_SETS["held_out"][0]), "--data", "realistic",
                                  "--seed", str(QUALITY_SETS["held_out"][1]), "--device", "cuda"])
        cs.log(json.dumps({"metric": "quality_rmsd_backends", "arm": arm, "seed": seed,
                           "verdict": out["verdict"], "failures": out["failures"],
                           "rows": [{k: r.get(k) for k in ("backend", "precision", "runs",
                                                            "rmsd_mean", "rmsd_std", "rmsd_max",
                                                            "rel_gap_vs_baseline")}
                                    for r in out["rows"]], "card": card}))


def quality(card: str, seeds=(0,)) -> None:
    import chip_smoke as cs
    from pmhc_tpu_torch.tools import eval_rmsd

    work = os.path.join(REPO, ".chip_scratch", "quality")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.monotonic()
        paths = {}
        for name, (n, seed) in QUALITY_SETS.items():
            paths[name] = os.path.join(work, f"{name}.npz")
            cs.pack_realistic(paths[name], n, seed)
        cs.log(f"quality: data in {time.monotonic() - t0:.1f} s")

        def score(model: str, flags: list) -> dict:
            rep = eval_rmsd.main([model, paths["held_out"], "-T", str(cs.STEPS), "-b", str(cs.B),
                                  "--device", "cuda"] + flags)
            worst = sorted(rep["per_entry"].items(), key=lambda kv: -kv[1])[:3]
            return {"mean_backbone_rmsd": rep["mean_backbone_rmsd"],
                    "max_backbone_rmsd": worst[0][1], "worst_entries": dict(worst),
                    "mean_pure_noise_rmsd": rep["mean_pure_noise_rmsd"],
                    "entries": rep["entries"], "precision": rep["precision"]}

        for seed in seeds:
            quality_seed(card, seed, work, paths, score)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("studies", nargs="*", metavar="STUDY",
                    help=f"any of {', '.join(STUDIES)} (default: {' '.join(DEFAULT_STUDIES)})")
    ap.add_argument("--seeds", default="0",
                    help="quality: comma list of seeds (initial weights, batch order, noise)")
    args = ap.parse_args()
    studies = args.studies or list(DEFAULT_STUDIES)
    unknown = [s for s in studies if s not in STUDIES]
    if unknown:
        print(f"chip_studies: unknown {unknown}; choose from {STUDIES}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "pmhc_tpu_torch")):
        print("chip_studies: pmhc_tpu_torch/ not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("chip_studies: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    if "steps-per-graph" in studies:
        model = cs.random_model(seed=0).to("cuda").eval()
        steps_per_graph(model, [cs.request_entry(seed=200 + i) for i in range(cs.B)], card)
    if "device-data" in studies:
        device_data(card)
    if "quality" in studies:
        quality(card, [int(x) for x in args.seeds.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
