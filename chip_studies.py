#!/usr/bin/env python3
"""Measure, on one card, the two host-path choices behind the port's
defaults: how many sampler steps a CUDA graph holds
(``diffusion/sampler.py::STEPS_PER_GRAPH``), and whether the train CLI's
``--device-data --steps-per-dispatch K`` branch (``Trainer.train_indices``)
is faster than one step a dispatch.

    python3 chip_studies.py [steps-per-graph] [device-data]

(both when none is named). ``steps-per-graph``: the strided batch-64
bf16 chain of 100 steps (the fastest kernel, so the most host-bound) from
graphs of 1, 10 and 100 steps, each from a new cache: the first call's
seconds (its eager steps and the capture), then over 3 calls the host's
milliseconds per step to queue the chain and the wall per step to its
end; then ``chip_smoke.overlap_walls`` (the sample CLI's loop, 3 T=1000
fp32 batches) from graphs of 1 and 10 steps, in turns 1, 10, 10, 1.
``device-data``: ``train_cli`` in bf16 with ``--device-data`` over 4,096
realistic entries (64 batches of 64 an epoch, 3 epochs, a new model each
run) at ``--steps-per-dispatch`` 1 and 4, in turns 1, 4, 4, 1, with the
loop kernels' launches checked; epoch 0 holds the captures. One JSON line
per measurement, the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STUDIES = ("steps-per-graph", "device-data")


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


def main() -> int:
    studies = sys.argv[1:] or list(STUDIES)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
