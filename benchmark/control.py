"""The readings the output check's limits are set from: a cell's driver run on
many seeds in one process, as the program (its sound runs), with the
control (the program's own bf16 path, the precision below the
configuration's) and with planted faults (``benchmark/faults.py``), each
with a short window at the cell's own load. Prints one JSON line a run
with the numbers compared.

    python3 -m benchmark.control --workload f32.sample.b64 --seconds 3 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --fault altered_answer:31,32,33

Not part of a benchmark run.
"""

from __future__ import annotations

import json
import sys
import time
from argparse import ArgumentParser


def main(argv=None) -> int:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[], help="NAME:seed,seed,...")
    args = p.parse_args(argv)
    from benchmark import faults, harness
    from benchmark.run import cache_dirs

    cache_dirs(harness.ROOT)
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell.traffic["driver"])
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [(s, None, None) for s in seeds(args.seeds)]
    runs += [(s, "bf16", None) for s in seeds(args.control_seeds)]
    for f in args.fault:
        name, _, ss = f.partition(":")
        runs += [(s, None, name) for s in seeds(ss)]
    for seed, mode, fault in runs:
        t = time.monotonic()
        extra = {}
        if fault and cell.traffic["driver"] == "train_mesh":
            extra["prepare"], fault_here = faults.FAULTS[fault], None
        else:
            fault_here = fault
        with faults.planted(fault_here):
            rec = drv.run(cell, seed=seed, seconds=args.seconds, trace=False, t0=t, mode=mode,
                          **extra)
        print(json.dumps({"workload": cell.name, "seed": seed, "mode": mode or cell.config["mode"],
                          "fault": fault, "checks": rec.checks, "failed": rec.failed,
                          "correct": harness.verdict(rec), "run_s": time.monotonic() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
