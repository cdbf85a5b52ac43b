"""Sampling CLI on the card: the port's twin of ``python test.py model.pth
test.hdf5``.

Counterpart of ``pmhc_tpu/cli/sample_cli.py``, with its positionals and
flags: load the weights, replace every peptide's frames and torsions with
pure noise, run the reverse diffusion, merge the stored full-protein atoms
and write one PDB per entry into ``<data stem>-sampled/`` (``<name>.pdb``,
or ``<name>.<k>.pdb`` with ``--num-samples`` above 1). Run it as

    python -m pmhc_tpu_torch.cli.sample_cli model.pth test.hdf5

The model is a reference-format ``.pth`` or a directory of the port's
checkpoints (its latest step's ``"model"``). The data is a SwiftMHC HDF5
file or a packed ``.npz``. Each batch goes through
``SamplerService.dispatch`` / ``finalize`` (a short last batch is padded by
repeating row 0; only the real rows are written). As the JAX CLI does,
batch i's PDBs are written while batch i+1 samples: on the card the chain
runs from CUDA graphs (``--eager`` runs it eagerly), so ``dispatch``
returns while the card still samples, and ``finalize`` waits only for
its own batch's arrays. ``--device`` defaults to ``cuda``.

``main`` returns the whole call's wall seconds (weights and data loaded,
every PDB written) and PDBs per second, and per batch the host seconds
queueing the sampler, the seconds then waited for its arrays (after the
next batch was queued), and the seconds of the PDB text and file writes,
and the precision the layers ran at (``"f32"``, ``"bf16"``, ``"fast-f32"``).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from argparse import ArgumentParser

from pmhc_tpu_torch.cli import MULTI_GPU

_log = logging.getLogger(__name__)


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__)
    p.add_argument("model", help="model parameters: a .pth, or a checkpoint directory")
    p.add_argument("test_hdf5", help="test data: SwiftMHC HDF5, or a packed .npz")
    p.add_argument("--debug", "-d", action="store_const", const=True, default=False)
    p.add_argument("-T", type=int, default=1000, help="number of noise steps")
    p.add_argument("--batch-size", "-b", type=int, default=64, help="data batch size")
    p.add_argument("--num-workers", "-w", type=int, default=4,
                   help="number of batch loading threads")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default=None,
                   help="override the default <stem>-sampled output directory")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "xla", "pallas", "pallas_lane", "g8",
                            "blockwise", "cp", "ring"),
                   help="EGNN layer: auto / pallas_lane / g8 the fused kernel; pallas the "
                        "round-1 fused kernel (fp32 only); xla the dense layer")
    p.add_argument("--mesh-context", type=int, default=1,
                   help="devices on the context axis (not ported: only 1)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mode of the fused kernel (auto / pallas_lane / g8 only)")
    p.add_argument("--fast-f32", action="store_true",
                   help="high mode of the fused kernel: its products split into bf16 "
                        "hi/lo halves, ~1.5e-5 relative (auto / pallas_lane / g8 only; "
                        "--bf16 wins)")
    p.add_argument("--validate-data", action="store_true",
                   help="check the HDF5 against the SwiftMHC schema before sampling")
    p.add_argument("--num-samples", type=int, default=1,
                   help="conformations per entry, each from independent noise")
    p.add_argument("--sample-steps", type=int, default=None,
                   help="reverse-diffusion jumps per trajectory (default T; fewer run the "
                        "strided sampler)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the whole run to DIR")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the kernels' plain versions)")
    p.add_argument("--eager", action="store_true",
                   help="run the sampler eagerly instead of from CUDA graphs (debugging)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=logging.DEBUG if args.debug else logging.INFO)
    if args.mesh_context > 1:
        raise NotImplementedError(f"--mesh-context: {MULTI_GPU}")
    if args.profile_dir:
        from pmhc_tpu_torch.utils.profiling import profile_trace

        _log.info("tracing the whole run into %s", args.profile_dir)
        with profile_trace(args.profile_dir):
            return _run(args)
    return _run(args)


def _run(args):
    from pmhc_tpu_torch.data import PrefetchLoader
    from pmhc_tpu_torch.data.packed import open_dataset
    from pmhc_tpu_torch.data.validate import validate_or_exit
    from pmhc_tpu_torch.models.import_params import load_params
    from pmhc_tpu_torch.serve import SamplerService

    t_start = time.monotonic()

    if args.validate_data:
        validate_or_exit(args.test_hdf5)

    service = SamplerService(load_params(args.model), batch_size=args.batch_size,
                             noise_step_count=args.T, num_steps=args.sample_steps,
                             backend=args.backend, bf16=args.bf16, fast_f32=args.fast_f32,
                             seed=args.seed, device=args.device,
                             graphs=False if args.eager else None)
    _log.info("backend %r -> %s, %s, on %s", args.backend, service.backend, service.precision,
              service.device)

    dataset = open_dataset(args.test_hdf5, num_workers=args.num_workers)
    loader = PrefetchLoader(dataset, batch_size=args.batch_size, num_workers=args.num_workers)

    output_path = args.output_dir or os.path.splitext(args.test_hdf5)[0] + "-sampled"
    os.makedirs(output_path, exist_ok=True)

    stats = []

    def write(pending) -> None:
        """Wait for a dispatched batch's arrays; write its PDBs."""
        handle, out_names, stat = pending
        t0 = time.monotonic()
        handle.wait()
        t1 = time.monotonic()
        for name, pdb in zip(out_names, SamplerService.finalize(handle)):
            with open(os.path.join(output_path, f"{name}.pdb"), "wb") as f:
                f.write(pdb)
        stats.append({**stat, "wait_s": t1 - t0, "pdb_s": time.monotonic() - t1})

    counter = 0
    pending = None  # the batch dispatched last, its PDBs not yet written
    for batch in loader:
        names = batch.pop("name")
        protein = dataset.get_protein_positions(names)
        entries = [{**{k: v[i] for k, v in batch.items()}, **{k: v[i] for k, v in protein.items()}}
                   for i in range(len(names))]
        for si in range(args.num_samples):
            # each sample: its own generator, so independent noise
            t0 = time.monotonic()
            handle = service.dispatch(entries, service.batch_generator(counter))
            stat = {"batch": counter, "entries": handle.n, "dispatch_s": time.monotonic() - t0}
            if pending is not None:
                write(pending)  # while this batch samples
            out_names = names if args.num_samples == 1 else [f"{x}.{si + 1}" for x in names]
            pending = (handle, out_names, stat)
            counter += 1
    if pending is not None:
        write(pending)
    wall = time.monotonic() - t_start
    pdbs = sum(b["entries"] for b in stats)
    _log.info("wrote %d PDB files to %s in %.3f s (%.2f PDBs/s)", pdbs, output_path, wall,
              pdbs / wall)
    return {"wall_s": wall, "pdbs": pdbs, "pdbs_per_s": pdbs / wall, "batches": stats,
            "output_dir": output_path, "precision": service.precision}


if __name__ == "__main__":
    main()
