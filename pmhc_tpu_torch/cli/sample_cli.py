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

``--mesh-context N`` (or ``--backend cp`` / ``ring``) samples on a
``("data", "model", "context")`` mesh, one process per device, as the
JAX CLI's ``sample_sharded`` does: the neighbour axis split over N ranks,
the batch over the data axis (every card the context axis leaves; one on
the CPU). Under ``torchrun`` each rank joins the group, else the CLI
starts the ranks itself; every rank builds the same noised batches, and
rank 0 writes every PDB.

``--score-network structure`` samples with the second score network,
ESMFold's structure module (``models/structure.py``; a ``.pth`` of its
``state_dict``), in fp32 or with ``--bf16``, on one device.

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

from pmhc_tpu_torch.cli import mesh_world, run_on_mesh

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
    p.add_argument("--score-network", default="egnn", choices=("egnn", "structure"),
                   help="egnn: the published 2-layer EGNN; structure: ESMFold's structure "
                        "module (invariant point attention; fp32 or --bf16, one device, no "
                        "--fast-f32, no mesh)")
    p.add_argument("--mesh-context", type=int, default=1,
                   help="devices on the context-parallel axis: the EGNN neighbour axis split "
                        "(backend cp or ring; selects cp if --backend is not one of them)")
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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=logging.DEBUG if args.debug else logging.INFO)
    if args.mesh_context > 1 or args.backend in ("cp", "ring"):
        if args.score_network == "structure":
            raise SystemExit("--score-network structure samples on one device: "
                             "no --mesh-context, no --backend cp / ring")
        from pmhc_tpu_torch.parallel.distributed import launched

        world = mesh_world(args, args.device)
        if world > 1 or launched():
            return run_on_mesh(main, argv, world, args.device, lambda: _main(args, True))
    return _main(args, False)


def _main(args, on_mesh: bool):
    if args.profile_dir:
        from pmhc_tpu_torch.utils.profiling import profile_trace

        _log.info("tracing the whole run into %s", args.profile_dir)
        with profile_trace(args.profile_dir):
            return _run(args, on_mesh)
    return _run(args, on_mesh)


def sharded_service(mesh):
    """``SamplerService`` whose chain is ``make_sample_sharded``'s on ``mesh``."""
    from pmhc_tpu_torch.diffusion.sampler import make_sample_sharded
    from pmhc_tpu_torch.serve import SamplerService

    class ShardedService(SamplerService):
        def __init__(self, params, **kwargs):
            super().__init__(params, **kwargs)
            self.sharded = make_sample_sharded(self.diffusion_config, self.model_config, mesh,
                                               self.tables, self.mode, self.num_steps, self.graphs)

        def sample_model_batch(self, model_batch, generator, injected_noise=None):
            return self.sharded(self.model, model_batch, generator, injected_noise)

    return ShardedService


def _run(args, on_mesh: bool):
    from pmhc_tpu_torch.data import PrefetchLoader
    from pmhc_tpu_torch.data.packed import open_dataset
    from pmhc_tpu_torch.data.validate import validate_or_exit
    from pmhc_tpu_torch.models.import_params import load_params
    from pmhc_tpu_torch.serve import SamplerService

    t_start = time.monotonic()

    if args.validate_data:
        validate_or_exit(args.test_hdf5)

    backend, device, writer, service_class = args.backend, args.device, True, SamplerService
    if on_mesh:
        import torch
        import torch.distributed as dist

        from pmhc_tpu_torch.parallel import make_mesh

        if backend not in ("cp", "ring"):
            backend = "cp"
            _log.info("--mesh-context %d: selecting backend 'cp'", args.mesh_context)
        mesh = make_mesh(n_context=max(1, args.mesh_context))
        if mesh.get_coordinate() is None:
            _log.info("this rank is outside the %s mesh: nothing to do", tuple(mesh.shape))
            return None
        _log.info("mesh data %d x model %d x context %d", *mesh.shape)
        if mesh.device_type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        writer = dist.get_rank() == 0
        service_class = sharded_service(mesh)
    service = service_class(load_params(args.model, args.score_network),
                            architecture=args.score_network, batch_size=args.batch_size,
                            noise_step_count=args.T, num_steps=args.sample_steps,
                            backend=backend, bf16=args.bf16, fast_f32=args.fast_f32,
                            seed=args.seed, device=device,
                            graphs=False if args.eager else None)
    _log.info("backend %r -> %s, %s, on %s", args.backend, service.backend, service.precision,
              service.device)

    dataset = open_dataset(args.test_hdf5)
    loader = PrefetchLoader(dataset, batch_size=args.batch_size, num_workers=args.num_workers)

    output_path = args.output_dir or os.path.splitext(args.test_hdf5)[0] + "-sampled"
    if writer:
        os.makedirs(output_path, exist_ok=True)

    stats = []

    def write(pending) -> None:
        """Wait for a dispatched batch's arrays; write its PDBs."""
        handle, out_names = pending
        # on a mesh every rank holds the batch; rank 0 writes it
        if not writer:
            handle.wait()
            return
        for name, pdb in zip(out_names, SamplerService.finalize(handle)):
            with open(os.path.join(output_path, f"{name}.pdb"), "wb") as f:
                f.write(pdb)

    counter = 0
    pending = None  # the batch dispatched last, its PDBs not yet written
    for batch in loader:
        names = batch.pop("name")
        protein = dataset.get_protein_positions(names)
        entries = [{**{k: v[i] for k, v in batch.items()}, **{k: v[i] for k, v in protein.items()}}
                   for i in range(len(names))]
        for si in range(args.num_samples):
            # each sample: its own generator, so independent noise
            handle = service.dispatch(entries, service.batch_generator(counter), id=counter)
            stats.append({"batch": counter, "entries": handle.n})
            if pending is not None:
                write(pending)  # while this batch samples
            out_names = names if args.num_samples == 1 else [f"{x}.{si + 1}" for x in names]
            pending = (handle, out_names)
            counter += 1
    if pending is not None:
        write(pending)
    wall = time.monotonic() - t_start
    pdbs = sum(b["entries"] for b in stats)
    if writer:
        _log.info("wrote %d PDB files to %s in %.3f s (%.2f PDBs/s)", pdbs, output_path, wall,
                  pdbs / wall)
    return {"wall_s": wall, "pdbs": pdbs, "pdbs_per_s": pdbs / wall, "batches": stats,
            "output_dir": output_path, "precision": service.precision}


if __name__ == "__main__":
    main()
