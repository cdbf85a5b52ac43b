"""Training CLI on the card: the port's twin of ``python optimize.py
train.hdf5 100 model.pth``.

Counterpart of ``pmhc_tpu/cli/train_cli.py``, with its positionals, flags
and semantics: resume from the output model if it exists (strict), a
checkpoint every 100 batches and at each epoch end, per-epoch CSV metrics
next to the model (``<model>.csv``). Run it as

    python -m pmhc_tpu_torch.cli.train_cli train.hdf5 100 model.pth

The data argument (and ``--val-hdf5``) is a SwiftMHC HDF5 file, or a
packed ``.npz`` (``python -m pmhc_tpu_torch.data.packed in.hdf5 out.npz``),
which is what a machine without h5py reads. ``--device`` (default
``cuda``) names the torch device; without a card the run raises unless
given ``--device cpu``. ``--orbax-dir`` keeps its name and holds the port's
full-state checkpoints (``train/checkpoints.py``). Multi-device meshes are
not ported (ROADMAP Queue 1, multi-GPU).

On the card the steps run from CUDA graphs (``Trainer``; ``--eager``
runs them eagerly). With ``--device-data --steps-per-dispatch K`` an
epoch goes as the JAX CLI's fused device pipeline does: the loader's
epoch order cut into rows of a batch's entry indices, each K full rows
one ``Trainer.train_indices`` call (K graph replays, each gathering its
batch from the resident dataset), the full rows left over and the
partial last row one ``train_batch`` each.

``main`` returns per-epoch timings: wall seconds, examples, and the
seconds the step loop waited on the loader (time spent in ``next``), and
the precision the layers ran at (``"f32"``, ``"bf16"``, ``"fast-f32"``).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from argparse import ArgumentParser

from pmhc_tpu_torch.cli import MULTI_GPU

_log = logging.getLogger(__name__)

OPTIMIZER_FLAGS = "--grad-accum, --ema-decay, --clip-grad-norm, --lr-warmup-steps, --lr-decay-steps"


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__)
    p.add_argument("train_hdf5", help="train data: SwiftMHC HDF5, or a packed .npz")
    p.add_argument("epoch_count", type=int, help="number of epochs over the data")
    p.add_argument("output_model", help="output model parameters file (.pth)")
    p.add_argument("--debug", "-d", action="store_const", const=True, default=False,
                   help="debug logging and autograd anomaly detection")
    p.add_argument("-T", type=int, default=1000, help="number of noise steps")
    p.add_argument("--batch-size", "-b", type=int, default=64, help="data batch size")
    p.add_argument("--num-workers", "-w", type=int, default=4,
                   help="number of batch loading threads")
    p.add_argument("--lr", type=float, default=0.001, help="learning rate")
    p.add_argument("--pack", action="store_true",
                   help="decode the HDF5 once into RAM-packed arrays (a no-op on a packed .npz)")
    p.add_argument("--device-data", action="store_true",
                   help="keep the packed dataset resident on the device and gather batches "
                        "there (implies --pack)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="devices on the data axis (not ported: only 0)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="devices on the model axis (not ported: only 1)")
    p.add_argument("--mesh-context", type=int, default=1,
                   help="devices on the context axis (not ported: only 1)")
    p.add_argument("--orbax-dir", default=None,
                   help="directory for full-state checkpoints (weights, optimizer, generators)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mode of the loop kernels (the fused backend; pallas runs fp32)")
    p.add_argument("--fast-f32", action="store_true",
                   help="high mode of the loop kernels: their products split into bf16 "
                        "hi/lo halves, ~1.5e-5 relative (the fused backend; pallas runs "
                        "fp32; --bf16 wins)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema-decay", type=float, default=None,
                   help="EMA of the parameters, exported with every save as <model>.ema.pth")
    p.add_argument("--restart-on-nan", type=int, default=0,
                   help="on a NaN loss, restore the last checkpoint (full state with "
                        "--orbax-dir, else the .pth with a fresh optimizer), reseed and go on, "
                        "at most this many times (0 = abort)")
    p.add_argument("--clip-grad-norm", type=float, default=None,
                   help="global-norm gradient clipping (off by default)")
    p.add_argument("--lr-warmup-steps", type=int, default=0,
                   help="linear LR warmup over this many optimizer steps")
    p.add_argument("--lr-decay-steps", type=int, default=None,
                   help="cosine LR decay to --lr-final over this total horizon")
    p.add_argument("--lr-final", type=float, default=0.0,
                   help="final LR for --lr-decay-steps (default 0)")
    p.add_argument("--val-hdf5", default=None, metavar="PATH",
                   help="held-out data (HDF5 or .npz) evaluated after every epoch into "
                        "<model>.val.csv (and <model>.val.ema.csv with --ema-decay); the "
                        "noise and timesteps are fixed per batch index")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="average gradients over K batches per optimizer update")
    p.add_argument("--per-sample-t", action="store_true",
                   help="draw one timestep per sample instead of per batch")
    p.add_argument("--validate-data", action="store_true",
                   help="check the HDF5 against the SwiftMHC schema before training")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the whole run to DIR")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="group K full batches into one train_batches call (with "
                        "--device-data: one train_indices call on the batches' index rows)")
    p.add_argument("--eager", action="store_true",
                   help="run the steps eagerly instead of from CUDA graphs (debugging)")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "xla", "pallas", "pallas_lane", "g8",
                            "blockwise", "cp", "ring"),
                   help="EGNN layer: auto / pallas_lane / g8 the loop kernels; pallas the "
                        "round-1 fused kernel's forward; xla the dense layer")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the kernels' plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=logging.DEBUG if args.debug else logging.INFO)
    if args.mesh_data > 0 or args.mesh_model > 1 or args.mesh_context > 1:
        raise NotImplementedError(f"--mesh-data/--mesh-model/--mesh-context: {MULTI_GPU}")
    if args.debug:
        from pmhc_tpu_torch.utils.profiling import enable_nan_debugging

        enable_nan_debugging(True)
    try:
        if args.profile_dir:
            from pmhc_tpu_torch.utils.profiling import profile_trace

            _log.info("tracing the whole run into %s (keep the run short)", args.profile_dir)
            with profile_trace(args.profile_dir):
                return _run(args)
        return _run(args)
    finally:
        if args.debug:
            enable_nan_debugging(False)


def _run(args):
    import torch

    from pmhc_tpu_torch.data import DeviceDataset, PackedDataset, PrefetchLoader
    from pmhc_tpu_torch.data.packed import open_dataset
    from pmhc_tpu_torch.data.validate import validate_or_exit
    from pmhc_tpu_torch.diffusion import DiffusionConfig
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.models.import_params import load_checkpoint
    from pmhc_tpu_torch.models.score import resolve_backend
    from pmhc_tpu_torch.serve import batch_seed, resolve_device
    from pmhc_tpu_torch.train import CheckpointManager, MetricsRecord, TrainConfig, Trainer
    from pmhc_tpu_torch.train.trainer import save_state_dict

    if args.validate_data:
        validate_or_exit(args.train_hdf5)

    device = resolve_device(args.device)
    backend = resolve_backend(args.backend)
    _log.info("backend %r -> %s on %s", args.backend, backend, device)

    model_config = ScoreNetworkConfig(noise_step_count=args.T, backend=backend)
    diffusion_config = DiffusionConfig(noise_step_count=args.T,
                                       t_per_batch=not args.per_sample_t)
    train_config = TrainConfig(
        learning_rate=args.lr, batch_size=args.batch_size, seed=args.seed,
        grad_clip_norm=args.clip_grad_norm, ema_decay=args.ema_decay,
        lr_warmup_steps=args.lr_warmup_steps, lr_decay_steps=args.lr_decay_steps,
        lr_final=args.lr_final, grad_accum=max(1, args.grad_accum),
        # the CLI checks for NaN itself (every 100 batches and at epoch end)
        nan_check_every=0,
    )

    params = None
    if os.path.isfile(args.output_model):
        _log.info("resuming from %s", args.output_model)
        params = load_checkpoint(args.output_model, model_config).state_dict()
    trainer = Trainer(model_config, diffusion_config, train_config, params=params,
                      bf16=args.bf16, fast_f32=args.fast_f32, device=device,
                      graphs=False if args.eager else None)
    _log.info("precision %s", trainer.precision)

    ckpt_mgr = None
    if args.orbax_dir:
        ckpt_mgr = CheckpointManager(args.orbax_dir)
        if ckpt_mgr.latest_step() is not None:
            state = ckpt_mgr.restore()
            try:
                trainer.load_checkpoint_state(state)
            except (ValueError, TypeError, KeyError) as e:
                raise SystemExit(
                    f"checkpoint restore from {args.orbax_dir} failed with a structure "
                    f"mismatch: {e}\nLikely cause: this run's optimizer flags ({OPTIMIZER_FLAGS}) "
                    "differ from the run that wrote the checkpoint. Re-run with the original "
                    "flags, or point --orbax-dir at a fresh directory (resume the weights only "
                    "through the .pth).") from e
            _log.info("restored checkpoint at step %d", trainer.global_step)

    dataset = open_dataset(args.train_hdf5, pack=args.pack or args.device_data)
    if isinstance(dataset, PackedDataset):
        _log.info("packed %d entries (%.0f MB RAM)", len(dataset), dataset.nbytes / 1e6)
    if args.device_data:
        dataset = DeviceDataset(dataset, device)
        _log.info("dataset resident on %s (%.0f MB)", device, dataset.nbytes / 1e6)
    loader = PrefetchLoader(dataset, batch_size=args.batch_size, shuffle=True, seed=args.seed,
                            num_workers=args.num_workers, device=device)

    ema_path = args.output_model.replace(".pth", ".ema.pth")

    def save_model():
        trainer.save(args.output_model)
        if args.ema_decay:
            save_state_dict(trainer.ema_params, ema_path)
        if ckpt_mgr is not None:
            ckpt_mgr.save(trainer.global_step, trainer.checkpoint_state())
        _log.debug("saved %s", args.output_model)

    metrics_path = args.output_model.replace(".pth", ".csv")
    K = max(1, args.steps_per_dispatch)

    val_loader = None
    if args.val_hdf5:
        val_loader = PrefetchLoader(open_dataset(args.val_hdf5),
                                    batch_size=args.batch_size, shuffle=False,
                                    num_workers=args.num_workers, device=device)

    def val_generator(j: int) -> torch.Generator:
        # the same (t, noise) draws for batch j in every epoch
        return torch.Generator(device=device).manual_seed(batch_seed(args.seed + 104729, j))

    def run_validation(epoch_index):
        if val_loader is None:
            return
        val_metrics = MetricsRecord()
        ema_metrics = MetricsRecord() if args.ema_decay else None
        for j, batch in enumerate(val_loader):
            trainer.eval_batch(batch, val_generator(j), val_metrics)
            if ema_metrics is not None:
                trainer.eval_batch(batch, val_generator(j), ema_metrics,
                                   params=trainer.ema_params)
        val_metrics.save(args.output_model.replace(".pth", ".val.csv"), epoch_index)
        _log.info("epoch %d val: %s", epoch_index, val_metrics.mean())
        if ema_metrics is not None:
            ema_metrics.save(args.output_model.replace(".pth", ".val.ema.csv"), epoch_index)
            _log.info("epoch %d val (ema): %s", epoch_index, ema_metrics.mean())

    nan_state = {"retries": 0}

    def check_nan(metrics):
        """The NaN guard: abort (the reference's behaviour), or with
        --restart-on-nan N restore the last checkpoint, reseed and hand back
        a clean metrics record, up to N times."""
        if not metrics.has_nan():
            return metrics
        if nan_state["retries"] >= args.restart_on_nan:
            raise RuntimeError("NaN loss")
        nan_state["retries"] += 1
        if ckpt_mgr is not None and ckpt_mgr.latest_step() is not None:
            trainer.load_checkpoint_state(ckpt_mgr.restore())
            src = f"checkpoint step {trainer.global_step}"
        elif os.path.isfile(args.output_model):
            trainer.model.load_state_dict(
                load_checkpoint(args.output_model, model_config).state_dict(), strict=True)
            trainer.reset_optimizer()
            src = (f"{args.output_model} (weights only; Adam moments, grad-accum accumulator "
                   "and EMA reset)")
        else:
            raise RuntimeError("NaN loss (no checkpoint to restart from)")
        # a fresh noise trajectory: the saved generators would replay the
        # draws that diverged
        trainer.reseed(batch_seed(args.seed, 7919 + nan_state["retries"]))
        _log.warning("NaN loss: restored %s, reseeded the generators (retry %d/%d); epoch CSV "
                     "means now cover post-restart batches only",
                     src, nan_state["retries"], args.restart_on_nan)
        return MetricsRecord()

    def end_epoch(epoch_index, metrics, t0, examples, wait, stats):
        metrics = check_nan(metrics)
        save_model()
        seconds = time.monotonic() - t0
        if len(metrics):  # empty after an epoch-end NaN recovery
            metrics.save(metrics_path, epoch_index)
            _log.info("epoch %d: %s", epoch_index, metrics.mean())
        _log.info("epoch %d: %d examples in %.3f s (%.1f examples/s), loader wait %s s",
                  epoch_index, examples, seconds, examples / seconds, wait)
        stats.append({"epoch": epoch_index, "seconds": seconds, "examples": examples,
                      "examples_per_s": examples / seconds, "loader_wait_s": wait})
        run_validation(epoch_index)

    B = args.batch_size
    if args.device_data and K > 1:
        # rows of entry indices in the epoch's order: K full rows are one
        # train_indices call, the rest one train_batch each
        def epoch_items():
            order = loader.next_epoch_indices()
            return [order[i:i + B] for i in range(0, len(order), B)]

        size = len

        def run(rows, metrics):
            if len(rows) == K and len(rows[-1]) == B:
                trainer.train_indices(dataset, rows, metrics)
            else:
                trainer.train_batches([dataset.get_batch(list(r)) for r in rows], metrics)
    else:
        def epoch_items():
            return loader

        def size(batch):
            return len(batch["name"])

        def run(batches, metrics):
            trainer.train_batches(batches, metrics)

    stats = []
    for epoch_index in range(args.epoch_count):
        _log.debug("starting epoch %d", epoch_index)
        t0 = time.monotonic()
        metrics = MetricsRecord()
        pending = []
        wait = 0.0
        examples = 0
        items = iter(epoch_items())
        i = 0
        while True:
            tw = time.monotonic()
            item = next(items, None)
            wait += time.monotonic() - tw
            if item is None:
                break
            examples += size(item)
            pending.append(item)
            if len(pending) == K or size(item) < B:
                # K batches, or a partial final batch with the ones before it
                run(pending, metrics)
                pending = []
            if i > 0 and i % 100 == 0:
                metrics = check_nan(metrics)
                save_model()
            i += 1
        run(pending, metrics)  # leftover batches (< K)
        end_epoch(epoch_index, metrics, t0, examples, wait, stats)
    return {"epochs": stats, "precision": trainer.precision}


if __name__ == "__main__":
    main()
