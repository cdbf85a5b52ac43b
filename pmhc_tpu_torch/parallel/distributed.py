"""Process groups: one process per GPU.

Counterpart of ``pmhc_tpu/parallel/distributed.py``. The JAX package is
single-controller: one process drives every device, and on a pod each
host calls ``jax.distributed.initialize()`` with defaults from the TPU
metadata service. Here every GPU has its own process, and
``initialize_multihost`` joins it to the group with
``torch.distributed.init_process_group``: its defaults come from
``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). On a CUDA device the group is
NCCL, and the rank's card is made the current device before anything is
built or launched; the CPU (``device="cpu"``, the tests) takes gloo.
Every group waits at most ``TIMEOUT_S`` in a collective.

``spawn`` starts ``world`` local ranks with that environment, for the CLIs
(``--mesh-data`` outside ``torchrun``) and the tests: the ``spawn`` start
method, a join deadline, the children killed when it passes. A rank ends
its process with ``leave``, its group not torn down: on 4 cards an NCCL
teardown after captured collectives never returned.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import socket
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the longest a collective waits for its peers before it raises
TIMEOUT_S = 300.0
# the CUDA sources a card's rank may launch, built by local rank 0 on joining
KERNELS = ("egnn_fused", "egnn_loop", "egnn_pallas")


def launched() -> bool:
    """Whether this process was started as one rank of a group
    (``torchrun`` or ``spawn``): ``WORLD_SIZE`` and ``RANK`` are set."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> torch.device:
    """Join this process to the group; returns its device.

    ``coordinator_address`` is ``host:port`` of rank 0 (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (``WORLD_SIZE``), ``process_id`` this rank (``RANK``). ``device``
    (default the card) picks the backend: ``"cuda"`` NCCL, with the card
    ``LOCAL_RANK`` (default rank modulo the cards) made current, and
    without a card it raises; ``"cpu"`` gloo. On a card, local rank 0
    builds the kernels (``KERNELS``, one nvcc each, all at once) while the
    other ranks wait, so each rank then loads the built libraries.
    """
    dev = torch.device("cuda" if device is None else device)
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    init = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; pass device='cpu' "
                               "for a gloo group on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        # device_id: the communicator is made now, before any capture
        dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank,
                                timeout=timeout, device_id=dev)
        # one nvcc per source on this host, not one per rank
        if local == 0:
            from pmhc_tpu_torch.ops import _build

            with ThreadPoolExecutor(len(KERNELS)) as pool:
                list(pool.map(_build.build, KERNELS))
        dist.barrier()
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                                timeout=timeout)
    else:
        raise ValueError(f"no process group for device {dev}: use cuda or cpu")
    return dev


def loader_shard_args() -> dict:
    """kwargs for ``PrefetchLoader`` giving this process its entry shard."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1}
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size()}


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def leave(code: int = 0) -> None:
    """End this rank's process with ``code``, its group not torn down.
    With ``code`` 0 the rank first meets the others at a barrier: rank 0
    holds the group's store, so no rank leaves while another may still use
    it (a failed barrier ends the process with 1)."""
    if code == 0 and dist.is_initialized():
        try:
            dist.barrier()
        except Exception:  # noqa: BLE001 — printed, then the exit code says it
            traceback.print_exc()
            code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _child(inbox, rank: int, world: int, port: int, device, out) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    code = 0
    try:
        fn, args = inbox.get()
        if device is not None:
            initialize_multihost(device=device)
        out.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        code = 1
    # the result is sent before the process ends
    out.close()
    out.join_thread()
    leave(code)


def spawn(fn: Callable, world: int, args: Sequence = (), device=None,
          timeout: Optional[float] = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes, rank r with torchrun's
    environment for rank r of ``world`` on localhost; returns the results
    by rank. With ``device`` each child joins the group
    (``initialize_multihost(device=device)``) before ``fn``. ``fn`` and
    its arguments and result must pickle. A child that raises, dies or
    outlives ``timeout`` seconds (None: no deadline) fails the call: the
    others are killed and a ``RuntimeError`` names the rank. A child ends
    with ``leave`` once its result is sent."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    # the work goes through a queue, not the start arguments: a start
    # writes them to a pipe the child reads only once it has started up,
    # which would start the ranks one after another
    inboxes = [ctx.Queue() for _ in range(world)]
    procs = [ctx.Process(target=_child, args=(inboxes[r], r, world, port, device, out),
                         daemon=True) for r in range(world)]
    for p, inbox in zip(procs, inboxes):
        p.start()
        inbox.put((fn, args))
    results: dict = {}
    deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=min(1.0, max(0.0, deadline - time.monotonic())))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code {procs[dead[0]].exitcode})")
                if time.monotonic() >= deadline:
                    missing = [r for r in range(world) if r not in results]
                    raise RuntimeError(f"ranks {missing} did not finish within {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        leave = time.monotonic() + 30
        for p in procs:
            p.join(max(0.0, leave - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [results[r] for r in range(world)]
