"""Command-line entry points of the port (``python -m pmhc_tpu_torch.cli.<name>``).

The train and sample CLIs take the JAX CLIs' ``--mesh-*`` flags. A mesh
runs one process per device (``parallel/distributed.py``): under
``torchrun`` each rank joins the group and ends its process when the run
is done (``parallel.distributed.leave``); inside a group already made it
runs on it; otherwise the CLI starts the mesh's ranks itself (``spawn``)
and returns rank 0's result, so a flag means what it means in the JAX
package, where one process drives every device.
"""

from __future__ import annotations

import logging
import traceback
from typing import Callable, Optional, Sequence

# how long a CLI waits for the ranks it started (None: no deadline; a stuck
# collective raises after ``parallel.distributed.TIMEOUT_S`` all the same)
SPAWN_TIMEOUT_S: Optional[float] = None


def mesh_world(args, device: str) -> int:
    """The devices a CLI's mesh flags ask for when it starts the ranks
    itself: the JAX package's ``make_mesh`` sizes with the data axis, when
    not given, made of every card (one on the CPU)."""
    import torch

    model = getattr(args, "mesh_model", 1)
    context = max(1, args.mesh_context)
    data = getattr(args, "mesh_data", 0)
    if not data:
        cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
        data = max(1, cards // (model * context))
    return data * model * context


def run_on_mesh(main: Callable, argv: Sequence[str], world: int, device: str,
                run: Callable[[], object]):
    """Run a CLI on its mesh: inside a group, ``run()`` on this rank; in a
    process started as a rank (``torchrun``), join the group, ``run()``,
    and end the process as a spawned rank does (``leave``: a barrier, the
    group not torn down); else ``main(argv)`` on ``world`` ranks started
    here, each joining the group first, and rank 0's result."""
    import torch.distributed as dist

    from pmhc_tpu_torch.parallel.distributed import initialize_multihost, launched, leave, spawn

    if not dist.is_initialized():
        if not launched():
            return spawn(main, world, args=(list(argv),), device=device,
                         timeout=SPAWN_TIMEOUT_S)[0]
        initialize_multihost(device=device)
        try:
            _quiet_unless_rank0()
            run()
        except BaseException:
            if dist.get_backend() == "gloo":
                # a CPU group is torn down and the error raised: the caller
                # may go on in this process
                dist.destroy_process_group()
                raise
            traceback.print_exc()
            leave(1)
        leave(0)
    _quiet_unless_rank0()
    return run()


def _quiet_unless_rank0() -> None:
    """Only rank 0 logs below warnings."""
    import torch.distributed as dist

    if dist.get_rank() != 0:
        logging.getLogger().setLevel(logging.WARNING)
