"""The fused sampler chain's step outside the layer kernels: the plain
PyTorch versions and the wrappers around the hand-written CUDA kernels of
``csrc/sampler_step.cu``.

On the card the fused backend's chain (``diffusion/sampler.py::FusedForward``)
takes a step in four launches over neighbour inputs that persist over the
chain (``ops/egnn_fused.py::LayerContext``): layer 1 (#1), ``inter_layer``,
layer 2 (#1), ``step``; besides them only the three generator calls of the
step's draws (``diffusion/noise.py::draw_noise``). The two kernels replace
no TPU kernel: the JAX package leaves this work to XLA's fusions of
``sample_lane``'s scan body.

- ``inter_layer``: from layer 1's outputs, layer 2's node input h2 =
  relu(inner) and the peptide rows of its neighbour inputs: a_j = h2 @
  wj_t in ``egnn_fused._project``'s precision (IEEE fp32 in fp32 and high,
  bf16 operands with fp32 sums in bf16: ``bf16`` is an input of the
  kernel), q_j = q1, t_j = t1.
- ``step``: ``remove_noise_scalars`` at the step counter's scalars with
  the noise of the step's draws (``noise.noise_of``), written in place
  into the state and into layer 1's peptide q_j / t_j; unless the step is
  the chain's last, the next step's time column of h1 and layer 1's
  peptide a_j = aj_static + xs[k + 1] * wj_time; the counter advanced.

Each wrapper checks shapes, dtypes, devices and contiguity and raises;
CPU tensors take the plain version (the composition the kernels replace),
CUDA tensors the kernel, with no fallback. ``LAUNCHES`` counts the
kernels' launches by the chain's mode: on the fused backend's chain on the
card, 2 a step, as many as the fused layer's.
"""

from __future__ import annotations

import ctypes

import torch

from pmhc_tpu_torch.diffusion.noise import Draws, noise_of, remove_noise_scalars
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models.egnn import N_TORSIONS
from pmhc_tpu_torch.ops.egnn_fused import MODE_IDS, T, _project, device_ctx, mode_of

# kernel launches on the main path, per mode (a CUDA graph's capture takes
# its counts back and each replay adds them: utils/graphs.py)
LAUNCHES = {"fp32": 0, "bf16": 0, "high": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def inter_layer_plain(inner, q1, t1, wj_t, h2, aj, qj, tj, bf16=False) -> None:
    """``inter_layer`` in PyTorch: relu, ``_project``, the rows copied."""
    N = inner.shape[1]
    h2.copy_(torch.relu(inner))
    aj[:, :N] = _project(h2, wj_t, bf16)
    qj[:, :N] = q1
    tj[:, :N] = t1


def step_plain(k, xs, sched, q, t, tors, q_p, t_p, tors_p, draws: Draws, h1, aj_static, wj_time,
               aj, qj, tj) -> None:
    """``step`` in PyTorch: ``remove_noise_scalars`` on ``noise_of(draws)``
    and the next step's inputs as the sampler's plain composition builds
    them, kept as they were after the chain's last step (selected on the
    device: no host read, so a CUDA graph can hold it)."""
    N = q.shape[1]
    out = remove_noise_scalars({"frames": RigidArray(q, t), "torsions": tors},
                               {"frames": RigidArray(q_p, t_p), "torsions": tors_p},
                               noise_of(draws), *sched.index_select(0, k)[0].unbind())
    q.copy_(out["frames"].quats)
    t.copy_(out["frames"].trans)
    tors.copy_(out["torsions"])
    qj[:, :N] = q
    tj[:, :N] = t
    k += 1
    x = xs.index_select(0, torch.clamp(k, max=xs.shape[0] - 1))
    more = k < xs.shape[0]
    h1[..., -1:] = torch.where(more, x, h1[..., -1:])
    aj[:, :N] = torch.where(more, aj_static + x * wj_time, aj[:, :N])


def _lib():
    from pmhc_tpu_torch.ops import _build

    return bind(_build.load("sampler_step"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/sampler_step.cu`` on a loaded
    library (once per library)."""
    if not getattr(lib, "_pmhc_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sampler_inter_launch.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.sampler_inter_launch.restype = i32
        lib.sampler_step_launch.argtypes = (
            [ptr] * 4 + [i32] + [ptr] * 9 + [ctypes.c_float, ptr, i32] + [ptr] * 5 + [i32] * 3
            + [ptr])
        lib.sampler_step_launch.restype = i32
        lib._pmhc_typed = True
    return lib


def _raise_on(err: int, who: str) -> None:
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err}")


def launch_inter(lib, inner, q1, t1, wj_t, h2, aj, qj, tj, bf16=False, stream: int = 0) -> None:
    """One launch of the inter-layer kernel on checked inputs."""
    B, N, H = inner.shape
    _raise_on(lib.sampler_inter_launch(
        *(x.data_ptr() for x in (inner, q1, t1, wj_t, h2, aj, qj, tj)), B, N, aj.shape[1], H,
        MODE_IDS[mode_of(bf16)], stream), "sampler_inter")


def launch_step(lib, k, xs, sched, q, t, tors, q_p, t_p, tors_p, draws: Draws, h1, aj_static,
                wj_time, aj, qj, tj, ticket, stream: int = 0) -> None:
    """One launch of the step kernel on checked inputs."""
    B, N = q.shape[:2]
    ptrs = lambda *ts: [x.data_ptr() for x in ts]  # noqa: E731
    _raise_on(lib.sampler_step_launch(
        *ptrs(k, ticket, xs, sched), xs.shape[0],
        *ptrs(q, t, tors, q_p, t_p, tors_p, *draws[:3]), float(draws.scale),
        h1.data_ptr(), h1.shape[-1], *ptrs(aj_static, wj_time, aj, qj, tj),
        B, N, aj.shape[1], stream), "sampler_step")


def _checked(who: str, dev: torch.device, items) -> None:
    """Each (name, tensor, shape, dtype) contiguous on ``dev``, or raise."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    for name, x, shape, dtype in items:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{who}: {name} is {x.dtype}, expected {dtype}")
        if x.device != dev:
            raise ValueError(f"{who}: {name} on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def inter_layer(inner, q1, t1, wj_t, h2, aj, qj, tj, bf16=False) -> None:
    """Layer 2's node input and neighbour inputs' peptide rows from layer
    1's outputs (see the module's docstring), in place: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    B, N, H = inner.shape
    NP = aj.shape[1]
    dev = inner.device
    f32 = torch.float32
    _checked("sampler_inter", dev, (
        ("inner", inner, (B, N, H), f32), ("q1", q1, (B, N, 4), f32), ("t1", t1, (B, N, 3), f32),
        ("wj_t", wj_t, (H, T), f32), ("h2", h2, (B, N, H), f32), ("aj", aj, (B, NP, T), f32),
        ("qj", qj, (B, NP, 4), f32), ("tj", tj, (B, NP, 3), f32)))
    if NP < N or H > T:
        raise ValueError(f"sampler_inter: {NP} neighbours for {N} residues, width {H} (at most {T})")
    if dev.type == "cpu":
        inter_layer_plain(inner, q1, t1, wj_t, h2, aj, qj, tj, bf16)
        return
    with device_ctx(dev):
        launch_inter(_lib(), inner, q1, t1, wj_t, h2, aj, qj, tj, bf16, _stream(dev))
    LAUNCHES[mode_of(bf16)] += 1


def step(k, xs, sched, q, t, tors, q_p, t_p, tors_p, draws: Draws, h1, aj_static, wj_time,
         aj, qj, tj, ticket, bf16=False) -> None:
    """One reverse step from layer 2's predictions and the step's raw
    ``draws`` (see the module's docstring), in place: the kernel for CUDA
    tensors, the plain version for CPU tensors. ``k`` is the int64 [1]
    step counter, ``xs`` [K] and ``sched`` [K, 6] the chain's tables;
    ``ticket`` an int32 [1] zero the kernel counts its finished blocks in
    (one per chain, zero again after each launch); ``bf16`` the chain's
    mode, which the launch is counted under."""
    B, N = q.shape[:2]
    K, NP, H1 = xs.shape[0], aj.shape[1], h1.shape[-1]
    dev = q.device
    f32 = torch.float32
    _checked("sampler_step", dev, (
        ("k", k, (1,), torch.int64), ("ticket", ticket, (1,), torch.int32),
        ("xs", xs, (K,), f32), ("sched", sched, (K, 6), f32),
        ("q", q, (B, N, 4), f32), ("t", t, (B, N, 3), f32), ("tors", tors, (B, N, N_TORSIONS, 2), f32),
        ("q_p", q_p, (B, N, 4), f32), ("t_p", t_p, (B, N, 3), f32),
        ("tors_p", tors_p, (B, N, N_TORSIONS, 2), f32),
        ("normal", draws.normal, (B, N, 3), f32), ("shoemake", draws.shoemake, (B, N, 3), f32),
        ("angles", draws.angles, (B, N, N_TORSIONS), f32), ("h1", h1, (B, N, H1), f32),
        ("aj_static", aj_static, (B, N, T), f32), ("wj_time", wj_time, (T,), f32),
        ("aj", aj, (B, NP, T), f32), ("qj", qj, (B, NP, 4), f32), ("tj", tj, (B, NP, 3), f32)))
    if NP < N or K < 1:
        raise ValueError(f"sampler_step: {NP} neighbours for {N} residues, {K} steps")
    if dev.type == "cpu":
        step_plain(k, xs, sched, q, t, tors, q_p, t_p, tors_p, draws, h1, aj_static, wj_time,
                   aj, qj, tj)
        return
    with device_ctx(dev):
        launch_step(_lib(), k, xs, sched, q, t, tors, q_p, t_p, tors_p, draws, h1, aj_static,
                    wj_time, aj, qj, tj, ticket, _stream(dev))
    LAUNCHES[mode_of(bf16)] += 1
