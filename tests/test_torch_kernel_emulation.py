"""The port's CUDA sources run on the CPU and held against their plain
versions: each ``csrc/*.cu`` is compiled with g++ against the runtime
emulation of ``pmhc_tpu_torch/csrc/emu`` (``ops/_emulate.py``) and driven
through the wrappers' own launch functions on CPU tensors. This runs the
kernels' indexing, barriers, online softmax, adjoints and reductions
(the backward's persistent blocks loop over several rows: the emulated
card has 3 SMs) without a card. The card's compiler, timing and races are
``chip_smoke.py``'s and ``test_torch_gpu.py``'s to show.

Every case of the fused and loop kernels runs in each of their modes:
fp32, bf16 and high (``--fast-f32``: the products split into bf16
halves; the split has its own emulated body in ``csrc/mma_bf16.cuh``).
Tolerances are ``chip_smoke.py``'s: loop kernels ``LOOP_TOL`` (a share of
each tensor's largest magnitude), fused kernel ``TOL``, kernel #3
``PALLAS_TOL``. Batch 1 (batch 2-3 for kernel #3, whose batch holds
peptides of 9, 5 and 1 residues: fully masked rows) and one layer shape
per case keep the emulation (one OS thread per CUDA thread) to seconds.
The fused kernel also runs a ragged neighbour tile (NP = 90), two
neighbour tiles per query row (NP = 136, batch 2) and inputs that do not
start 16-byte aligned; the loop kernels run a ragged NP = 90 (the
backward's second 48-neighbour tile partly padding), batch 2 (blocks that
cross a batch element), unaligned inputs, and the forward two neighbour
tiles per query row (NP = 136, batch 2);
kernel #3 runs blocks that cross a batch element (batch 2) and a ragged
NP = 90.
Skips without g++.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    LOOP_TOL,
    PALLAS_TOL,
    TOL,
    layer_case,
    loop_case,
    loop_errors,
    loop_named,
    loop_ragged,
    loop_run,
    loop_two_tiles,
    pallas_case,
    pallas_ragged,
    random_model,
    ragged_case,
)
from pmhc_tpu_torch.ops import _emulate
from pmhc_tpu_torch.ops import egnn_fused as ef
from pmhc_tpu_torch.ops import egnn_loop as el
from pmhc_tpu_torch.ops import egnn_pallas as ep

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _lib(name, bind):
    if _emulate.gxx_path() is None:
        pytest.skip("needs g++ to compile the kernels for the CPU")
    return bind(_emulate.build_emulated(name))


def _offset(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose storage starts 4 bytes past an
    allocation: not 8- or 16-byte aligned."""
    v = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    v.copy_(x)
    return v


def _loop_matches_plain(args, cts, mode, bwd_inputs=None, fwd_inputs=None):
    """Both loop kernels against the plain version; ``fwd_inputs``: the
    forward's args if not ``args``; ``bwd_inputs``: the backward's (args,
    m, cts) if not those of the forward."""
    lib = _lib("egnn_loop", el.bind)
    bf16 = ef.FLAGS[mode]
    outs = el.launch_fwd(lib, *(fwd_inputs or args), bf16=bf16)
    b_args, m, b_cts = bwd_inputs(args, outs[0], cts) if bwd_inputs else (args, outs[0], cts)
    got = loop_named(outs, el.launch_bwd(lib, *b_args, m, b_cts, bf16=bf16))
    bad = {n: r for n, r in loop_errors(got, loop_run(args, cts, bf16, kernel=False),
                                         LOOP_TOL[mode]).items() if not r[3]}
    assert not bad, bad


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
@pytest.mark.parametrize("batch_size,n_neighbours", [(1, None), (1, 90), (2, None)])
def test_loop_kernels_emulated_match_plain(mode, batch_size, n_neighbours):
    """NP = 96: two full 48-neighbour tiles per query row. ``n_neighbours``
    = 90 (``loop_ragged``): the backward's second tile is ragged, its padding
    rows hold the first tile's data and must carry no gradient. Batch 2 on
    the emulated card's 3 SMs gives the backward blocks of 11 / 11 / 10
    rows: the second crosses a batch element, whose neighbour frames it
    must rebuild mid-block."""
    args, cts = loop_case(random_model(seed=0), "gnn2", seed=4, device=CPU, batch_size=batch_size)
    if n_neighbours is not None:
        args = loop_ragged(args, n_neighbours)
    _loop_matches_plain(args, cts, mode)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_loop_kernels_emulated_take_unaligned_inputs(mode):
    """Every input of both kernels a view that starts 4 bytes into its
    storage: the forward's copies and the backward's weight staging and hid
    build take their 4-byte paths."""
    args, cts = loop_case(random_model(seed=0), "gnn1", seed=8, device=CPU, batch_size=1)
    off = tuple(_offset(x) for x in args)
    _loop_matches_plain(args, cts, mode, fwd_inputs=off, bwd_inputs=lambda a, m, c: (
        off, _offset(m), [_offset(x) for x in c]))


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_loop_forward_emulated_two_tiles(mode):
    """NP = 136 at batch 2: the forward merges two neighbour tiles per query
    row (the second ragged, over rows the first wrote), HID sums over both,
    and the blocks' rows cross a batch element. Forward only: the backward
    takes NP <= 96."""
    lib = _lib("egnn_loop", el.bind)
    args, _ = loop_case(random_model(seed=0), "gnn2", seed=12, device=CPU, batch_size=2)
    args = loop_two_tiles(args)
    assert args[-1].shape[-1] == 136
    bf16 = ef.FLAGS[mode]
    got = {f"out {n}": o for n, o in zip(el.OUT_NAMES, el.launch_fwd(lib, *args, bf16=bf16))}
    want = {f"out {n}": o for n, o in zip(el.OUT_NAMES, el.egnn_loop_plain(*args, bf16=bf16))}
    bad = {n: r for n, r in loop_errors(got, want, LOOP_TOL[mode]).items() if not r[3]}
    assert not bad, bad


def _fused_matches_plain(lib, args, mode):
    got = ef.launch(lib, *args, bf16=ef.FLAGS[mode])
    want = ef.egnn_fused_plain(*args, bf16=ef.FLAGS[mode])
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL[mode][name], err_msg=name)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_fused_kernel_emulated_matches_plain(mode):
    lib = _lib("egnn_fused", ef.bind)
    args = layer_case(random_model(seed=0), "gnn1", seed=2, device=CPU, batch_size=1)
    assert lib.egnn_fused_weights_size(args[0].H, args[0].O) == args[0].buf.numel()
    _fused_matches_plain(lib, args, mode)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_fused_kernel_emulated_ragged_tile(mode):
    """NP = 90, not a multiple of 16: the last mma row tile is padded with
    zero rows and its neighbours masked out of the fold."""
    args = ragged_case(layer_case(random_model(seed=0), "gnn2", seed=5, device=CPU, batch_size=1))
    _fused_matches_plain(_lib("egnn_fused", ef.bind), args, mode)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_fused_kernel_emulated_takes_unaligned_inputs(mode):
    """a_j, q_j and edge (and every other input) as views that start 4 bytes
    into their storage: the kernel's 4-byte copy path."""
    args = layer_case(random_model(seed=0), "gnn1", seed=9, device=CPU, batch_size=1)
    w, rest = args[0], args[1:]
    _fused_matches_plain(_lib("egnn_fused", ef.bind), (w,) + tuple(_offset(x) for x in rest), mode)


def _two_tiles(args, extra: int = 40):
    """The fused layer's inputs with ``extra`` more neighbours (perturbed
    copies of pocket slots, random mask) at batch 2: NP = 96 + extra, two
    neighbour tiles, the second ragged over rows a first tile wrote."""
    w, h, q_i, t_i, tors, a_j, q_j, t_j, edge, mask = args
    rng = np.random.default_rng(6)
    more = lambda x, axis: torch.cat((x, x.narrow(axis, 20, extra) + torch.from_numpy(
        0.1 * rng.standard_normal(x.narrow(axis, 20, extra).shape).astype(np.float32))), axis).contiguous()
    m = torch.from_numpy((rng.random(mask.shape[:2] + (extra,)) > 0.3).astype(np.float32))
    mask = torch.cat((mask, m), 2).contiguous()
    mask[1, 3] = 0.0  # a fully masked row
    return w, h, q_i, t_i, tors, more(a_j, 1), more(q_j, 1), more(t_j, 1), more(edge, 1), mask


@pytest.mark.parametrize("mode", ["fp32", "bf16", "high"])
def test_fused_kernel_emulated_two_tiles(mode):
    """NP = 136: the online fold merges two neighbour tiles per query row,
    the second tile's padding rows hold the first tile's data (and must be
    zeroed), and the batch's two elements cross a block's rows."""
    args = _two_tiles(layer_case(random_model(seed=0), "gnn1", seed=7, device=CPU, batch_size=2))
    _fused_matches_plain(_lib("egnn_fused", ef.bind), args, mode)


@pytest.mark.parametrize("layer,q_scale,batch_size,n_neighbours", [
    ("gnn1", 1.0, 3, None), ("gnn2", 1.3, 3, None),
    ("gnn1", 1.0, 2, None), ("gnn2", 1.0, 2, None),
    ("gnn1", 1.0, 3, 90), ("gnn2", 1.3, 2, 90)])
def test_pallas_kernel_emulated_matches_plain(layer, q_scale, batch_size, n_neighbours):
    """``q_scale``: the peptide quaternions (q_i and the peptide half of
    q_j) scaled off the unit sphere, where the kernel's second
    normalisation of the updated quaternion is not a no-op. Batch 2 on the
    emulated card's 3 SMs gives blocks of 11 / 11 / 10 rows: the second
    crosses a batch element (its neighbour projection is rebuilt mid-block)
    and the last is partial. ``n_neighbours`` = 90 (``pallas_ragged``): a
    partial last 32-neighbour block and, at H = 23, h_all blocks that do
    not start 16-byte aligned."""
    lib = _lib("egnn_pallas", ep.bind)
    ctx, (h, q, t, tors) = pallas_case(random_model(seed=0), layer, seed=3, device=CPU,
                                       batch_size=batch_size)
    if n_neighbours is not None:
        ctx = pallas_ragged(ctx, n_neighbours)
    args = ctx.inputs(h, q * q_scale, t, tors)
    assert lib.egnn_pallas_weights_size(args[0].H, args[0].E, args[0].O) == args[0].buf.numel()
    got = ep.launch(lib, *args)
    want = ep.egnn_pallas_plain(*args)
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=PALLAS_TOL[name], err_msg=name)
