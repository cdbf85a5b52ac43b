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
NP = 90. The sampler step's two kernels (``csrc/sampler_step.cu``) run at
N = 16, P = 8 against their plain versions within ``SAMPLER_STEP_TOL``.
Skips without g++.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    LOOP_TOL,
    PALLAS_TOL,
    SAMPLER_STEP_TOL,
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
    sampler_step_case,
    sampler_step_errors,
)
from pmhc_tpu_torch.ops import _emulate
from pmhc_tpu_torch.ops import egnn_fused as ef
from pmhc_tpu_torch.ops import egnn_loop as el
from pmhc_tpu_torch.ops import egnn_pallas as ep
from pmhc_tpu_torch.ops import sampler_step as ss

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


# One warpgroup runs the wgmma primitives of csrc/wgmma.cuh as the fused
# kernel's and the loop backward's high modes do: B [N][64] (bf16-rounded
# from fp32) staged in shared memory in the sw128 layout, 1024-byte aligned
# from the emulated block's unaligned shared-memory base as the kernels
# align it, K-major (row n) or MN-major (row k, B's N columns from element
# BOFF of the row: the loop backward reads d(out)'s lo half 16 elements in);
# A [64][64] beside it, K-major or MN-major (A through its descriptor) or in
# registers (each warp's m16n8k16 A fragments of its 16 rows); four k-steps
# into one accumulator (scale_d 0, then 1), read before its wait_group
# (still the start values) and after (the product).
_WGMMA_KERNEL = r"""
#include "wgmma.cuh"
#include "mma_bf16.cuh"
namespace pmhc {
namespace {
template <int N, int TA, int TB, int RS, int BOFF>
__global__ void wgmma_probe(const float* a, const float* b, float* d, float* before) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t raw = smem_addr(smem), pad = (1024u - (raw & 1023u)) & 1023u;
  char* tb = reinterpret_cast<char*>(smem) + pad;
  char* ta = tb + 64 * 128;  // A [64][64] after B (64 rows of 128 bytes either way)
  const int t = threadIdx.x, w = t / 32, l = t % 32, g = l / 4, c = l % 4;
  auto word = [](char* tile, int row, int wd) -> uint32_t& {
    return *reinterpret_cast<uint32_t*>(tile + sw128(row, 4 * wd));
  };
  for (int e = t; e < 64 * 32; e += 128) {
    const int row = e / 32, wd = e % 32;
    if (TB == 0) {  // row n: k = 2wd, 2wd + 1
      if (row < N) word(tb, row, wd) = pack_bf16x2(b[row * 64 + 2 * wd], b[row * 64 + 2 * wd + 1]);
    } else {  // row k: n = 2wd - BOFF, + 1 (zero outside B)
      const int n = 2 * wd - BOFF;
      word(tb, row, wd) = pack_bf16x2(n >= 0 && n < N ? b[n * 64 + row] : 0.f,
                                      n + 1 >= 0 && n + 1 < N ? b[(n + 1) * 64 + row] : 0.f);
    }
    if (TA == 0) word(ta, row, wd) = pack_bf16x2(a[row * 64 + 2 * wd], a[row * 64 + 2 * wd + 1]);
    else word(ta, row, wd) = pack_bf16x2(a[(2 * wd) * 64 + row], a[(2 * wd + 1) * 64 + row]);
  }
  fence_proxy_async();
  __syncthreads();
  uint32_t af[4][4];
  for (int ks = 0; ks < 4; ++ks)
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * w + g + 8 * (q & 1), col = 16 * ks + 8 * (q >> 1) + 2 * c;
      af[ks][q] = pack_bf16x2(a[row * 64 + col], a[row * 64 + col + 1]);
    }
  float acc[N / 2];
  for (int e = 0; e < N / 2; ++e) acc[e] = -1.f;
  const uint64_t da = TA ? desc_sw128_mn(smem_addr(ta)) : desc_sw128(smem_addr(ta));
  const uint64_t db = TB ? desc_sw128_mn(smem_addr(tb) + 2 * BOFF) : desc_sw128(smem_addr(tb));
  const int sa = TA ? 128 : 2, sb = TB ? 128 : 2;  // a k-step: 16 rows (MN-major) or 32 bytes (K-major)
  wgmma_fence();
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (RS) wgmma_rs<N, TB>(acc, af[ks], db + sb * ks, ks > 0);
    else wgmma_ss<N, TA, TB>(acc, da + sa * ks, db + sb * ks, ks > 0);
  }
  wgmma_commit();
  for (int e = 0; e < N / 2; ++e) before[t * (N / 2) + e] = acc[e];
  wgmma_wait<0>();
  fence_operand(acc);
  for (int e = 0; e < N / 2; ++e) {
    const int row = 16 * w + g + 8 * ((e & 3) >> 1), col = 8 * (e >> 2) + 2 * c + (e & 1);
    d[row * N + col] = acc[e];
  }
}
template <int N, int TA, int TB, int RS, int BOFF>
int run(const float* a, const float* b, float* d, float* before) {
  void* args[] = {&a, &b, &d, &before};
  return (int)cudaLaunchKernel(wgmma_probe<N, TA, TB, RS, BOFF>, dim3(1), dim3(128), args,
                               1024 + 2 * 64 * 128, nullptr);
}
}  // namespace
}  // namespace pmhc
extern "C" int wgmma_probe_launch(const float* a, const float* b, float* d, float* before, int variant) {
  using namespace pmhc;
  switch (variant) {
    case 0: return run<64, 0, 0, 0, 0>(a, b, d, before);   // the head product
    case 1: return run<16, 0, 0, 1, 0>(a, b, d, before);   // the lin2
    case 2: return run<64, 0, 1, 0, 0>(a, b, d, before);   // d(act) = d(out) w2
    case 3: return run<48, 0, 0, 0, 0>(a, b, d, before);   // act^T
    case 4: return run<48, 1, 0, 0, 0>(a, b, d, before);   // d(act)^T = w2^T d(out)^T
    case 5: return run<64, 0, 1, 1, 0>(a, b, d, before);   // d(hid), dwhm
    case 6: return run<16, 0, 1, 1, 16>(a, b, d, before);  // dW2 on d(out)'s lo half
  }
  return -1;
}
"""
# case id -> (variant, N): ss / rs, N, transposes, B's offset along N
_WGMMA_CASES = {"64": (0, 64), "16": (1, 16), "64-ss-tb": (2, 64), "48-ss": (3, 48), "48-ss-ta": (4, 48),
                "64-rs-tb": (5, 64), "16-rs-tb-off16": (6, 16)}


@pytest.mark.parametrize("case", list(_WGMMA_CASES))
def test_wgmma_emulated_matches_numpy(tmp_path, case):
    """The emulated wgmma against numpy's product of the same bf16-rounded
    operands, in every form the kernels issue: m64n64k16 and m64n48k16 with
    A and B through their descriptors (K-major, or MN-major by the transpose
    bits), m64n16k16 and m64n64k16 with A from registers and B K-major or
    MN-major (``-off16``: B's columns 16 elements into its rows). A wrong
    descriptor field, swizzle, transpose, k-step advance or fragment layout
    moves elements of D."""
    if _emulate.gxx_path() is None:
        pytest.skip("needs g++ to compile the kernels for the CPU")
    import ctypes

    variant, n = _WGMMA_CASES[case]
    src = tmp_path / "wgmma_probe.cu"
    src.write_text(_WGMMA_KERNEL)
    lib = _emulate.build_emulated("wgmma_probe", str(src))
    lib.wgmma_probe_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    rng = np.random.default_rng(n + variant)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((n, 64)).astype(np.float32)
    d = np.zeros((64, n), np.float32)
    before = np.zeros((128, n // 2), np.float32)
    assert lib.wgmma_probe_launch(a.ctypes.data, b.ctypes.data, d.ctypes.data, before.ctypes.data, variant) == 0
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).double().numpy()  # noqa: E731
    np.testing.assert_allclose(d, bf(a) @ bf(b).T, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(before, -1.0)  # the accumulator moves only at wait_group


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


@pytest.mark.parametrize("batch_size,k,mode", [
    (2, 5, "fp32"), (2, 5, "bf16"), (2, 5, "high"), (2, 11, "fp32"), (3, 5, "fp32")])
def test_sampler_step_emulated_matches_plain(batch_size, k, mode):
    """Both kernels of ``csrc/sampler_step.cu`` on a T = 12 chain's inputs
    (``sampler_step_case``: N = 16, P = 8, row 1 a 4-residue peptide) at a
    middle step and at the last (k = 11: the next step's inputs left as
    they were). Batch 2: two inter-layer blocks of 16 rows, one step block
    of 32; batch 3: a partial last block of each and two step blocks, the
    last of which advances the counter. The mode reaches the projection
    only (bf16: operands rounded)."""
    lib = _lib("sampler_step", ss.bind)
    case = sampler_step_case(random_model(seed=0), seed=4, device=CPU, batch_size=batch_size,
                             bf16=ef.FLAGS[mode], k=k, steps=12, pocket=8)
    errs = sampler_step_errors(case, lambda *a: ss.launch_inter(lib, *a, bf16=case["bf16"]),
                               lambda *a: ss.launch_step(lib, *a))
    for name, err in errs.items():
        assert err <= SAMPLER_STEP_TOL[name], (name, err)
