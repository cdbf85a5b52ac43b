"""The port's CUDA sources run on the CPU and held against their plain
versions: each ``csrc/*.cu`` is compiled with g++ against the runtime
emulation of ``pmhc_tpu_torch/csrc/emu`` (``ops/_emulate.py``) and driven
through the wrappers' own launch functions on CPU tensors. This runs the
kernels' indexing, barriers, online softmax, adjoints and reductions
(the backward's persistent blocks loop over several rows: the emulated
card has 3 SMs) without a card. The card's compiler, timing and races are
``chip_smoke.py``'s and ``test_torch_gpu.py``'s to show.

Tolerances are ``chip_smoke.py``'s: loop kernels ``LOOP_TOL`` (a share of
each tensor's largest magnitude), fused kernel ``TOL``, kernel #3
``PALLAS_TOL``. Batch 1 (batch 3 for kernel #3, whose batch holds
peptides of 9, 5 and 1 residues: fully masked rows) and one layer shape
per case keep the emulation (one OS thread per CUDA thread) to seconds.
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
    loop_run,
    pallas_case,
    random_model,
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


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_loop_kernels_emulated_match_plain(mode):
    lib = _lib("egnn_loop", el.bind)
    bf16 = mode == "bf16"
    args, cts = loop_case(random_model(seed=0), "gnn2", seed=4, device=CPU, batch_size=1)
    outs = el.launch_fwd(lib, *args, bf16=bf16)
    got = loop_named(outs, el.launch_bwd(lib, *args, outs[0], cts, bf16=bf16))
    bad = {n: r for n, r in loop_errors(got, loop_run(args, cts, bf16, kernel=False),
                                         LOOP_TOL[mode]).items() if not r[3]}
    assert not bad, bad


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_fused_kernel_emulated_matches_plain(mode):
    lib = _lib("egnn_fused", ef.bind)
    bf16 = mode == "bf16"
    args = layer_case(random_model(seed=0), "gnn1", seed=2, device=CPU, batch_size=1)
    got = ef.launch(lib, *args, bf16=bf16)
    want = ef.egnn_fused_plain(*args, bf16=bf16)
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL[mode][name], err_msg=name)


@pytest.mark.parametrize("layer,q_scale", [("gnn1", 1.0), ("gnn2", 1.3)])
def test_pallas_kernel_emulated_matches_plain(layer, q_scale):
    """``q_scale``: the peptide quaternions (q_i and the peptide half of
    q_j) scaled off the unit sphere, where the kernel's second
    normalisation of the updated quaternion is not a no-op."""
    lib = _lib("egnn_pallas", ep.bind)
    ctx, (h, q, t, tors) = pallas_case(random_model(seed=0), layer, seed=3, device=CPU, batch_size=3)
    args = ctx.inputs(h, q * q_scale, t, tors)
    assert lib.egnn_pallas_weights_size(args[0].H, args[0].E, args[0].O) == args[0].buf.numel()
    got = ep.launch(lib, *args)
    want = ep.egnn_pallas_plain(*args)
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=PALLAS_TOL[name], err_msg=name)
