"""``chip_ab.py``'s ablations stay applicable: every (text, replacement)
of ``ABLATIONS`` occurs in the kernel source it edits, so a later edit of a
kernel cannot leave ``chip_ab.py --ablate`` raising before it builds
anything; and every ablated source still compiles (g++ with
``-fsyntax-only`` against the CUDA runtime emulation of
``test_torch_kernel_emulation.py``, which instantiates every kernel), so
the tool's nvcc builds of them do not fail on the card either. The loop's
backward ablations cover the high mode's products as well as the fp32
and bf16 ones."""

import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (the tier's convention: both frameworks importable)
import pytest
import torch

import chip_ab
from pmhc_tpu_torch.ops import _emulate

torch.set_num_threads(1)
CSRC = os.path.join(chip_ab.REPO, "pmhc_tpu_torch", "csrc")
CASES = [(k, n) for k, edits in sorted(chip_ab.ABLATIONS.items()) for n in sorted(edits)]


def _source(kernel: str) -> str:
    """What ``chip_ab`` ablates: the kernel's ``.cu`` (the loop forward's
    phases are called there, from ``egnn_tile.cuh``)."""
    with open(os.path.join(CSRC, chip_ab.SOURCES[kernel] + ".cu")) as f:
        return f.read()


def _syntax_check(gxx: str, path: str, include: str) -> subprocess.CompletedProcess:
    """g++ -fsyntax-only of ``path`` (an ablated source) as the emulated
    build compiles it, the headers from ``include`` (ablated headers),
    then ``csrc/``."""
    tu = f"{path}.cpp"
    with open(tu, "w") as f:
        f.write(f'#include "cuda_runtime.h"\n#include "{path}"\n')
    return subprocess.run([gxx, "-std=c++20", "-fsyntax-only", "-pthread", "-I", _emulate.EMU_DIR,
                           "-I", include, "-I", CSRC, tu], capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """Every ablated source compiled once, four g++ at a time."""
    gxx = _emulate.gxx_path()
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU")
    out = tmp_path_factory.mktemp("ablated")
    paths = {}
    for kernel, name in CASES:
        inc = out / f"{kernel}_{name}_include"
        inc.mkdir()
        paths[kernel, name] = (str(inc / f"{kernel}_{name}.cu"), str(inc))
        for fname, text in chip_ab.ablated_files(kernel, chip_ab.ABLATIONS[kernel][name], CSRC).items():
            with open(paths[kernel, name][0] if fname is None else inc / fname, "w") as f:
                f.write(text)
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(paths, pool.map(lambda p: _syntax_check(gxx, *p), paths.values())))


@pytest.mark.parametrize("kernel,name", CASES)
def test_ablation_text_occurs_in_its_source(kernel, name):
    """Every edit applies (``ablated`` raises on a text that does not
    occur) and the ablation changes the kernel's source or a header."""
    def original(fname):
        if fname is None:
            return _source(kernel)
        with open(os.path.join(CSRC, fname)) as f:
            return f.read()

    files = chip_ab.ablated_files(kernel, chip_ab.ABLATIONS[kernel][name], CSRC)
    assert any(text != original(fname) for fname, text in files.items())


@pytest.mark.parametrize("kernel,name", CASES)
def test_ablated_source_compiles(compiled, kernel, name):
    proc = compiled[kernel, name]
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_loop_ablations_name_every_mode():
    """The backward's per-mode products are each removed in high too (its
    wgmma products, in egnn_loop.cu and the shared egnn_high.cuh), and the
    forward's phases in the fp32 / bf16 tile loop and the high pipeline."""
    texts = {n: "".join(e[-2] for e in edits) for n, edits in chip_ab.ABLATIONS["loop"].items()}
    assert "wgmma_ss<64, 0, 0>(acc, da_h" in texts["no_head_product"]
    assert "wgmma_ss<48, 0, 0>(accT" in texts["no_head_product"]
    assert "wgmma_rs<64, 1>(dwc" in texts["no_dwhm_product"]
    assert "wgmma_rs<64, 1>(dhid" in texts["no_dhid_product"]
    src = _source("loop")
    for mode_fn in ("egnn_loop_bwd_kernel<MODE_HIGH>", "part1_head", "part2_head", "bwd_high_producer",
                    "egnn_loop_fwd_kernel<MODE_HIGH>"):
        assert mode_fn in src
    # the forward's phases are templates on MODE, one text for fp32 and bf16,
    # and egnn_high.cuh's for high
    for name in ("fwd_no_product", "fwd_no_fold", "fwd_no_build", "fwd_no_weight_staging"):
        assert "<MODE>" in texts[name]
        assert any(len(e) == 3 and e[0] == "egnn_high.cuh" for e in chip_ab.ABLATIONS["loop"][name]) or \
            "stage_high<S>" in texts[name]


def test_missing_text_raises():
    with pytest.raises(AssertionError, match="ablation text not in the source"):
        chip_ab.ablated("int main() {}", [("no such text", "")])
