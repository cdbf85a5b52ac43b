"""The port stands alone: no file of ``pmhc_tpu_torch/`` (its tool twins
in ``pmhc_tpu_torch/tools/`` included; nor the card's scripts
``chip_smoke.py``, ``chip_ab.py``, ``chip_studies.py``) imports JAX, the
JAX package or the JAX package's ``tools/`` scripts, importing the port
(its data package, offline CLIs and tools included) leaves JAX, the JAX
package, ``tools`` and h5py unloaded, its entry points (``SamplerService``, ``Trainer``, the
HTTP server's ``create_server``, the train and sample CLIs, the tool twins) refuse to fall
back to the CPU by themselves, nothing in it turns on TF32, and it builds its
native libraries (the PDB formatter, the HDF5 decoder, the kernels of an
AOT artifact) from its own ``pmhc_tpu_torch/csrc/``, never from the repo's
top-level ``csrc/``."""

import ast
import os
import subprocess
import sys

import jax  # noqa: F401  (the tier's convention: both frameworks importable)
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pmhc_tpu_torch")


def _port_sources():
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py", "chip_ab.py", "chip_studies.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    return paths


def _trees():
    for path in _port_sources():
        with open(path) as f:
            yield path, ast.parse(f.read(), filename=path)


def test_port_imports_neither_jax_nor_pmhc_tpu():
    # "tools": the JAX package's tool scripts at the repo root; the port's
    # twins are pmhc_tpu_torch.tools
    banned = ("jax", "jaxlib", "pmhc_tpu", "tools")
    tool_twins = [p for p in _port_sources() if os.sep + "tools" + os.sep in p]
    assert len(tool_twins) >= 7, tool_twins
    for path, tree in _trees():
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{path}:{node.lineno}: a relative import"
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}:{node.lineno} imports {name}"


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys; import pmhc_tpu_torch, pmhc_tpu_torch.serve, "
            "pmhc_tpu_torch.ops.egnn_fused, pmhc_tpu_torch.models.import_params, "
            "pmhc_tpu_torch.ops.egnn_loop, pmhc_tpu_torch.train, pmhc_tpu_torch.ops.egnn_pallas, "
            "pmhc_tpu_torch.cli.serve_cli, pmhc_tpu_torch.data, pmhc_tpu_torch.data.validate, "
            "pmhc_tpu_torch.cli.train_cli, pmhc_tpu_torch.cli.sample_cli, pmhc_tpu_torch.io, "
            "pmhc_tpu_torch.utils.profiling, pmhc_tpu_torch.tools.eval_rmsd, "
            "pmhc_tpu_torch.tools.rmsd_backends, pmhc_tpu_torch.tools.bench_sampler, "
            "pmhc_tpu_torch.tools.bench_train, pmhc_tpu_torch.tools.bench_serve, "
            "pmhc_tpu_torch.tools.flops, pmhc_tpu_torch.tools.bench_aot, pmhc_tpu_torch.aot, "
            "pmhc_tpu_torch.models.egnn_blockwise, pmhc_tpu_torch.io.pdb_native, "
            "pmhc_tpu_torch.data.native; "
            "bad = [m for m in sys.modules "
            "       if m.split('.')[0] in ('jax', 'pmhc_tpu', 'h5py', 'tools')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_service_without_device_needs_the_card():
    from pmhc_tpu_torch.models import ScoreNetwork
    from pmhc_tpu_torch.serve import SamplerService

    model = ScoreNetwork()
    if torch.cuda.is_available():
        assert SamplerService(model, noise_step_count=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SamplerService(model, noise_step_count=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SamplerService(model, noise_step_count=2, device="cuda")


def test_server_without_device_needs_the_card(tmp_path):
    from pmhc_tpu_torch.cli.serve_cli import build_parser, create_server
    from pmhc_tpu_torch.models import ScoreNetwork

    path = str(tmp_path / "model.pth")
    torch.save(ScoreNetwork().state_dict(), path)
    args = build_parser().parse_args([path, "--port", "0", "-T", "2", "--batch-size", "1",
                                      "--backend", "pallas"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        server = create_server(args)
        assert server.batcher.service.device.type == "cuda"
        server.batcher.close()
        server.server_close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_server(args)


def test_trainer_without_device_needs_the_card():
    from pmhc_tpu_torch.train import Trainer

    if torch.cuda.is_available():
        assert Trainer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(device="cuda")
        assert Trainer(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cli", ["train", "sample"])
def test_offline_clis_without_device_need_the_card(tmp_path, cli):
    from pmhc_tpu_torch.cli import sample_cli, train_cli
    from pmhc_tpu_torch.data import PackedDataset, write_synthetic_hdf5
    from pmhc_tpu_torch.models import ScoreNetwork

    data, model = str(tmp_path / "d.npz"), str(tmp_path / "model.pth")
    write_synthetic_hdf5(str(tmp_path / "d.hdf5"), n_entries=2, seed=0)
    PackedDataset(str(tmp_path / "d.hdf5")).save(data)
    torch.save(ScoreNetwork().state_dict(), model)
    main, args = ((train_cli.main, [data, "1", model]) if cli == "train"
                  else (sample_cli.main, [model, data]))
    args += ["-T", "2", "-b", "2"]
    parser = train_cli.build_parser() if cli == "train" else sample_cli.build_parser()
    assert parser.parse_args(args).device == "cuda"
    if torch.cuda.is_available():
        main(args)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)


@pytest.mark.parametrize("tool", ["eval_rmsd", "rmsd_backends", "bench_sampler", "bench_train",
                                  "bench_serve", "bench_aot"])
def test_tools_without_device_need_the_card(tmp_path, tool):
    """The tool twins default to ``--device cuda`` and raise without a card."""
    import importlib

    from pmhc_tpu_torch.data.realistic import realistic_packed
    from pmhc_tpu_torch.models import ScoreNetwork

    mod = importlib.import_module(f"pmhc_tpu_torch.tools.{tool}")
    data, model = str(tmp_path / "d.npz"), str(tmp_path / "model.pth")
    torch.save(ScoreNetwork().state_dict(), model)
    args = {"eval_rmsd": [model, data], "rmsd_backends": [model]}.get(tool, [])
    if tool == "eval_rmsd":
        realistic_packed(2, 0).save(data)
    args += ["-T", "2"]
    assert mod.build_parser().parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(args)


def test_no_tf32_switched_on():
    for path, tree in _trees():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                    "set_float32_matmul_precision":
                args = [a.value for a in node.args if isinstance(a, ast.Constant)]
                assert args == ["highest"], f"{path}:{node.lineno} sets matmul precision {args}"
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if getattr(target, "attr", "") == "allow_tf32":
                        assert isinstance(node.value, ast.Constant) and node.value.value is False, \
                            f"{path}:{node.lineno} turns TF32 on"


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []), ("chip_studies.py", []),
                                         ("chip_studies.py", ["steps-per-graph"])])
def test_card_scripts_refuse_to_run_without_a_card(script, args):
    """Without a CUDA device the card's scripts exit 2 and print no result
    (on a machine with a card, an unknown study name still exits 2)."""
    if torch.cuda.is_available():
        script, args = "chip_studies.py", ["no-such-study"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, script), *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr
    assert '"ok"' not in proc.stdout


def test_native_libraries_come_from_the_ports_own_sources(tmp_path):
    """A copy of ``pmhc_tpu_torch`` alone, outside the repo (no top-level
    ``csrc/`` beside it), builds and runs the PDB formatter and the HDF5
    decoder from its own ``csrc/`` (with JAX unloaded), and an AOT artifact
    round-trips there; no port source names the top-level directory."""
    import shutil

    shutil.copytree(PORT, tmp_path / "pmhc_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = (
        "import os, sys, tempfile, torch\n"
        "from pmhc_tpu_torch.ops import _build\n"
        "from pmhc_tpu_torch.io import pdb_native\n"
        "from pmhc_tpu_torch.data import native, write_synthetic_hdf5, PackedDataset\n"
        "from pmhc_tpu_torch.aot import save_sampler, load_sampler\n"
        "from pmhc_tpu_torch.models import ScoreNetwork\n"
        "from pmhc_tpu_torch.serve import SamplerService, dummy_entry\n"
        "here = os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__)))\n"
        "assert _build.CSRC == os.path.join(here, 'csrc') and here.startswith(sys.argv[1]), here\n"
        "assert pdb_native.is_available() and native.is_available()\n"
        "d = tempfile.mkdtemp(dir=sys.argv[1]); h5 = os.path.join(d, 'd.hdf5')\n"
        "write_synthetic_hdf5(h5, n_entries=2, seed=0)\n"
        "assert len(PackedDataset(h5)) == 2\n"
        "svc = SamplerService(ScoreNetwork(), batch_size=1, noise_step_count=2, device='cpu')\n"
        "want = svc.sample_entries([dummy_entry()], torch.Generator().manual_seed(1))\n"
        "save_sampler(svc, os.path.join(d, 's.aot'))\n"
        "run = load_sampler(os.path.join(d, 's.aot'))\n"
        "assert run.__self__.sample_entries([dummy_entry()], torch.Generator().manual_seed(1)) == want\n"
        "assert sorted(os.path.basename(v.path).split('-')[0] for v in _build._LIBS.values()) == "
        "['libhdf5_decoder', 'libpdb_formatter']\n"
        "assert all(v.path.startswith(here) for v in _build._LIBS.values())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pmhc_tpu', 'tools')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    top = os.path.join(REPO, "csrc")
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        assert top not in text and "REPO, \"csrc\"" not in text, path
