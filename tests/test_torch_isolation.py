"""The port stands alone: no file of ``pmhc_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package, importing the port
(its data package and offline CLIs included) leaves JAX, the JAX package
and h5py unloaded, its entry points (``SamplerService``, ``Trainer``, the
HTTP server's ``create_server``, the train and sample CLIs) refuse to fall
back to the CPU by themselves, and nothing in it turns on TF32."""

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
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    return paths


def _trees():
    for path in _port_sources():
        with open(path) as f:
            yield path, ast.parse(f.read(), filename=path)


def test_port_imports_neither_jax_nor_pmhc_tpu():
    banned = ("jax", "jaxlib", "pmhc_tpu")
    for path, tree in _trees():
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
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
            "pmhc_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pmhc_tpu', 'h5py')]; "
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
    PackedDataset(str(tmp_path / "d.hdf5"), num_workers=1).save(data)
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
