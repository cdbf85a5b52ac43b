"""The ``--fast-f32`` mode (``"high"``) of the port against the JAX
package's, on the same numpy inputs and weights. On the CPU the wrappers
take their plain versions; the CUDA kernels against those are in
``test_torch_gpu.py``, ``test_torch_kernel_emulation.py`` and
``chip_smoke.py``.

- The split product (``ops/egnn_fused.py::_split_mm``) against
  ``mm_maker("high")``'s ``_mm``: within 1e-6 of the sum of the products'
  magnitudes, not bit-equal to the fp32 product, and within 3 * 2^-16 of
  that sum from a float64 product (hi and lo keep ~16 bits of each
  operand; lo*lo is dropped).
- The fused layer (TPU kernel #1) against ``egnn_forward_pallas_lane(...,
  interpret=True, bf16="high")``, and the training layer's values and
  gradients against ``egnn_forward_pallas_lane_vjp(interpret=True,
  g8=False, bf16="high")``, at the fp32 tolerances of
  ``test_torch_egnn_fused.py`` and ``test_torch_egnn_loop.py``. Where the
  TPU kernels split every matmul, the port multiplies the rotation term,
  the node MLPs and the neighbour projections in fp32: each differs from
  a split by ~2^-17 relative, inside those tolerances.
- A 4-step trajectory of a ``SamplerService(fast_f32=True)`` against
  ``sample_lane(precision=HIGH)`` with the same injected noise, at the
  tolerances of ``test_torch_sampler.py``.
- Both CLIs with ``--fast-f32 --device cpu``: the high mode reaches the
  layers, ``--bf16`` wins over it, and both report ``"fast-f32"``, as the
  HTTP server's ``/healthz`` does (the JAX server's value).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.data import write_synthetic_hdf5
from pmhc_tpu.diffusion import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion.sampler_lane import sample_lane
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.ops.egnn_pallas_lane import egnn_forward_pallas_lane, mm_maker
from pmhc_tpu.ops.egnn_pallas_lane_vjp import egnn_forward_pallas_lane_vjp
from pmhc_tpu_torch.cli import sample_cli, train_cli
from pmhc_tpu_torch.diffusion import sample
from pmhc_tpu_torch.models import ScoreNetwork, ScoreNetworkConfig
from pmhc_tpu_torch.ops import egnn_fused as ef
from pmhc_tpu_torch.ops import egnn_loop as el
from pmhc_tpu_torch.serve import SamplerService
from pmhc_tpu_torch.train import Trainer
from tests.test_torch_egnn import (
    assert_layer_close,
    jax_model_batch,
    layer_args,
    numpy_batch,
    params_pair,
    torch_model_batch,
)
from tests.test_torch_egnn_fused import _fused
from tests.test_torch_egnn_loop import (
    FP32_VAL_TOL,
    _assert_grads_close,
    _assert_values_close,
    _loss_jax,
    _loss_torch,
)
from tests.test_torch_sampler import T_STEPS, _assert_traj_close, _inputs

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def test_split_product_matches_mm_maker_high():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((96, 64)).astype(np.float32)
    b = (rng.standard_normal((64, 52)) * np.exp(rng.uniform(-3, 3, (64, 52)))).astype(np.float32)
    want = np.asarray(mm_maker("high")[0](jnp.asarray(a), jnp.asarray(b)))
    got = ef._split_mm(torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T))).numpy()
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert float(np.max(np.abs(got - want) / scale)) <= 1e-6
    assert not np.array_equal(got, (torch.from_numpy(a) @ torch.from_numpy(b)).numpy())
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert float(np.max(np.abs(got - exact) / scale)) <= 3 * 2.0 ** -16


def test_split_product_gradients_are_split_products():
    """The plain versions' backward through a split product splits its
    products too, as the high loop backward does: within 3 * 2^-16 of the
    fp32 gradients, and not equal to them."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(np.float32))
    gx, gw = torch.autograd.grad(ef._split_mm(x, w), (x, w), g)
    xd, wd = x.detach(), w.detach()
    for got, want, scale in ((gx, g @ wd, g.abs() @ wd.abs()),
                             (gw, g.reshape(15, 8).T @ xd.reshape(15, 64),
                              g.reshape(15, 8).abs().T @ xd.reshape(15, 64).abs())):
        assert float(((got - want).abs() / scale).max()) <= 3 * 2.0 ** -16
        assert not torch.equal(got, want)


def test_modes_and_flags():
    assert [ef.mode_of(f) for f in (False, True, "high")] == ["fp32", "bf16", "high"]
    assert all(ef.mode_of(ef.FLAGS[m]) == m for m in ef.MODE_IDS)
    with pytest.raises(ValueError):
        ef.mode_of("bf16")


def test_fused_plain_high_matches_lane_kernel_high():
    params, model = params_pair()
    j_args, t_args = layer_args(numpy_batch(4), params["gnn1"], model.gnn1)
    j_out = egnn_forward_pallas_lane(params["gnn1"], *j_args, lane_block=128, interpret=True,
                                     bf16="high")
    (f, tors, feat) = _fused(model.gnn1, t_args, bf16="high")
    assert_layer_close((f, tors, feat), j_out)
    # not the fp32 mode under another name: its outputs move
    f32, tors32, feat32 = _fused(model.gnn1, t_args)
    assert not (torch.equal(f.trans, f32.trans) and torch.equal(tors, tors32)
                and torch.equal(feat, feat32))


def test_loop_layer_high_matches_lane_vjp_high():
    params, model = params_pair()
    j_args, t_args = layer_args(numpy_batch(4), params["gnn1"], model.gnn1)
    fn = lambda p, *a: egnn_forward_pallas_lane_vjp(p, *a, interpret=True, g8=False, bf16="high")
    j_out = fn(params["gnn1"], *j_args)
    t_out, t_params, t_inputs = _loss_torch(model.gnn1, t_args, bf16="high")
    _assert_values_close(t_out, j_out, FP32_VAL_TOL)
    _assert_grads_close(t_params, t_inputs, _loss_jax(fn, params["gnn1"], j_args))


def test_service_fast_f32_trajectory_matches_sample_lane_high():
    params, model = params_pair(seed=2)
    nb, j_inj, t_inj = _inputs(T_STEPS)
    j_out = sample_lane(
        params, jax_model_batch(nb), jax.random.key(0), JDiffusionConfig(noise_step_count=T_STEPS),
        JConfig(noise_step_count=T_STEPS, backend="pallas_lane", lane_block=128),
        precision=jax.lax.Precision.HIGH, injected_noise=j_inj, interpret=True)
    svc = SamplerService(model, batch_size=3, noise_step_count=T_STEPS, fast_f32=True, device="cpu")
    assert svc.precision == "fast-f32" and svc.mode == "high"
    t_out = sample(svc.model, torch_model_batch(nb), svc.diffusion_config, svc.model_config,
                   svc.tables, bf16=svc.mode, injected_noise=t_inj)
    _assert_traj_close(t_out, j_out)


def test_precision_names_and_precedence():
    """``--bf16`` wins over ``--fast-f32``, as in the JAX package; the
    ``pallas`` and ``dense`` backends run fp32 whatever is asked."""
    model = ScoreNetwork(ScoreNetworkConfig(), generator=torch.Generator().manual_seed(0))
    svc = lambda **kw: SamplerService(model, batch_size=2, noise_step_count=4, device="cpu", **kw)
    assert svc(fast_f32=True).precision == "fast-f32"
    assert svc(bf16=True, fast_f32=True).precision == "bf16"
    assert svc().precision == "f32"
    assert svc(backend="pallas", fast_f32=True).precision == "f32"
    assert svc(backend="xla", fast_f32=True).precision == "f32"
    tr = lambda backend, **kw: Trainer(ScoreNetworkConfig(noise_step_count=4, backend=backend),
                                       params=model, device="cpu", **kw)
    high = tr("auto", fast_f32=True)
    assert high.precision == "fast-f32" and high.mode == "high"
    assert tr("auto", bf16=True, fast_f32=True).mode is True
    assert tr("pallas", fast_f32=True).precision == "f32"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast_f32")
    write_synthetic_hdf5(str(d / "train.hdf5"), n_entries=4, peptide_lengths=(9, 10), seed=0)
    write_synthetic_hdf5(str(d / "test.hdf5"), n_entries=2, peptide_lengths=(9, 12), seed=1)
    return d


def _recording(monkeypatch, module, name):
    """Wrap ``module.name`` (a plain version: ten tensor arguments, then
    ``bf16``) to record the ``bf16`` flag of every call."""
    seen, fn = [], getattr(module, name)

    def wrapped(*args, **kw):
        seen.append(kw["bf16"] if "bf16" in kw else args[10])
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def test_clis_fast_f32_run_the_high_mode(data_dir, tmp_path, monkeypatch, caplog):
    model = str(tmp_path / "model.pth")
    loop_flags = _recording(monkeypatch, el, "egnn_loop_plain")
    with caplog.at_level(logging.INFO):
        out = train_cli.main([str(data_dir / "train.hdf5"), "1", model, "-T", "4", "-b", "2",
                              "--fast-f32"] + CPU)
    assert out["precision"] == "fast-f32"
    assert loop_flags and set(loop_flags) == {"high"}
    fused_flags = _recording(monkeypatch, ef, "egnn_fused_plain")
    with caplog.at_level(logging.INFO):
        stats = sample_cli.main([model, str(data_dir / "test.hdf5"), "-T", "4", "-b", "2",
                                 "--fast-f32", "--output-dir", str(tmp_path / "out")] + CPU)
    assert stats["precision"] == "fast-f32" and stats["pdbs"] == 2
    assert fused_flags and set(fused_flags) == {"high"}
    assert any("fast-f32" in r.getMessage() for r in caplog.records)
    assert not any("3-pass" in r.getMessage() for r in caplog.records)
    fused_flags.clear()
    stats = sample_cli.main([model, str(data_dir / "test.hdf5"), "-T", "4", "-b", "2",
                             "--fast-f32", "--bf16", "--output-dir", str(tmp_path / "out16")]
                            + CPU)
    assert stats["precision"] == "bf16" and set(fused_flags) == {True}


def test_http_server_reports_fast_f32_as_the_jax_server_does(tmp_path, monkeypatch):
    """``/healthz``'s ``precision`` under ``--fast-f32``: ``"fast-f32"``, the
    JAX server's value (its own ``create_server``, the sampler stubbed)."""
    import http.client
    import json
    import threading

    import pmhc_tpu.serve as j_serve
    from pmhc_tpu.cli import serve_cli as j_cli
    from pmhc_tpu_torch.cli import serve_cli
    from tests.test_torch_serve_cli import _serve, _stop

    def health(server, thread):
        try:
            conn = http.client.HTTPConnection(*server.server_address, timeout=120)
            conn.request("GET", "/healthz")
            return json.loads(conn.getresponse().read())
        finally:
            _stop(server, thread)

    class StubService:
        def __init__(self, params, **kw):
            self.backend, self.batch_size = kw["backend"], kw["batch_size"]

        def warmup(self):
            return 0.0

    monkeypatch.setattr(j_cli, "_load_params", lambda *a: None)
    monkeypatch.setattr(j_serve, "SamplerService", StubService)
    j_server = j_cli.create_server(j_cli.build_parser().parse_args(
        ["unused.pth", "--port", "0", "--fast-f32"]))
    j_thread = threading.Thread(target=j_server.serve_forever, daemon=True)
    j_thread.start()
    want = health(j_server, j_thread)["precision"]
    model = str(tmp_path / "model.pth")
    torch.save(ScoreNetwork(ScoreNetworkConfig(), generator=torch.Generator().manual_seed(0))
               .state_dict(), model)
    got = health(*_serve(serve_cli.build_parser().parse_args(
        [model, "--port", "0", "--batch-size", "2", "-T", "2", "--fast-f32", "--device", "cpu"])))
    assert got["precision"] == want == "fast-f32"
