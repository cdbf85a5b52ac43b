"""The second score network, ESMFold's structure module
(``pmhc_tpu_torch/models/structure.py``), on the CPU.

- The plain reference (``benchmark/reference_structure/model.py``) against
  ``transformers``' ESMFold modules on copied weights, at the published
  widths and L = 24: invariant point attention, the transition, the
  backbone update with ``Rigid.compose_q_update_vec``, the angle resnet.
  Both sum in fp32 in other orders: within 1e-4 of each output's largest
  magnitude (~1e-6 read).
- The port's network on its CPU path (the IPA attention's plain version)
  against the reference on the reference's seeded weights, at a small
  width and at the published ones: within 1e-4 of each output's largest
  magnitude (~1e-5 read at the published widths, 8 blocks).
- ``SamplerService(architecture="structure")`` chains on the CPU (T = 12,
  and strided to K = 5) followed by the reference's chain from the
  program's recorded states (``reference_structure/check.py``): within a
  tenth of the cell's limits (``benchmark/limits``), and PDB text end to
  end.
- The paths that refuse the network: the trainer, mesh sampling, AOT,
  ``--fast-f32``, and the CLIs' flags; ``--score-network`` on both CLIs.
"""

import http.client
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from benchmark.hooks import ChainTap
from benchmark.inputs import make_pool, request_entry
from benchmark.reference.check import model_batch
from benchmark.reference_structure import check as ref_check
from benchmark.reference_structure import model as ref
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models.structure import (
    StructureNetwork,
    StructureNetworkConfig,
    structure_network_forward,
)
from pmhc_tpu_torch.serve import SamplerService

torch.set_num_threads(1)
SMALL = dict(sequence_dim=32, pairwise_dim=16, ipa_dim=8, num_heads_ipa=4, num_qk_points=2,
             num_v_points=3, resnet_dim=16, num_blocks=3)
SEED = 2 ** 31 + 17
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark",
                       "limits", "pmhc-ipa-f32.sample_structure.json")) as f:
    LIMITS = json.load(f)["limits"]


def close(got, want, rel=1e-4):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), (err, float(want.abs().max()))


# ---------------------------------------------------------------- the reference vs ESMFold


@pytest.fixture(scope="module")
def esm():
    pytest.importorskip("transformers")
    from transformers.models.esm import modeling_esmfold
    from transformers.models.esm.configuration_esm import StructureModuleConfig
    from transformers.models.esm.openfold_utils.rigid_utils import Rigid, Rotation

    return modeling_esmfold, StructureModuleConfig(), Rigid, Rotation


def _load(module, w, prefix):
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in w.items()
                            if k.startswith(prefix + ".")}, strict=True)
    return module.eval()


@pytest.mark.parametrize("part", ["ipa", "transition", "backbone_update", "angle_resnet"])
def test_reference_follows_esmfold(esm, part):
    m, cfg, Rigid, Rotation = esm
    w = ref.make_weights(SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    L = 24
    s = torch.randn(1, L, 384, generator=g)
    quats = ref.normalize(torch.randn(1, L, 4, generator=g))
    trans = torch.randn(1, L, 3, generator=g) * 2
    with torch.no_grad():
        if part == "ipa":
            z = torch.randn(1, L, L, 128, generator=g)
            mask = torch.ones(1, L)
            mask[0, 19:] = 0.0
            want = _load(m.EsmFoldInvariantPointAttention(cfg), w, "ipa")(
                s, z, Rigid(Rotation(quats=quats), trans), mask)
            close(ref.ipa(w, s, z, ref.quat_to_rot(quats), trans, mask), want)
        elif part == "transition":
            want = _load(m.EsmFoldStructureModuleTransition(cfg), w, "transition")(s)
            close(ref.transition(w, s), want)
        elif part == "backbone_update":
            update = _load(m.EsmFoldBackboneUpdate(cfg), w, "bb_update")(s)
            want = Rigid(Rotation(quats=quats), trans).compose_q_update_vec(update)
            got_q, got_t = ref.backbone_update(w, s, quats, trans)
            close(got_q, want.get_rots().get_quats())
            close(got_t, want.get_trans())
        else:
            s_initial = torch.randn(1, L, 384, generator=g)
            _, want = _load(m.EsmFoldAngleResnet(cfg), w, "angle_resnet")(s, s_initial)
            close(ref.angle_resnet(w, s, s_initial), want)


# ---------------------------------------------------------------- the port vs the reference


def _batch(n, seed=7):
    pool = make_pool(n, seed)
    return pool, model_batch(pool, list(range(n)), "cpu")


@pytest.mark.parametrize("widths", [SMALL, {}], ids=["small", "published"])
def test_port_network_matches_reference(widths):
    cfg = ref.config(**widths)
    w = ref.make_weights(SEED, "cpu", cfg)
    net = StructureNetwork(StructureNetworkConfig(**widths))
    net.load_state_dict(w, strict=True)
    _, b = _batch(3)
    b["mask"][2, 5:] = 0.0  # a shorter peptide: padded rows and keys
    g = torch.Generator().manual_seed(3)
    B, N = b["mask"].shape
    q = ref.normalize(torch.randn(B, N, 4, generator=g))
    t = torch.randn(B, N, 3, generator=g) * 5
    tors = torch.randn(B, N, 7, 2, generator=g)
    with torch.no_grad():
        want = ref.score(w, ref.context(w, b, cfg), q, t, tors, torch.full((B,), 0.37), cfg)
        got = structure_network_forward(net, {
            "mask": b["mask"], "features": b["features"], "pocket_features": b["pocket_features"],
            "pocket_mask": b["pocket_mask"], "frames": RigidArray(q, t), "torsions": tors,
            "pocket_frames": RigidArray(b["pocket_quats"], b["pocket_trans"])},
            torch.full((B,), 370.0))
    for g_, w_ in zip((got["frames"].quats, got["frames"].trans, got["torsions"]), want):
        close(g_, w_)


def test_parameter_count_is_the_published_modules():
    net = StructureNetwork()
    assert sum(p.numel() for p in net.parameters()) == 2_037_932
    esm_part = sum(p.numel() for n, p in net.named_parameters() if not n.startswith("embed_"))
    assert esm_part == 2_019_116
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == ref.shapes()


@pytest.mark.parametrize("num_steps", [None, 5], ids=["T12", "strided5"])
def test_cpu_chain_matches_reference(num_steps):
    T, Bn = 12, 2
    w = ref.make_weights(SEED, "cpu")
    pool = make_pool(Bn, 11)
    entries = [request_entry(pool, i) for i in range(Bn)]
    svc = SamplerService({k: v.clone() for k, v in w.items()}, architecture="structure",
                         batch_size=Bn, noise_step_count=T, num_steps=num_steps, seed=1,
                         device="cpu")
    tap = ChainTap(num_steps or T).install()
    try:
        tap.arm()
        gen = svc.batch_generator(4)
        handle = svc.dispatch(entries, gen)
        states = tap.disarm()
    finally:
        tap.uninstall()
    texts = svc.finalize(handle)
    nums = ref_check.check_sampling(w, pool, list(range(Bn)), Bn, gen.initial_seed(), states,
                                    texts, T, "cpu", num_steps=num_steps)
    for k, v in nums.items():
        assert v <= LIMITS[k] / 10, (k, v)


def test_service_end_to_end_to_pdb():
    svc = SamplerService(StructureNetwork(generator=torch.Generator().manual_seed(0)),
                         architecture="structure", batch_size=2, noise_step_count=3, seed=2,
                         device="cpu")
    assert svc.precision == "f32" and svc.architecture == "structure" and svc.backend is None
    pool = make_pool(1, 3)
    pdbs = svc.sample_entries([request_entry(pool, 0)])
    lines = [ln for ln in pdbs[0].decode().splitlines() if ln.startswith("ATOM")]
    assert {ln[21] for ln in lines} == {"P", "M"}
    coords = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in lines])
    assert np.isfinite(coords).all()
    bf16 = SamplerService(svc.model.state_dict(), architecture="structure", batch_size=2,
                          noise_step_count=3, bf16=True, device="cpu")
    assert bf16.precision == "bf16"


# ---------------------------------------------------------------- refusals and the CLIs


def _raises(kind):
    from pmhc_tpu_torch.diffusion import DiffusionConfig
    from pmhc_tpu_torch.diffusion.sampler import make_sample_sharded, sample

    if kind == "trainer":
        from pmhc_tpu_torch.train import Trainer

        Trainer(StructureNetworkConfig(), device="cpu")
    elif kind == "mesh":
        make_sample_sharded(DiffusionConfig(), StructureNetworkConfig(), mesh=None)
    elif kind == "mesh_sample":
        sample(StructureNetwork(), {"mask": torch.ones(1, 16)}, DiffusionConfig(),
               StructureNetworkConfig(), generator=torch.Generator(), mesh=object())
    elif kind == "aot":
        from pmhc_tpu_torch.aot import save_sampler

        save_sampler(SamplerService(StructureNetwork(), architecture="structure", batch_size=1,
                                    noise_step_count=2, device="cpu"), "/nonexistent/x.aot")
    elif kind == "fast_f32":
        SamplerService(StructureNetwork(), architecture="structure", fast_f32=True, device="cpu")
    elif kind == "backend":
        SamplerService(StructureNetwork(), architecture="structure", backend="pallas",
                       device="cpu")


@pytest.mark.parametrize("kind", ["trainer", "mesh", "mesh_sample", "aot", "fast_f32",
                                  "backend"])
def test_refused_with_a_clear_error(kind):
    with pytest.raises(ValueError, match="structure network"):
        _raises(kind)


@pytest.fixture(scope="module")
def structure_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("structure") / "structure.pth"
    torch.save(StructureNetwork(generator=torch.Generator().manual_seed(1)).state_dict(), path)
    return str(path)


@pytest.mark.parametrize("argv", [["--mesh-context", "2"], ["--backend", "cp"]])
def test_sample_cli_refuses_the_mesh(structure_pth, argv):
    from pmhc_tpu_torch.cli import sample_cli

    with pytest.raises(SystemExit, match="one device"):
        sample_cli.main([structure_pth, "x.npz", "--score-network", "structure", "--device",
                         "cpu"] + argv)


def test_sample_cli_score_network(structure_pth, tmp_path):
    from pmhc_tpu_torch.cli import sample_cli
    from pmhc_tpu_torch.data.realistic import realistic_packed

    data = str(tmp_path / "test.npz")
    realistic_packed(3, seed=2).save(data)
    out = sample_cli.main([structure_pth, data, "--score-network", "structure", "-T", "3",
                           "-b", "2", "--output-dir", str(tmp_path / "o"), "--device", "cpu"])
    assert out["pdbs"] == 3 and out["precision"] == "f32"
    assert len(list((tmp_path / "o").iterdir())) == 3


def test_serve_cli_score_network(structure_pth):
    from pmhc_tpu_torch.cli.serve_cli import build_parser, create_server

    with pytest.raises(SystemExit, match="--aot"):
        create_server(build_parser().parse_args([structure_pth, "--score-network", "structure",
                                                 "--aot", "x.aot", "--device", "cpu"]))
    server = create_server(build_parser().parse_args(
        [structure_pth, "--score-network", "structure", "-T", "3", "-b", "2", "--port", "0",
         "--max-wait-ms", "1", "--device", "cpu"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = io.BytesIO()
        np.savez(body, **request_entry(make_pool(1, 4), 0))
        conn = http.client.HTTPConnection(*server.server_address, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.request("POST", "/sample", body=body.getvalue())
        resp = conn.getresponse()
        text = resp.read().decode()
        assert resp.status == 200 and health["backend"] == "structure"
        assert text.rstrip().endswith("END") and " P " in text
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.batcher.close()
        server.server_close()
