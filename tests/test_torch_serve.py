"""The port's structure output and service: PDB bytes identical to the JAX
package's writer (and to the reference fixtures), atom14 against
``pmhc_tpu.io.atoms`` (atol 1e-4), and ``SamplerService`` on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pmhc_tpu.constants as jrc
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.io.atoms import frames_to_atom14_positions as j_atom14
from pmhc_tpu.io.atoms import torsion_angles_to_frames as j_frames
from pmhc_tpu.io.pdb import pdb_bytes as j_pdb_bytes
from pmhc_tpu_torch import constants as trc
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.io.atoms import frames_to_atom14_positions, torsion_angles_to_frames
from pmhc_tpu_torch.io.pdb import pdb_bytes
from pmhc_tpu_torch.serve import SamplerService, dummy_entry, validate_entry
from tests.test_torch_egnn import params_pair

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "fixtures")


def _fixture():
    return dict(np.load(os.path.join(FIXTURES, "pdb_input.npz")))


def test_constants_match_jax_package():
    for name in ("restype_rigid_group_default_frame", "restype_atom14_to_rigid_group",
                 "restype_atom14_mask", "restype_atom14_rigid_group_positions"):
        np.testing.assert_array_equal(getattr(trc, name), getattr(jrc, name))
    assert trc.restypes == jrc.restypes
    assert trc.rigid_group_atom_positions == jrc.rigid_group_atom_positions


def test_atom14_matches_jax():
    data = _fixture()
    rng = np.random.default_rng(0)
    tors = (data["torsions"] * rng.uniform(0.8, 1.2, size=data["torsions"].shape)).astype(np.float32)
    jf = JRigid.from_tensor_7(jnp.asarray(data["frames"]))
    j_rot, j_tr = j_frames(jf, jnp.asarray(tors), jnp.asarray(data["aatype"]),
                           jnp.asarray(jrc.restype_rigid_group_default_frame))
    j_pos = j_atom14(j_rot, j_tr, jnp.asarray(data["aatype"]),
                     jnp.asarray(jrc.restype_atom14_to_rigid_group),
                     jnp.asarray(jrc.restype_atom14_mask),
                     jnp.asarray(jrc.restype_atom14_rigid_group_positions))
    tf = TRigid.from_tensor_7(torch.from_numpy(data["frames"]))
    t_rot, t_tr = torsion_angles_to_frames(tf, torch.from_numpy(tors),
                                           torch.from_numpy(data["aatype"]),
                                           torch.from_numpy(trc.restype_rigid_group_default_frame))
    t_pos = frames_to_atom14_positions(t_rot, t_tr, torch.from_numpy(data["aatype"]),
                                       torch.from_numpy(trc.restype_atom14_to_rigid_group),
                                       torch.from_numpy(trc.restype_atom14_mask),
                                       torch.from_numpy(trc.restype_atom14_rigid_group_positions))
    np.testing.assert_allclose(t_rot.numpy(), np.asarray(j_rot), atol=1e-4)
    np.testing.assert_allclose(t_tr.numpy(), np.asarray(j_tr), atol=1e-4)
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos), atol=1e-4)


@pytest.mark.parametrize("index", [0, 1])
def test_pdb_bytes_equal_jax_and_reference(index):
    data = _fixture()
    j_batch = dict(data)
    j_batch["frames"] = JRigid.from_tensor_7(j_batch.pop("frames"))
    t_batch = {k: torch.from_numpy(v) for k, v in data.items() if k != "frames"}
    t_batch["frames"] = TRigid.from_tensor_7(torch.from_numpy(data["frames"]))
    ours = pdb_bytes(t_batch, index)
    assert ours == j_pdb_bytes(j_batch, index)
    with open(os.path.join(FIXTURES, f"reference_sample_{index}.pdb"), "rb") as f:
        assert ours.splitlines() == f.read().splitlines()


def test_service_on_cpu_returns_one_pdb_per_entry():
    _, model = params_pair(seed=4)
    svc = SamplerService(model.state_dict(), batch_size=4, noise_step_count=4, device="cpu")
    entries = [dummy_entry(protein_len=5 + i, seed=i) for i in range(3)]
    entries[1]["protein_atom14_exists"][:, :4] = True  # backbone atoms in chain M
    pdbs = svc.sample_entries(entries, torch.Generator().manual_seed(3))
    assert len(pdbs) == 3
    for pdb, e in zip(pdbs, entries):
        lines = pdb.decode().splitlines()
        atoms = [ln for ln in lines if ln.startswith("ATOM  ")]
        xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
        assert np.isfinite(xyz).all()
        chain_p = {int(ln[22:26]) for ln in atoms if ln[21] == "P"}
        assert len(chain_p) == int(e["mask"].sum()) == 9
        assert sum(ln[21] == "M" for ln in atoms) == int(e["protein_atom14_exists"].sum())
        assert lines[-1] == "END"


def test_service_warmup_and_dense_backend():
    _, model = params_pair(seed=4)
    for backend in ("dense", "g8"):
        svc = SamplerService(model, batch_size=2, noise_step_count=2, backend=backend,
                             bf16=backend == "g8", device="cpu")
        assert svc.warmup() > 0.0


def test_validate_entry_rejects_wrong_shape():
    e = dummy_entry()
    validate_entry(e)
    bad = dict(e, frames=np.zeros((15, 7), np.float32))
    with pytest.raises(ValueError, match="frames"):
        validate_entry(bad)
    bad = dict(e, protein_atom14_exists=np.zeros((3, 14), bool))
    with pytest.raises(ValueError, match="protein length"):
        validate_entry(bad)
    svc = SamplerService(params_pair()[1], batch_size=2, noise_step_count=2, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        svc.sample_entries([bad | {"protein_atom14_exists": e["protein_atom14_exists"]}
                            | {"frames": np.zeros((15, 7), np.float32)}])
