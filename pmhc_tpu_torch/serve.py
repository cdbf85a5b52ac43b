"""Serving: a resident sampler for one batch shape, entries in, PDB bytes out.

Counterpart of ``pmhc_tpu/serve.py::SamplerService``: ``sample_entries``
takes up to ``batch_size`` single-complex entry dicts (numpy, the
``ENTRY_SPECS`` contract), replaces the peptide state with pure noise,
runs the reverse chain (``diffusion.sampler.sample``), converts frames
and torsions to atom14 on the device and returns one PDB per entry.
``dispatch`` / ``finalize`` split the device work from the host
serialization so a caller can overlap them.

The service runs on the card: ``device=None`` means ``"cuda"``, and with
no card it raises unless the caller asks for ``device="cpu"``. Randomness
comes from explicit ``torch.Generator``s on the service's device; a
service built with ``seed`` owns one, used when a call passes none.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, gen_noise, sample
from pmhc_tpu_torch.io.pdb import convert_batch_for_pdb, fetch_pdb_arrays, pdb_bytes
from pmhc_tpu_torch.models.score import ScoreNetwork, ScoreNetworkConfig, resolve_backend

# Single-entry request contract: name -> (shape with None for the
# variable protein length, accepted dtype kinds).
ENTRY_SPECS: Dict[str, tuple] = {
    "mask": ((16,), "b"),
    "frames": ((16, 7), "f"),
    "features": ((16, 22), "f"),
    "aatype": ((16,), "iu"),
    "torsions": ((16, 7, 2), "f"),
    "torsions_mask": ((16, 7), "b"),
    "pocket_features": ((80, 22), "f"),
    "pocket_mask": ((80,), "b"),
    "pocket_frames": ((80, 7), "f"),
    "protein_aatype": ((None,), "iu"),
    "protein_atom14_positions": ((None, 14, 3), "f"),
    "protein_atom14_exists": ((None, 14), "b"),
}


def validate_entry(entry: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Shape/dtype-check one request entry; returns it with arrays coerced
    to the canonical dtypes. Raises ValueError on drift."""
    out = {}
    missing = [k for k in ENTRY_SPECS if k not in entry]
    if missing:
        raise ValueError(f"entry missing fields: {missing}")
    n_protein = None
    for k, (shape, kinds) in ENTRY_SPECS.items():
        a = np.asarray(entry[k])
        if a.ndim != len(shape):
            raise ValueError(f"{k}: expected rank {len(shape)}, got shape {a.shape}")
        for d, want in zip(a.shape, shape):
            if want is not None and d != want:
                raise ValueError(f"{k}: expected shape {shape}, got {a.shape}")
        if shape[0] is None:
            if n_protein is None:
                n_protein = a.shape[0]
            elif a.shape[0] != n_protein:
                raise ValueError(
                    f"{k}: protein length {a.shape[0]} != {n_protein} of the "
                    "other protein_* arrays")
        ok_kinds = kinds + ("iu" if kinds == "b" else "")  # ints coerce to bool
        if a.dtype.kind not in ok_kinds:
            raise ValueError(f"{k}: dtype {a.dtype} not allowed (kind {kinds})")
        out[k] = a.astype({"b": np.bool_, "f": np.float32, "iu": np.int32}[kinds])
    return out


def dummy_entry(protein_len: int = 8, seed: int = 0) -> Dict[str, np.ndarray]:
    """A structurally valid request entry (synthetic geometry)."""
    sb = synthetic_batch(batch_size=1, peptide_len=9, seed=seed)
    entry = {k: np.asarray(v[0]) for k, v in sb.items()
             if k in ENTRY_SPECS and not k.startswith("protein_")}
    entry["protein_aatype"] = np.zeros((protein_len,), np.int32)
    entry["protein_atom14_positions"] = np.zeros((protein_len, 14, 3), np.float32)
    entry["protein_atom14_exists"] = np.zeros((protein_len, 14), np.bool_)
    return entry


def _stack_pad(entries: Sequence[Dict[str, np.ndarray]], batch_size: int):
    """Stack entries into one batch of exactly ``batch_size`` rows (short
    batches repeat row 0; only real rows are returned) and pad the
    variable-length protein_* arrays to the batch max."""
    rows = list(entries) + [entries[0]] * (batch_size - len(entries))
    batch = {k: np.stack([r[k] for r in rows])
             for k in ENTRY_SPECS if not k.startswith("protein_")}
    max_l = max(r["protein_aatype"].shape[0] for r in rows)

    def pad(a):
        if a.shape[0] == max_l:
            return a
        return np.concatenate((a, np.zeros((max_l - a.shape[0],) + a.shape[1:], dtype=a.dtype)))

    protein = {k: np.stack([pad(r[k]) for r in rows])
               for k in ENTRY_SPECS if k.startswith("protein_")}
    return batch, protein


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to run on the CPU")
    return dev


class SamplerService:
    """A resident sampler for one batch shape.

    ``params``: a ``ScoreNetwork`` or its ``state_dict``. ``backend``:
    ``"auto"`` (also ``"pallas_lane"``/``"g8"``/``"fused"``) takes the fused
    layer — its CUDA kernel on the card, its plain version on the CPU;
    ``"dense"`` the oracle layer. ``bf16`` selects the kernel's bf16 mode.
    ``fast_f32`` runs the fp32 mode: the port has no 3-pass mode yet.
    """

    def __init__(
        self,
        params: ScoreNetwork | Mapping[str, torch.Tensor],
        *,
        batch_size: int = 64,
        noise_step_count: int = 1000,
        num_steps: int | None = None,
        backend: str = "auto",
        bf16: bool = False,
        fast_f32: bool = False,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        # fp32 path: no silent TF32 downgrade of torch.matmul or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.backend = resolve_backend(backend)
        self.batch_size = int(batch_size)
        self.model_config = ScoreNetworkConfig(
            noise_step_count=noise_step_count, backend=self.backend)
        self.diffusion_config = DiffusionConfig(noise_step_count=noise_step_count)
        self.tables = ScheduleTables(self.diffusion_config)
        self.bf16 = bool(bf16)
        self.fast_f32 = bool(fast_f32)  # runs as fp32
        if isinstance(params, ScoreNetwork):
            model = params
        else:
            model = ScoreNetwork(self.model_config)
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.num_steps = num_steps
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # -- device side -------------------------------------------------------

    def build_model_batch(self, entries, generator: torch.Generator):
        """Stack entries into the batch shape on the device, peptide state
        replaced by pure noise. Returns ``(model_batch, protein_arrays)``."""
        if not 0 < len(entries) <= self.batch_size:
            raise ValueError(f"{len(entries)} entries for a batch-{self.batch_size} service")
        batch, protein = _stack_pad([validate_entry(e) for e in entries], self.batch_size)
        model_batch = prepare_batch(batch, self.device)
        model_batch["aatype"] = torch.as_tensor(batch["aatype"], device=self.device)
        noise = gen_noise(generator, model_batch["frames"].shape, self.diffusion_config)
        model_batch["frames"] = noise["frames"]
        model_batch["torsions"] = noise["torsions"]
        return model_batch, protein

    def dispatch(self, entries: Sequence[Dict[str, np.ndarray]],
                 generator: torch.Generator | None = None):
        """Queue sampling + the PDB-prep conversion for up to ``batch_size``
        entries; no host fetch. Returns a handle for :meth:`finalize`."""
        generator = self.generator if generator is None else generator
        model_batch, protein = self.build_model_batch(entries, generator)
        pred = sample(self.model, model_batch, self.diffusion_config, self.model_config,
                      self.tables, generator=generator, bf16=self.bf16,
                      num_steps=self.num_steps)
        pred.update(protein)
        return convert_batch_for_pdb(pred), len(entries)

    # -- host side ---------------------------------------------------------

    @staticmethod
    def finalize(handle) -> List[bytes]:
        """Fetch a :meth:`dispatch` handle and serialize each real entry."""
        conv, n = handle
        pc = fetch_pdb_arrays(conv)
        return [pdb_bytes(None, i, precomputed=pc) for i in range(n)]

    def sample_entries(self, entries, generator: torch.Generator | None = None) -> List[bytes]:
        """Blocking dispatch + finalize."""
        return self.finalize(self.dispatch(entries, generator))

    def warmup(self) -> float:
        """Run one synthetic entry end to end (builds the kernel on first
        use); returns elapsed seconds."""
        t0 = time.monotonic()
        self.sample_entries([dummy_entry()])
        return time.monotonic() - t0

