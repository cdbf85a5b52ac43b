"""Serving: a resident sampler for one batch shape, entries in, PDB bytes
out, and a micro-batching front over it.

Counterpart of ``pmhc_tpu/serve.py``:

- ``SamplerService``: ``sample_entries`` takes up to ``batch_size``
  single-complex entry dicts (numpy, the ``ENTRY_SPECS`` contract),
  replaces the peptide state with pure noise, runs the reverse chain
  (``diffusion.sampler.sample``), converts frames and torsions to atom14 on
  the device and returns one PDB per entry. ``dispatch`` / ``finalize``
  split the device work from the host serialization so a caller can
  overlap them: ``dispatch`` queues the chain (from CUDA graphs on the
  card, ``utils/graphs.py``, one capture per service and kept in its
  ``graph_cache``; every batch has the service's shape) and the copies of
  the PDB arrays into pinned host memory, and returns before the card is
  done; ``finalize`` waits for that batch's copies only.
- ``BatchingSampler``: a thread-safe ``submit(entry) -> Future`` front. A
  collector thread packs queued requests into batches (full batch or
  ``max_wait_ms``, whichever first) and dispatches them; a finisher thread
  waits for the previous batch's arrays and serializes its PDBs while the
  device runs the next. ``max_queue`` bounds the undispatched backlog (``Overloaded``).
- ``frame_models``: N conformations as one multi-MODEL PDB.
- ``entry_from_dataset``: a request entry from a dataset entry.
- The HTTP front end is ``pmhc_tpu_torch.cli.serve_cli``.

The service runs on the card: ``device=None`` means ``"cuda"``, and with
no card it raises unless the caller asks for ``device="cpu"``. Randomness
comes from explicit ``torch.Generator``s on the service's device; a
service built with ``seed`` owns one, used when a call passes none. The
JAX package's ``fold_in(base_key, counter)`` per dispatched batch becomes
``SamplerService.batch_generator(counter)``: a fresh generator seeded
``batch_seed(seed, counter) = (seed mod 2**32) * 2**32 + counter`` (the
``BatchingSampler``'s batches count from 0). A request's trajectory
depends on the batch it lands in, as in the JAX package. The graphed
chain draws from a generator registered with its graph, into which the
caller's generator state is copied per batch, so its noise is the eager
chain's.

Spans (``utils/profiling.py``; ``PERF.md`` §3 names what reads them):
``sampler.dispatch`` (its children ``sampler.stage``, ``sampler.chain``,
``sampler.pin``) and ``sampler.finalize`` (``sampler.wait``,
``sampler.pdb``) share the ``id`` the caller gives ``dispatch`` (the
batcher's and ``sample_cli``'s batch number). The batcher counts
``serve.batches`` and ``serve.padded_rows``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pmhc_tpu_torch.data.dataset import stack_proteins
from pmhc_tpu_torch.data.synthetic import prepare_batch, synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, gen_noise, sample
from pmhc_tpu_torch.io.pdb import convert_batch_for_pdb, fetch_pdb_arrays, pdb_bytes
from pmhc_tpu_torch.models.score import ScoreNetwork, ScoreNetworkConfig, resolve_backend
from pmhc_tpu_torch.models.structure import StructureNetwork, StructureNetworkConfig
from pmhc_tpu_torch.utils.graphs import GraphCache, use_graphs
from pmhc_tpu_torch.utils.profiling import count, span

_log = logging.getLogger(__name__)

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


def entry_from_dataset(dataset, name: str) -> Dict[str, np.ndarray]:
    """A serving request entry from a dataset entry: a ``PmhcDataset`` (a
    SwiftMHC HDF5 file) or a ``PackedDataset`` (its ``.npz``). The keys of
    ``ENTRY_SPECS``, the protein arrays cut to the entry's own length."""
    e = dict(dataset.get_entry(name))
    e.pop("name", None)
    for k in ("pocket_aatype", "pocket_atom14_positions", "pocket_atom14_exists"):
        e.pop(k, None)
    for k, v in dataset.get_protein_positions([name]).items():
        e[k] = v[0]
    return e


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
    return batch, stack_proteins(rows)


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to run on the CPU")
    return dev


class Dispatched(NamedTuple):
    """A dispatched batch: its PDB arrays (host tensors, filled once
    ``done`` has passed on the card), its count of real entries and the id
    of its spans."""

    conv: Dict[str, Any]
    n: int
    done: Optional[torch.cuda.Event]
    id: Optional[int] = None

    def wait(self) -> None:
        """Wait until the arrays are on the host."""
        with span("sampler.wait"):
            if self.done is not None:
                self.done.synchronize()


class SamplerService:
    """A resident sampler for one batch shape.

    ``params``: a ``ScoreNetwork`` or its ``state_dict``. ``backend``:
    ``"auto"`` (also ``"pallas_lane"``/``"g8"``/``"fused"``) takes the fused
    layer — its CUDA kernel on the card, its plain version on the CPU;
    ``"pallas"`` the round-1 fused layer (``ops/egnn_pallas.py``), the same
    way; ``"blockwise"`` the online-softmax layer over neighbour blocks
    (``models/egnn_blockwise.py``); ``"dense"`` (also ``"xla"``) the oracle
    layer. ``bf16`` selects the fused kernel's bf16 mode, ``fast_f32`` its
    high mode (products split into bf16 halves, ~1.5e-5 relative; ``bf16``
    wins if both are asked, as in the JAX package); the ``pallas``,
    ``blockwise`` and ``dense`` backends run fp32 whatever they ask
    (``precision`` says what runs). ``pmhc_tpu_torch/aot.py`` saves a
    service's libraries and weights, and loads them into one. ``graphs`` (default:
    on a CUDA device) runs the chain from CUDA graphs
    (``sampler.STEPS_PER_GRAPH`` steps a graph); ``False`` runs it eagerly
    (debugging, A/B).

    ``architecture``: ``"egnn"`` (the default: the EGNN above) or
    ``"structure"``, the structure network (``models/structure.py``;
    ``params`` a ``StructureNetwork`` or its ``state_dict``), which takes
    ``backend`` ``"auto"`` only (its ``backend`` attribute is None: it has
    no EGNN layer backend), runs fp32 or, with ``bf16``, its linears'
    operands rounded to bf16, and refuses ``fast_f32``.
    """

    def __init__(
        self,
        params: ScoreNetwork | StructureNetwork | Mapping[str, torch.Tensor],
        *,
        architecture: str = "egnn",
        batch_size: int = 64,
        noise_step_count: int = 1000,
        num_steps: int | None = None,
        backend: str = "auto",
        bf16: bool = False,
        fast_f32: bool = False,
        seed: int = 0,
        device=None,
        graphs: bool | None = None,
    ):
        self.device = resolve_device(device)
        self.graphs = use_graphs(graphs, self.device)
        self.graph_cache = GraphCache()
        # fp32 path: no silent TF32 downgrade of torch.matmul or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if architecture not in ("egnn", "structure"):
            raise ValueError(f"unknown architecture {architecture!r}: 'egnn' or 'structure'")
        self.architecture = architecture
        self.batch_size = int(batch_size)
        if architecture == "structure":
            if fast_f32:
                raise ValueError("the structure network has no fast-f32 mode: fp32, or --bf16")
            if resolve_backend(backend) != "fused":
                raise ValueError(f"the structure network has one backend ('auto'), not {backend!r}")
            self.backend = None  # the EGNN's layer backend: the structure network has none
            self.model_config = StructureNetworkConfig(noise_step_count=noise_step_count)
            network = StructureNetwork
        else:
            self.backend = resolve_backend(backend)
            self.model_config = ScoreNetworkConfig(
                noise_step_count=noise_step_count, backend=self.backend)
            network = ScoreNetwork
        self.diffusion_config = DiffusionConfig(noise_step_count=noise_step_count)
        self.tables = ScheduleTables(self.diffusion_config)
        self.bf16 = bool(bf16)
        self.fast_f32 = bool(fast_f32)
        # the kernel mode in the JAX package's convention (mode_of)
        self.mode = True if self.bf16 else "high" if self.fast_f32 else False
        if isinstance(params, nn.Module):
            if not isinstance(params, network):
                raise TypeError(f"a {type(params).__name__} for architecture {architecture!r}")
            model = params
        else:
            model = network(self.model_config)
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.num_steps = num_steps
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

    @property
    def precision(self) -> str:
        """The precision the layers run at, named as the JAX server's
        ``/healthz`` names it: ``"bf16"`` or ``"fast-f32"`` only for the
        fused backend (or the structure network) asked for it, else
        ``"f32"``."""
        if self.architecture == "structure":
            return "bf16" if self.bf16 else "f32"
        if self.backend != "fused":
            return "f32"
        return {True: "bf16", "high": "fast-f32", False: "f32"}[self.mode]

    def batch_generator(self, counter: int) -> torch.Generator:
        """The generator of dispatched batch ``counter`` (``batch_seed``)."""
        return torch.Generator(device=self.device).manual_seed(batch_seed(self.seed, counter))

    # -- device side -------------------------------------------------------

    def build_model_batch(self, entries, generator: torch.Generator):
        """Stack entries into the batch shape on the device, peptide state
        replaced by pure noise. Returns ``(model_batch, protein_arrays)``."""
        if not 0 < len(entries) <= self.batch_size:
            raise ValueError(f"{len(entries)} entries for a batch-{self.batch_size} service")
        with span("sampler.stage"):
            batch, protein = _stack_pad([validate_entry(e) for e in entries], self.batch_size)
            model_batch = prepare_batch(batch, self.device)
            model_batch["aatype"] = torch.as_tensor(batch["aatype"], device=self.device)
            noise = gen_noise(generator, model_batch["frames"].shape, self.diffusion_config)
            model_batch["frames"] = noise["frames"]
            model_batch["torsions"] = noise["torsions"]
        return model_batch, protein

    def sample_model_batch(self, model_batch: Dict[str, Any], generator: torch.Generator,
                           injected_noise: Dict[str, Any] | None = None) -> Dict[str, Any]:
        """The reverse chain on a batch from :meth:`build_model_batch`: from
        the service's CUDA graphs on the card; ``injected_noise`` (tests)
        runs it eagerly with that per-step noise."""
        return sample(self.model, model_batch, self.diffusion_config, self.model_config,
                      self.tables, generator=generator, bf16=self.mode,
                      num_steps=self.num_steps,
                      graphs=self.graphs if injected_noise is None else False,
                      graph_cache=self.graph_cache, injected_noise=injected_noise)

    def dispatch(self, entries: Sequence[Dict[str, np.ndarray]],
                 generator: torch.Generator | None = None, id: int | None = None) -> Dispatched:
        """Queue sampling, the PDB-prep conversion and, on the card, its
        copies into pinned host memory for up to ``batch_size`` entries;
        no wait for the card. Returns a handle for :meth:`finalize`; ``id``
        labels the batch's spans."""
        generator = self.generator if generator is None else generator
        with span("sampler.dispatch", id):
            model_batch, protein = self.build_model_batch(entries, generator)
            pred = self.sample_model_batch(model_batch, generator)
            with span("sampler.pin"):
                pred.update(protein)
                conv = convert_batch_for_pdb(pred)
                if self.device.type != "cuda":
                    return Dispatched(conv, len(entries), None, id)
                # the copies queue behind this batch's sampling, so a caller
                # waits for this batch only, not for one dispatched after it
                host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                        .copy_(v, non_blocking=True)
                        if isinstance(v, torch.Tensor) else v for k, v in conv.items()}
                done = torch.cuda.Event()
                done.record()
        return Dispatched(host, len(entries), done, id)

    # -- host side ---------------------------------------------------------

    @staticmethod
    def finalize(handle: Dispatched) -> List[bytes]:
        """Wait for a :meth:`dispatch` handle's arrays and serialize each
        real entry."""
        with span("sampler.finalize", handle.id):
            handle.wait()
            with span("sampler.pdb"):
                pc = fetch_pdb_arrays(handle.conv)
                return [pdb_bytes(None, i, precomputed=pc) for i in range(handle.n)]

    def sample_entries(self, entries, generator: torch.Generator | None = None) -> List[bytes]:
        """Blocking dispatch + finalize."""
        return self.finalize(self.dispatch(entries, generator))

    def warmup(self) -> float:
        """Run one synthetic entry end to end (builds the kernel on first
        use and, with graphs, captures the chain's step) with batch 0's
        generator; returns elapsed seconds."""
        t0 = time.monotonic()
        self.sample_entries([dummy_entry()], self.batch_generator(0))
        return time.monotonic() - t0



def batch_seed(seed: int, counter: int) -> int:
    """The seed of dispatched batch ``counter`` of a service seeded
    ``seed``: ``(seed mod 2**32) * 2**32 + counter mod 2**32``."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(counter) & 0xFFFFFFFF)


class Overloaded(RuntimeError):
    """Raised by :meth:`BatchingSampler.submit` when the pending-request
    queue is at ``max_queue``: the fail-fast overload signal (the HTTP front
    end maps it to 503 + Retry-After)."""


class BatchingSampler:
    """Thread-safe micro-batching front over a :class:`SamplerService`.

    ``submit(entry)`` returns a ``concurrent.futures.Future`` resolving to
    that entry's PDB bytes. A collector thread packs the queue into batches
    (dispatching as soon as the batch is full or the oldest queued request
    has waited ``max_wait_ms``) with the generator of that batch's number
    (``SamplerService.batch_generator``); a finisher thread waits for batch
    k's arrays (``Dispatched.wait``: the event recorded behind its copies)
    and serializes them while the device samples batch k+1.

    Only the collector queues device work (and captures the chain's graph,
    in its first batch or the service's warm-up). At most two dispatched batches are in flight (the
    ``maxsize=2`` done queue blocks the collector until the finisher
    drains), and ``max_queue`` bounds the undispatched backlog: beyond it
    ``submit`` raises :class:`Overloaded`. ``close()`` drains: every future
    already accepted is resolved (result or exception) before the threads
    exit. ``batches`` counts the dispatched batches.
    """

    def __init__(self, service: SamplerService, max_wait_ms: float = 25.0,
                 max_queue: int | None = None):
        self.service = service
        self.max_queue = max_queue
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue(maxsize=2)  # backpressure
        self._closed = threading.Event()
        self.batches = 0
        # serializes the max_queue headroom check against concurrent
        # submitters (the collector only shrinks the queue, so a
        # check-then-put under this lock never overshoots the bound)
        self._submit_lock = threading.Lock()
        self._collector = threading.Thread(
            target=self._collect_loop, name="pmhc-serve-collect", daemon=True)
        self._finisher = threading.Thread(
            target=self._finish_loop, name="pmhc-serve-finish", daemon=True)
        self._collector.start()
        self._finisher.start()

    def submit(self, entry: Dict[str, np.ndarray]) -> Future:
        return self.submit_many([entry])[0]

    def submit_many(self, entries) -> List[Future]:
        """Atomically enqueue a group of entries (all or none): either every
        entry is accepted (each future resolves to its PDB bytes, or to the
        validation error of that entry) or the whole group is rejected with
        :class:`Overloaded`."""
        if self._closed.is_set():
            raise RuntimeError("BatchingSampler is closed")
        futures: List[Future] = [Future() for _ in entries]
        accepted = []
        for entry, fut in zip(entries, futures):
            try:
                accepted.append((validate_entry(entry), fut))
            except ValueError as e:
                fut.set_exception(e)
        with self._submit_lock:
            if (self.max_queue is not None and accepted
                    and self._q.qsize() + len(accepted) > self.max_queue):
                raise Overloaded(f"pending queue at max_queue={self.max_queue}; retry later")
            for item in accepted:
                self._q.put(item)
        return futures

    def close(self) -> None:
        self._closed.set()
        self._collector.join(timeout=30)
        self._finisher.join(timeout=30)

    # -- internals ---------------------------------------------------------

    def _collect_loop(self) -> None:
        B = self.service.batch_size
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    self._done.put(None)
                    return
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < B:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            entries = [e for e, _ in batch]
            futures = [f for _, f in batch]
            k = self.batches
            generator = self.service.batch_generator(k)
            self.batches += 1
            count("serve.batches")
            count("serve.padded_rows", B - len(batch))
            try:
                handle = self.service.dispatch(entries, generator, id=k)
            except Exception as e:  # noqa: BLE001 — propagate to callers
                for f in futures:
                    f.set_exception(e)
                continue
            self._done.put((handle, futures))

    def _finish_loop(self) -> None:
        while True:
            item = self._done.get()
            if item is None:
                return
            handle, futures = item
            try:
                pdbs = self.service.finalize(handle)
            except Exception as e:  # noqa: BLE001
                _log.exception("serializing a batch failed")
                for f in futures:
                    f.set_exception(e)
                continue
            for f, p in zip(futures, pdbs):
                f.set_result(p)


def frame_models(pdbs: List[bytes]) -> bytes:
    """Join N conformations of one complex into a single multi-MODEL PDB
    (NMR-style framing), as one response body."""
    if len(pdbs) == 1:
        return pdbs[0]
    parts = []
    for i, p in enumerate(pdbs):
        body = p[:-len(b"END\n")] if p.endswith(b"END\n") else p
        parts.append(b"MODEL %8d\n" % (i + 1))
        parts.append(body)
        parts.append(b"ENDMDL\n")
    parts.append(b"END\n")
    return b"".join(parts)
