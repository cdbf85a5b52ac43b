"""Prefetching batch loader.

Counterpart of ``pmhc_tpu/data/loader.py``:

- the epoch order is ``np.random.default_rng(seed + epoch).permutation(n)``
  (or ``arange(n)`` without ``shuffle``), sharded per process as
  ``order[process_index::process_count]``; ``drop_last`` drops a short
  final batch;
- a dataset with ``get_batch`` (``PackedDataset``, ``DeviceDataset``) gives
  collated batches in one call; any other dataset is read entry by entry
  on a thread pool over a sliding window of the next ``prefetch + 1``
  batches, so reads overlap collation and the copy to the device;
- a producer thread keeps ``prefetch`` batches queued; an error there is
  raised to the consumer, and the next ``iter()`` starts afresh. A
  ``DeviceDataset`` has no thread: its gather is queued on the device,
  so a thread would overlap nothing and would take the GIL from the
  host-bound step loop.

With ``device=None`` batches stay numpy (the JAX loader's
``device_put=False``). With a device, each batch is collated into tensors
(on a CUDA device: fresh pinned host tensors, one set per batch, copied
with ``non_blocking=True`` on the current stream; the caching host
allocator keeps a pinned block from reuse until its copy has completed).
Tensors already on the device (a ``DeviceDataset`` batch) pass untouched.
``name`` stays a host list.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch

from pmhc_tpu_torch.data.packed import DeviceDataset


def collate(entries: Sequence[Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """Stack entry dicts; string fields become lists."""
    batch: Dict[str, Any] = {}
    for key in entries[0]:
        vals = [e[key] for e in entries]
        if isinstance(vals[0], str):
            batch[key] = vals
        else:
            batch[key] = np.stack(vals)
    return batch


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Every array of ``batch`` as a tensor on ``device``; lists stay."""
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = v
        elif isinstance(v, torch.Tensor) and v.device == device:
            out[k] = v
        else:
            t = torch.as_tensor(v)
            if pin and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
    return out


class PrefetchLoader:
    """Iterable over the batches of a dataset, ``device=None`` numpy."""

    def __init__(self, dataset, batch_size: int = 64, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = False,
                 device=None, process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.device = None if device is None else torch.device(device)
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0

    def _epoch_indices(self) -> List[int]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(n)
        return list(order[self.process_index::self.process_count])

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._epoch_indices()
        self._epoch += 1
        batches = [indices[i:i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # give up when the consumer went away, so the thread ends
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def upload(batch):
            return batch if self.device is None else _to_device(batch, self.device)

        if isinstance(self.dataset, DeviceDataset):
            for batch_idx in batches:
                yield upload(self.dataset.get_batch(batch_idx))
            return

        def produce_packed():
            # collated batches from one fancy-indexing call each
            try:
                for batch_idx in batches:
                    if not put(upload(self.dataset.get_batch(batch_idx))):
                        return
            except Exception as exc:  # noqa: BLE001 — raised to the consumer
                put(exc)
            finally:
                put(sentinel)

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # entry reads of the next few batches are in flight
                    # while the current batch collates and uploads
                    window = self.prefetch + 1
                    pending = [[pool.submit(self.dataset.__getitem__, i) for i in b]
                               for b in batches[:window]]
                    for k in range(len(batches)):
                        if k + window < len(batches):
                            pending.append([pool.submit(self.dataset.__getitem__, i)
                                            for i in batches[k + window]])
                        entries = [f.result() for f in pending[k]]
                        pending[k] = None
                        if not put(upload(collate(entries))):
                            return
            except Exception as exc:  # noqa: BLE001 — raised to the consumer
                put(exc)
            finally:
                put(sentinel)

        producer = produce_packed if hasattr(self.dataset, "get_batch") else produce
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)
