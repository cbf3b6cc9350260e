"""Host batch pipeline: index sampling → threaded item reads → stacked
batches → (optionally) one background thread that copies them to the card.

Counterpart of ``realpdebench_tpu/data/loader.py`` and of
``core/prefetch.py``'s ``BackgroundGenerator`` and ``prefetch_to_device``:

  * shuffling and batching over indices is a plain numpy permutation, the
    same order as the JAX loader's for a seed;
  * item reads (HDF5 slabs, which release the GIL) run in a thread pool;
  * with ``pin_memory`` the batch is collated straight into pinned CPU
    tensors; ``cycle_loader(..., device=)`` and ``to_device`` run the loader
    in one background thread that copies each batch to the device with
    ``non_blocking=True`` on a side stream, so the copy of batch N+1
    overlaps step N; batches come out in the loader's order.

The final partial batch is dropped (``drop_last``) or padded to full size
with a mask as the third element (``pad_last``), as in the JAX loader.
With ``process_shard`` (data parallelism, ``core/mesh.py``) each process
loads only its slice of every global batch, every process drawing the same
permutation, as the JAX loader does per host.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from realpdebench_tpu_torch.core import mesh


class DataLoader:
    """Minimal epoch loader over a map-style dataset returning numpy pairs.

    Batches are numpy float32 arrays, or with ``pin_memory`` pinned CPU
    torch tensors holding the same values."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 0,
        seed: int = 0,
        drop_last: bool = False,
        pad_last: bool = False,
        pin_memory: bool = False,
        process_shard: bool = False,
        process_count: int | None = None,
        process_index: int | None = None,
    ):
        """``batch_size`` is the GLOBAL batch. With ``process_shard`` each
        process loads only its ``process_index`` slice of every batch (the
        same permutation everywhere: the seed is shared); the pad mask stays
        global-sized. ``process_count``/``process_index`` default to the
        process group's world size and rank (``core.mesh``)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.pin_memory = pin_memory
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        if process_shard:
            self._n_proc = (process_count if process_count is not None
                            else mesh.world_size())
            self._proc = process_index if process_index is not None else mesh.rank()
        else:
            self._n_proc, self._proc = 1, 0
        if process_shard and batch_size % self._n_proc:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{self._n_proc} processes"
            )

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = self._rng.permutation(n)
        return idx

    def _fetch(self, indices):
        if self.num_workers > 0:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                items = list(pool.map(self.dataset.__getitem__, indices))
        else:
            items = [self.dataset[i] for i in indices]
        return tuple(self._collate([it[j] for it in items]) for j in (0, 1))

    def _collate(self, arrays):
        if not self.pin_memory:
            return np.stack(arrays).astype(np.float32)
        out = torch.empty((len(arrays), *arrays[0].shape), dtype=torch.float32,
                          pin_memory=True)
        view = out.numpy()
        for i, a in enumerate(arrays):
            view[i] = a
        return out

    def __iter__(self) -> Iterator:
        idx = self._indices()
        self._epoch += 1
        bs = self.batch_size
        n = len(idx)
        stop = (n // bs) * bs if self.drop_last else n
        per = bs // self._n_proc
        for s in range(0, stop, bs):
            batch_idx = idx[s : s + bs]
            n_valid = len(batch_idx)
            if self.pad_last and n_valid < bs:
                # padded at the index level, so each process's slice is
                # exactly `per`; the mask is global-sized
                batch_idx = np.concatenate(
                    [batch_idx, np.repeat(batch_idx[-1:], bs - n_valid)])
            elif not self.pad_last and self._n_proc > 1 and n_valid < bs:
                raise ValueError(
                    "process_shard with drop_last=False needs pad_last=True "
                    "to keep the final partial batch evenly divisible across "
                    f"processes (got {n_valid} rows for {self._n_proc} "
                    "processes)")
            if self._n_proc > 1:
                batch_idx = batch_idx[self._proc * per : (self._proc + 1) * per]
            xs, ys = self._fetch(batch_idx)
            if self.pad_last:
                mask = np.zeros(bs, np.float32)
                mask[:n_valid] = 1.0
                yield xs, ys, mask
            else:
                yield xs, ys


class _Prefetcher:
    """Runs ``iterable`` in one daemon thread with a bounded queue; with a
    CUDA ``device`` each batch's tensors are copied there on a side stream
    and the consumer's stream waits for that copy."""

    _END = object()

    def __init__(self, iterable, device=None, max_prefetch: int = 2):
        self.device = torch.device(device) if device is not None else None
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.queue: queue.Queue = queue.Queue(max_prefetch)
        self.iterable = iterable
        self.exc = None
        self.assembly_s = 0.0       # the thread's time reading and collating
        self.batches = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, batch):
        """Copy x and y (the first two elements) to the device; anything
        after them (a pad mask) stays on the host."""
        if self.device is None:
            return batch, None
        event = None
        if self.cuda:
            with torch.cuda.stream(self.stream):
                moved = [torch.as_tensor(a).to(self.device, non_blocking=True)
                         for a in batch[:2]]
                event = torch.cuda.Event()
                event.record(self.stream)
        else:
            moved = [torch.as_tensor(a).to(self.device) for a in batch[:2]]
        return (*moved, *batch[2:]), event

    def _worker(self):
        try:
            it = iter(self.iterable)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                self.assembly_s += time.perf_counter() - t0
                self.batches += 1
                item = self._put(batch)
                while not self._stop.is_set():
                    try:
                        self.queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # raised to the consumer by __next__
            self.exc = e
        finally:
            self.queue.put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if item is self._END:
            self.queue.put(self._END)
            if self.exc is not None:
                raise self.exc
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch[:2]:
                # the side stream's allocation is now used on this stream
                t.record_stream(stream)
        return batch

    def close(self):
        """Stop the thread (after the batch it is reading) and wait for it."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.queue.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()


def to_device(iterable, device=None, max_prefetch: int = 2) -> _Prefetcher:
    """``iterable``'s batches from a background thread, x and y as torch
    tensors on ``device`` (None: as they are); ``close()`` stops the
    thread."""
    return _Prefetcher(iterable, device, max_prefetch)


def cycle_loader(loader: DataLoader, background: bool = True, device=None):
    """Infinite batch stream (reference ``cycle``), staged in a background
    thread that also copies the batches to ``device`` when one is given."""

    def gen():
        while True:
            for batch in loader:
                yield batch

    if background:
        return to_device(gen(), device, max_prefetch=4 if device is None else 2)
    return gen()
