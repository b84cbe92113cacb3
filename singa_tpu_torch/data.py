"""Host-side input pipeline of the port.  Counterpart:
``singa_tpu/data.py`` (the reference's ``python/singa/data.py`` role).

The step consumes one batch an iteration; the host's job is to have the
next batch ready before the card finishes the current one, so the loader
shuffles, slices and transforms on a background thread and hands batches
over a small queue (producer/consumer prefetch).  The batch order is the
reference's: epoch ``e`` visits ``RandomState(seed + e).permutation(n)``,
so the same seed gives the same batches in both packages, and the
resumable cursor (``state_dict``) is the reference's too.

``to_device`` is the card's counterpart of the worker's
``jax.device_put``: the worker copies each batch to the device and, on a
card, waits for its stream before it queues the batch, so a batch the
step receives is complete.  The copy runs on the device's default
stream, the stream the port's steps and replays run on, so the caching
allocator hands a batch's memory out again only after work queued
before its release there is done.

:class:`BinFileDataset` reads training data stored as a Snapshot
(:mod:`singa_tpu_torch.snapshot`).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .device import _NARROW, get_device
from .snapshot import Snapshot

__all__ = ["ArrayDataset", "BinFileDataset", "DataLoader"]


class ArrayDataset:
    """Zip of equal-length arrays (features, labels, ...)."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("arrays must have equal length")
        self.arrays = [np.asarray(a) for a in arrays]

    def __len__(self):
        return len(self.arrays[0])

    def take(self, idx):
        """Batch of rows by index array."""
        return tuple(a[idx] for a in self.arrays)


class BinFileDataset(ArrayDataset):
    """Dataset from a BinFile written as named arrays (e.g. Snapshot with
    keys "x" and "y"); ``keys`` picks and orders the record columns."""

    def __init__(self, prefix: str, keys=("x", "y")):
        records = Snapshot(prefix, False).read()
        super().__init__(*(records[k] for k in keys))


class DataLoader:
    """Shuffling, batching, background-prefetching iterator.

    >>> for xb, yb in DataLoader(ArrayDataset(x, y), 64, seed=0):
    ...     model.train_one_batch(xb, yb)

    ``transform``: optional fn applied to each batch tuple on the WORKER
    thread (host augmentation overlaps device compute).  Each epoch
    reshuffles deterministically from ``seed``.

    ``to_device``: optional :class:`~singa_tpu_torch.device.Device` (or
    a ``torch.device`` or its name): the worker thread puts each batch
    there as soon as it is built (64-bit host types narrowed to 32 bits,
    as ``jax.device_put`` with x64 off), so the copy of batch N+1
    overlaps the host's work on batch N (see the module docstring for
    the synchronisation); the batches are then ``torch.Tensor``
    objects.

    The loader carries a RESUMABLE CURSOR (``epoch``, consumed-batch
    position): :meth:`state_dict` / :meth:`load_state_dict` capture and
    restore it, so a checkpointed-and-resumed run replays the exact
    batch order of an uninterrupted one (the shuffle RNG is a pure
    function of ``seed + epoch``, so (seed, epoch, pos) IS the full RNG
    state).  Iterating resumes mid-epoch from the cursor; a completed
    epoch advances ``epoch`` and rewinds the position to 0.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 transform=None, to_device=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, int(prefetch))
        self.transform = transform
        self.to_device = to_device
        self._epoch = 0
        self._pos = 0  # batches already CONSUMED in the current epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def epoch(self) -> int:
        return self._epoch

    def state_dict(self) -> dict:
        """Resume cursor: epoch, consumed-batch position, and the shuffle
        seed (the per-epoch RNG is derived from ``seed + epoch``)."""
        return {"epoch": int(self._epoch), "pos": int(self._pos),
                "seed": int(self.seed)}

    def load_state_dict(self, state: dict) -> None:
        if int(state["seed"]) != int(self.seed):
            raise ValueError(
                f"loader cursor was saved with seed={state['seed']} but "
                f"this loader has seed={self.seed}; the shuffled batch "
                "order would diverge — construct the loader with the "
                "original seed for an exact resume")
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self._epoch).permutation(n)
        return np.arange(n)

    def __iter__(self):
        idx = self._indices()
        nb = len(self)
        start = min(self._pos, nb)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _SENTINEL = object()
        dev = None if self.to_device is None else get_device(self.to_device)

        def worker():
            try:
                for b in range(start, nb):
                    if stop.is_set():  # consumer abandoned the epoch
                        return
                    sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    batch = self.dataset.take(sel)
                    if self.transform is not None:
                        batch = self.transform(*batch)
                    if dev is not None:
                        batch = _put(batch, dev)
                    q.put(batch)
            except BaseException as e:  # surface worker crashes to consumer
                q.put(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    # epoch completed: advance the cursor.  Early exit
                    # (break) leaves it mid-epoch so re-iteration resumes.
                    self._epoch += 1
                    self._pos = 0
                    return
                if isinstance(item, BaseException):
                    raise item
                # advance BEFORE yielding: a checkpoint taken while the
                # consumer processes this batch must record it as consumed
                self._pos += 1
                yield item
        finally:
            # early exit (break/close): signal the worker and unblock its
            # possibly-full queue put; blocking get avoids a busy spin
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass


def _put(batch, dev):
    """``batch`` on ``dev``; on a card the worker waits for the copies."""
    out = tuple((a.detach() if isinstance(a, torch.Tensor)
                 else _host_tensor(np.asarray(a))).to(dev.torch_device)
                for a in batch)
    if dev.lang == "cuda":
        torch.cuda.current_stream(dev.torch_device).synchronize()
    return out


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(a))
