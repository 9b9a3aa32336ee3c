"""Batches built and uploaded on a background thread (counterpart of
``mural_tpu/data/prefetch.py``).

A worker thread runs the host batch iterator (the numpy window gather
and encode) and, for a CUDA device, copies each batch's arrays from
pinned host memory with ``non_blocking`` copies on a side stream of its
own, then records an event.  The consumer takes batches from a bounded
queue; before one is handed out, the consumer's current stream waits on
its event and its tensors are marked as used on that stream
(``record_stream``), so the allocator keeps them until the consumer's
work is done.  Batches come in the iterator's order, and the iterator
draws its rng numbers on the worker in the sequence an inline loop
would.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from mural_tpu_torch.data.batcher import Batch

# (field, torch dtype on the device or None to keep the array's)
_FIELDS = (("y", torch.int64), ("cat", torch.int64), ("distal", None),
           ("mask", None), ("cont", None), ("distal_tracks", None))


class DeviceBatch:
    """One :class:`Batch` on the device: ``y`` and ``cat`` int64,
    ``distal`` the uint8 codes, ``mask`` float32 (1 for the ``n_valid``
    real rows), ``cont`` and ``distal_tracks`` float32 or None."""
    __slots__ = ("y", "cat", "distal", "mask", "cont", "distal_tracks",
                 "n_valid", "rows", "event")

    def __init__(self, tensors: dict, n_valid: int, rows: np.ndarray,
                 event=None):
        for name, _ in _FIELDS:
            setattr(self, name, tensors[name])
        self.n_valid = n_valid
        self.rows = rows
        self.event = event

    def tensors(self) -> tuple:
        """(y, cat, distal, mask, cont, distal_tracks)."""
        return tuple(getattr(self, name) for name, _ in _FIELDS)


class StackedDeviceBatch(DeviceBatch):
    """``k`` host batches stacked on a leading axis, for K train steps
    per CUDA graph replay (``train/graphs.py``)."""
    __slots__ = ("k", "n_valids")

    def __init__(self, tensors: dict, n_valids: list, event=None):
        super().__init__(tensors, sum(n_valids), None, event)
        self.k = len(n_valids)
        self.n_valids = n_valids


def _valid_mask(batch: Batch) -> np.ndarray:
    return (np.arange(len(batch.y)) < batch.n_valid).astype(np.float32)


def _arrays(batch: Batch) -> dict:
    return {"y": batch.y, "cat": batch.cat, "distal": batch.distal,
            "mask": _valid_mask(batch), "cont": batch.cont,
            "distal_tracks": batch.distal_tracks}


class _Uploader:
    """Copies host arrays to ``device``: on a CUDA device from pinned
    memory on a side stream, ending in an event the consumer waits on."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, arrays: dict):
        """(tensors by field, event or None)."""
        if self.stream is None:
            return {name: self._tensor(arrays[name], dtype, False)
                    for name, dtype in _FIELDS}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {name: self._tensor(arrays[name], dtype, True)
                   for name, dtype in _FIELDS}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def _tensor(self, a, dtype, pinned: bool):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pinned:
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t if dtype is None else t.to(dtype)


def _ready(item: DeviceBatch) -> DeviceBatch:
    """Order the consumer's current stream after the batch's copies."""
    if item.event is not None:
        stream = torch.cuda.current_stream(item.y.device)
        stream.wait_event(item.event)
        for t in item.tensors():
            if t is not None:
                t.record_stream(stream)
    return item


def _threaded_iter(produce: Callable, size: int) -> Iterator:
    """Run ``produce(emit)`` on a worker thread, yielding what it emits
    through a bounded queue.  ``emit(item) -> bool`` returns False when
    the consumer abandoned the generator (break or exception), so the
    worker stops instead of blocking on a full queue; a worker exception
    re-raises in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def emit(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            produce(emit)
        except BaseException as e:  # surfaced in the consumer
            err.append(e)
        finally:
            emit(sentinel)

    threading.Thread(target=worker, name="mural-prefetch",
                     daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def prefetch(batches: Iterator[Batch], device, size: int = 2
             ) -> Iterator[DeviceBatch]:
    """:class:`DeviceBatch` objects of ``batches``, built and uploaded
    ``size`` ahead on a worker thread."""
    upload = _Uploader(device)

    def produce(emit):
        for b in batches:
            tensors, event = upload(_arrays(b))
            if not emit(DeviceBatch(tensors, b.n_valid, b.rows, event)):
                return

    for item in _threaded_iter(produce, size):
        yield _ready(item)


def prefetch_stacked(batches: Iterator[Batch], k: int, device,
                     size: int = 2) -> Iterator[DeviceBatch]:
    """Groups of ``k`` host batches stacked on a leading axis
    (:class:`StackedDeviceBatch`), built on a worker thread; a final
    group of fewer than ``k`` batches comes as single
    :class:`DeviceBatch` objects, which run as single steps."""
    upload = _Uploader(device)

    def produce(emit):
        group: list = []
        for b in batches:
            group.append(b)
            if len(group) < k:
                continue
            parts = [_arrays(g) for g in group]
            tensors, event = upload({
                name: None if parts[0][name] is None
                else np.stack([p[name] for p in parts])
                for name, _ in _FIELDS})
            if not emit(StackedDeviceBatch(
                    tensors, [g.n_valid for g in group], event)):
                return
            group = []
        for b in group:
            tensors, event = upload(_arrays(b))
            if not emit(DeviceBatch(tensors, b.n_valid, b.rows, event)):
                return

    for item in _threaded_iter(produce, size):
        yield _ready(item)


def stacked_inputs(db: DeviceBatch) -> tuple:
    """The ``(k, ...)`` tensors of a batch group: a single batch gets a
    leading axis of 1."""
    if isinstance(db, StackedDeviceBatch):
        return db.tensors()
    return tuple(None if t is None else t[None] for t in db.tensors())
