"""The output farm of genome-wide prediction (counterpart of
``mural_tpu/predict/post_farm.py``).

A chunk (chrom, positions, strands, logits) is softmaxed in float64,
calibrated (the calibrator's ``predict_proba`` is numpy), optionally
Poisson-calibrated, formatted to TSV bytes by the native formatter
(:func:`mural_tpu_torch.native.format_pred_tsv`) and compressed as one
gzip member (concatenated members are a valid gzip stream):

- with ``n_workers > 0`` chunks fan out to spawned worker processes and
  a writer thread restores their order by sequence number, so the file
  is byte-identical to the inline one;
- with ``n_workers = 0`` everything runs inline.

Workers never touch CUDA.  A worker that unpickles a calibrator of this
package loads torch (``calibrate/multinomial.py``); it runs on one
thread, so that several workers do not oversubscribe the host.

Spans and counters (:mod:`mural_tpu_torch.utils.spans`):
``farm.queue_wait`` (a submit blocked on the full task queue) or, inline,
``farm.inline`` (the postprocess itself); as each chunk is written, the
counters ``farm.rows_written`` and ``farm.worker_busy_s`` (the seconds a
worker spent on the chunk, which it times itself), each keyed by the
chunk's sequence number and given the farm's worker count.
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
import zlib
from typing import Optional

import numpy as np

from mural_tpu_torch import native
from mural_tpu_torch.calibrate.poisson import poisson_calibrate
from mural_tpu_torch.utils import spans

# seconds between the liveness checks of a blocked submit or close
POLL_S = 5.0


def auto_n_workers(cores: Optional[int] = None) -> int:
    """Default worker count: inline on <= 2 cores, where spawned workers
    contend with the main process's feed and drain threads for the same
    cores and pay pickling for every chunk; else leave 2 cores to the
    main process and cap at 6 (beyond that the one ordered writer thread
    sets the pace).  The JAX package's policy."""
    if cores is None:
        import os
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:
            cores = os.cpu_count() or 1
    if cores <= 2:
        return 0
    return min(cores - 2, 6)


def _gzip_member(data: bytes, compresslevel: int) -> bytes:
    co = zlib.compressobj(compresslevel, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def postprocess_chunk(chrom: str, pos: np.ndarray, neg: np.ndarray,
                      logits: np.ndarray, calibrator, poisson: bool,
                      compresslevel: int = 0) -> tuple:
    """logits -> calibrated probabilities -> TSV bytes (one gzip member
    when ``compresslevel`` is set).  Returns (n_rows, blob)."""
    logits = np.asarray(logits, dtype=np.float64)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    if calibrator is not None:
        probs = calibrator.predict_proba(probs)
    if poisson:
        probs = poisson_calibrate(probs)
    blob = native.format_pred_tsv(chrom, pos, neg, probs)
    if compresslevel:
        blob = _gzip_member(blob, compresslevel)
    return len(pos), blob


def _worker(task_q, result_q, calib_blob: bytes, poisson: bool,
            compresslevel: int) -> None:
    import torch
    torch.set_num_threads(1)
    calibrator = pickle.loads(calib_blob) if calib_blob else None
    while True:
        item = task_q.get()
        if item is None:
            return
        seq, chrom, pos, neg, logits = item
        t0 = time.perf_counter()
        try:
            n, blob = postprocess_chunk(chrom, pos, neg, logits,
                                        calibrator, poisson, compresslevel)
            result_q.put((seq, n, blob, None, time.perf_counter() - t0))
        except Exception as exc:  # surfaced in the main process
            result_q.put((seq, 0, b"", repr(exc), 0.0))


class PostprocessFarm:
    """Ordered calibrate + format + compress fan-out.

    ``submit`` takes chunks in order; ``close`` flushes everything and
    returns the row count; ``abort`` stops the workers after a failure
    elsewhere.  The output bytes are the same for any ``n_workers``."""

    def __init__(self, out_path: str, header_cols, calibrator=None,
                 poisson: bool = False, n_workers: int = 0,
                 compresslevel: int = 1):
        self.gz = out_path.endswith(".gz")
        self.compresslevel = compresslevel if self.gz else 0
        self.calibrator = calibrator
        self.poisson = poisson
        self.n_workers = n_workers
        self.total = 0
        self._seq = 0
        self._error: Optional[str] = None
        # workers find the library built
        native.load()
        self._fh = open(out_path, "wb")
        header = ("\t".join(header_cols) + "\n").encode()
        self._fh.write(_gzip_member(header, self.compresslevel)
                       if self.gz else header)
        if n_workers > 0:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            self._task_q = ctx.Queue(maxsize=2 * n_workers)
            self._result_q = ctx.Queue()
            calib_blob = pickle.dumps(calibrator) if calibrator else b""
            self._procs = [
                ctx.Process(target=_worker,
                            args=(self._task_q, self._result_q, calib_blob,
                                  poisson, self.compresslevel),
                            daemon=True)
                for _ in range(n_workers)]
            for p in self._procs:
                p.start()
            self._done = 0
            self._buffer: dict = {}
            self._next_write = 0
            self._lock = threading.Condition()
            self._writer = threading.Thread(target=self._drain, daemon=True,
                                            name="mural-farm-writer")
            self._writer.start()

    def _drain(self) -> None:
        """Writer thread: re-order completed chunks and append them."""
        while True:
            item = self._result_q.get()
            if item is None:
                return
            seq, n, blob, err, busy = item
            with self._lock:
                if err and self._error is None:
                    self._error = err
                self._buffer[seq] = (n, blob, busy)
                while self._next_write in self._buffer:
                    n2, b2, busy2 = self._buffer.pop(self._next_write)
                    self._write(self._next_write, n2, b2)
                    spans.count("farm.worker_busy_s", busy2,
                                key=self._next_write,
                                workers=self.n_workers)
                    self._next_write += 1
                self._done += 1
                self._lock.notify_all()

    def _write(self, seq: int, n: int, blob: bytes) -> None:
        self._fh.write(blob)
        self.total += n
        spans.count("farm.rows_written", n, key=seq,
                    workers=self.n_workers)

    def _workers_alive(self) -> bool:
        return all(p.is_alive() for p in self._procs)

    def submit(self, chrom: str, pos: np.ndarray, neg: np.ndarray,
               logits: np.ndarray) -> None:
        if self._error:
            raise RuntimeError(f"postprocess worker failed: {self._error}")
        if self.n_workers == 0:
            with spans.span("farm.inline", key=self._seq):
                n, blob = postprocess_chunk(chrom, pos, neg, logits,
                                            self.calibrator, self.poisson,
                                            self.compresslevel)
            self._write(self._seq, n, blob)
        else:
            item = (self._seq, chrom, np.ascontiguousarray(pos),
                    np.ascontiguousarray(neg), np.asarray(logits))
            with spans.span("farm.queue_wait", key=self._seq):
                while True:
                    try:
                        self._task_q.put(item, timeout=POLL_S)
                        break
                    except queue.Full:
                        # a worker killed by the OS never drains the
                        # bounded queue: fail instead of blocking the run
                        # forever
                        if not self._workers_alive():
                            raise RuntimeError(
                                "postprocess worker process died; see any "
                                "earlier error, or check host memory")
        self._seq += 1

    def close(self) -> int:
        if self.n_workers > 0:
            with self._lock:
                # bounded waits and liveness checks: a worker that dies
                # without posting its result would leave _done < _seq
                while not (self._done >= self._seq
                           or self._error is not None):
                    self._lock.wait(timeout=POLL_S)
                    if (self._done < self._seq and self._error is None
                            and not self._workers_alive()):
                        # grace period: results the others queued drain
                        # through the writer thread first
                        self._lock.wait(timeout=POLL_S)
                        if self._done < self._seq:
                            self._error = ("worker process died without "
                                           "posting a result")
            if self._error:
                self.abort()
                raise RuntimeError(
                    f"postprocess worker failed: {self._error}")
            for _ in self._procs:
                self._task_q.put(None)
            self._result_q.put(None)
            self._writer.join()
            for p in self._procs:
                p.join(timeout=30)
        self._fh.close()
        return self.total

    def abort(self) -> None:
        """Stop the workers and close the file without waiting for the
        chunks in flight (after an error here or elsewhere in the run)."""
        if self.n_workers > 0:
            for p in self._procs:
                p.terminate()
            for p in self._procs:
                p.join(timeout=30)
            # a killed worker may hold a queue's lock: bounded waits only
            self._task_q.cancel_join_thread()
            self._result_q.put(None)
            self._writer.join(timeout=POLL_S)
        self._fh.close()
