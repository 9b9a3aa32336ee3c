"""Genome-wide mutation-rate maps without a BED (counterpart of
``mural_tpu/predict/genome_wide.py``).

- Sites are generated from the genome codes (:func:`iter_focal_sites`):
  every position whose base is the model's focal base on '+' and its
  complement on '-', or every position on '+' for ``focal_base='all'``
  (INDEL), chromosomes in FASTA or ``chroms`` order, positions
  ascending.
- Each chromosome chunk's codes go to the device once; per batch only a
  ``(B, 3)`` int32 array of window starts and strands follows, from
  pinned memory, and the windows are gathered and encoded there
  (:mod:`mural_tpu_torch.ops.device_gather`).
- The forward is the model's, or for SNVNet2 with ``fused_inference``
  the BN-folded forward whose stems run the CUDA kernel K1
  (:mod:`mural_tpu_torch.ops.fused_inference`).
- With ``n_devices > 1`` a replica of the model runs on each device
  (``parallel/mesh.py make_devices``): a batch is rounded up to ``per =
  ceil(B / n)`` rows per replica, each chunk's codes go to each replica's
  device once, and replica ``i`` takes rows ``[i*per, (i+1)*per)`` of each
  batch's starts, as the JAX package replicates the codes and shards the
  starts over its mesh.
- Logits drain to the host once per flush window: a copy on a side
  stream waits on an event recorded after the window's ``torch.cat``, so
  it waits for that window's batches only, and a drain thread waits on
  the copy's own event, then hands the rows to the
  :class:`~mural_tpu_torch.predict.post_farm.PostprocessFarm`
  (calibration, the native ``%.4g`` formatter, gzip; inline or in worker
  processes).
- Spans (:mod:`mural_tpu_torch.utils.spans`) time each stage: on the
  main thread ``genome.feed`` (the next batch, a chunk's upload, the
  starts' copy), ``genome.issue`` (encode and forward enqueue) and
  ``genome.flush`` (of it ``genome.drain_put_wait``), keyed by batch or
  flush window; on the drain thread ``genome.card_wait`` and
  ``genome.farm_submit`` (of it the farm's ``farm.queue_wait`` or
  ``farm.inline``); ``farm.start`` and ``farm.close`` around the farm's
  life; the farm's counters ``farm.worker_busy_s`` and
  ``farm.rows_written`` as each chunk is written.
- ``time_view`` (``predict_genome --pred_time_view``) turns the recorder
  on for the run and prints, after it, a row per stage of
  :data:`TIME_VIEW` that ran: the span's summed seconds (the drain
  thread's rows overlap the main thread's; a label with a colon is a
  part of the row above it), the workers' summed busy seconds, and the
  rows written in how many chunks.
"""

from __future__ import annotations

import copy
import dataclasses
import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from mural_tpu_torch.device import resolve_device, to_device
from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.fasta import COMPLEMENT, Genome, encode_sequence
from mural_tpu_torch.models.registry import build_model_from_config
from mural_tpu_torch.parallel.mesh import make_devices
from mural_tpu_torch.ops.device_gather import (iter_code_chunks,
                                               make_batch_code_encoder,
                                               make_batch_encoder)
from mural_tpu_torch.predict.post_farm import PostprocessFarm, auto_n_workers
from mural_tpu_torch.train.checkpoint import (load_calibrator,
                                              load_checkpoint, load_config)
from mural_tpu_torch.utils import spans


@dataclasses.dataclass
class GenomePredictOptions:
    ref_genome: str
    model_path: str
    model_config_path: str
    pred_file: str = "genome_pred.tsv.gz"
    calibrator_path: str = ""
    poisson_calib: bool = False
    focal_base: str = "A"            # the model's focal base, or 'all'
    chroms: Optional[Sequence[str]] = None
    batch_size: int = 4096
    flush_batches: Optional[int] = None  # batches per drain; None: about
                                         # 64k sites per flush
    chunk_size: int = 1 << 22        # codes uploaded per device chunk
    n_devices: int = 1
    # replicas' devices (may repeat, e.g. two on one card); overrides
    # n_devices
    devices: Optional[Sequence] = None
    n_workers: Optional[int] = None  # farm worker processes; None:
                                     # post_farm.auto_n_workers
    fused_inference: bool = False    # BN-folded forward with K1 (SNVNet2)
    progress_every: int = 2000       # batches between progress lines
    time_view: bool = False          # print the stages' span totals
    # torch device; None -> the CUDA card (RuntimeError without one)
    device: Optional[object] = None


def iter_focal_sites(genome: Genome, focal_base: str,
                     chroms: Optional[Sequence[str]] = None,
                     chunk: int = 4_000_000) -> Iterator[tuple]:
    """Yield (chrom, positions int64, strand_neg bool) for each ``chunk``
    bases of each chromosome, positions ascending: '+' sites where the
    base is ``focal_base``, '-' sites where it is its complement, so the
    model always reads its focal base.  ``focal_base='all'`` yields every
    position on '+' (INDEL models are not focal-base specific)."""
    if focal_base == "all":
        for chrom in (chroms or genome.names()):
            n = len(genome[chrom])
            for lo in range(0, n, chunk):
                pos = np.arange(lo, min(lo + chunk, n), dtype=np.int64)
                yield chrom, pos, np.zeros(len(pos), bool)
        return
    fwd_code = encode_sequence(focal_base)[0]
    rev_code = COMPLEMENT[fwd_code]
    for chrom in (chroms or genome.names()):
        codes = genome[chrom]
        for lo in range(0, len(codes), chunk):
            part = codes[lo:lo + chunk]
            pos_f = lo + np.nonzero(part == fwd_code)[0]
            pos_r = lo + np.nonzero(part == rev_code)[0]
            pos = np.concatenate([pos_f, pos_r])
            neg = np.concatenate([np.zeros(len(pos_f), bool),
                                  np.ones(len(pos_r), bool)])
            order = np.argsort(pos, kind="stable")
            yield chrom, pos[order], neg[order]


def _host_batches(genome: Genome, chroms, focal_base: str, margin: int,
                  chunk_len: int, batch_size: int, local_radius: int,
                  distal_radius: int, model_type: str):
    """Yield (padded_or_None, packed, n_valid, (chrom, pos, neg)): the
    padded chunk codes on the first batch of each chunk, and ``packed``
    (B, 3) int32 = [local start, distal start, strand] relative to the
    padded chunk.  A chunk's last batch is padded with its position
    ``lo`` and cut back to ``n_valid`` rows on the host."""
    for chrom in chroms:
        sites = iter_focal_sites(genome, focal_base, [chrom], chunk_len)
        for (lo, _, padded), (_, pos, neg) in zip(
                iter_code_chunks(genome, chrom, margin, chunk_len), sites):
            rel = margin - lo
            for b0 in range(0, len(pos), batch_size):
                p = pos[b0:b0 + batch_size]
                ng = neg[b0:b0 + batch_size]
                n_valid = len(p)
                if n_valid < batch_size:
                    pad = batch_size - n_valid
                    p = np.concatenate([p, np.full(pad, lo, np.int64)])
                    ng = np.concatenate([ng, np.zeros(pad, bool)])
                packed = np.empty((batch_size, 3), np.int32)
                packed[:, 0] = enc.expanded_start(p, local_radius,
                                                  model_type) + rel
                packed[:, 1] = enc.expanded_start(p, distal_radius,
                                                  model_type) + rel
                packed[:, 2] = ng
                yield (padded if b0 == 0 else None, packed, n_valid,
                       (chrom, p[:n_valid], ng[:n_valid]))


# the time view's rows: (label, span or counter name, unit); a span's
# summed nanoseconds print as seconds, a counter's summed value as it is
TIME_VIEW = (("load genome", "genome.load_genome", "ns"),
             ("load checkpoint", "genome.load_checkpoint", "ns"),
             ("farm start", "farm.start", "ns"),
             ("feed", "genome.feed", "ns"),
             ("issue", "genome.issue", "ns"),
             ("flush", "genome.flush", "ns"),
             ("flush: drain-queue wait", "genome.drain_put_wait", "ns"),
             ("card wait (drain thread)", "genome.card_wait", "ns"),
             ("farm submit (drain thread)", "genome.farm_submit", "ns"),
             ("farm submit: queue wait", "farm.queue_wait", "ns"),
             ("farm submit: inline postprocess", "farm.inline", "ns"),
             ("farm workers busy (summed)", "farm.worker_busy_s", "s"),
             ("farm close", "farm.close", "ns"),
             ("rows written", "farm.rows_written", "rows"))


def _time_view_row(label: str, unit: str, count: int, value: float) -> str:
    if unit == "rows":
        return f"  {label:<32s} {value:,.0f} in {count} chunks"
    seconds = value / 1e9 if unit == "ns" else value
    return f"  {label:<32s} {seconds:8.2f}s"


def run_genome_predict(opts: GenomePredictOptions, model_type: str = "snv",
                       printer=print) -> int:
    """Predict every focal site of the genome into ``opts.pred_file``;
    returns the number of sites written.  With ``opts.time_view`` the
    span recorder is on for the run and its totals are printed
    (:data:`TIME_VIEW`)."""
    t0 = time.time()
    if opts.time_view:
        with spans.recording() as session:
            total, n_workers = _map_genome(opts, model_type, printer, t0)
        totals = spans.totals(session)
        printer("predict_genome phase timing:")
        for label, name, unit in TIME_VIEW:
            if name in totals:
                printer(_time_view_row(label, unit, *totals[name]))
    else:
        total, n_workers = _map_genome(opts, model_type, printer, t0)
    rate = total / max(time.time() - t0, 1e-9)
    printer(f"genome-wide predict: {total:,} sites in "
            f"{time.time() - t0:.1f}s = {rate:,.0f} sites/s "
            f"({n_workers} postprocess workers"
            f"{' [auto]' if opts.n_workers is None else ''})")
    return total


def _map_genome(opts: GenomePredictOptions, model_type: str, printer,
                t0: float):
    """:func:`run_genome_predict`'s work: (sites written, farm workers)."""
    device = (torch.device(opts.device) if opts.device is not None
              else resolve_device())
    # --n_devices > 1: a replica per device; each chunk's codes go to
    # each replica's device once and each batch's starts are split
    devices = ([torch.device(d) for d in opts.devices] if opts.devices
               else make_devices(opts.n_devices, device)
               if opts.n_devices > 1 else [device])
    # the reference semantics are float32 (as predict)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with spans.span("genome.load_genome"):
        config = load_config(opts.model_config_path)
        n_class = config["n_class"]
        if config.get("n_cont", 0):
            raise ValueError(
                "this checkpoint was trained with bigWig track features "
                f"(n_cont={config['n_cont']}); genome-wide prediction "
                "does not generate continuous features -- use `predict` "
                "with a BED and --bw_paths instead")
        genome = Genome.from_fasta(opts.ref_genome)

    with spans.span("genome.load_checkpoint"):
        model = build_model_from_config(config, 0, model_type)
        load_checkpoint(opts.model_path, model)
        model.to(device).eval()
    local_radius = config["local_radius"]
    local_order = config["local_order"]
    distal_radius = config["distal_radius"]
    calibr = (load_calibrator(opts.calibrator_path)
              if opts.calibrator_path else None)

    use_fused = (opts.fused_inference and model_type == "snv"
                 and config.get("model_no") == 2)
    if opts.fused_inference and not use_fused:
        printer("NOTE: --fused_inference only supports SNV model_no 2 "
                "without continuous features; using the standard path.")
    if use_fused:
        from mural_tpu_torch.ops.fused_inference import (fold_snv2,
                                                         snv2_fused_forward)
        encode_fn, _, _ = make_batch_code_encoder(
            local_radius, local_order, distal_radius, model_type)

        def make_forward(m):
            folded = fold_snv2(m)
            return lambda cat, distal: snv2_fused_forward(folded, cat,
                                                          distal)
    else:
        encode_fn, _, _ = make_batch_encoder(local_radius, local_order,
                                             distal_radius, model_type)

        def make_forward(m):
            return lambda cat, distal: m(cat, distal, None)

    forwards = ([make_forward(model)] if len(devices) == 1 else
                [make_forward(copy.deepcopy(model).to(d).eval())
                 for d in devices])

    def genome_step(i, chunk, packed):
        cat, distal = encode_fn(chunk, packed[:, 0].long(),
                                packed[:, 1].long(), packed[:, 2].bool())
        return forwards[i](cat, distal)

    n_rep = len(devices)
    per = -(-opts.batch_size // n_rep)      # rows per replica
    batch_size = per * n_rep
    margin = max(distal_radius, local_radius + local_order) + 2
    n_workers = (auto_n_workers() if opts.n_workers is None
                 else opts.n_workers)
    with spans.span("farm.start", workers=n_workers):
        farm = PostprocessFarm(
            opts.pred_file,
            ["chrom", "start", "end", "strand", "mut_type"]
            + [f"prob{i}" for i in range(n_class)],
            calibrator=calibr,
            poisson=(opts.poisson_calib or model_type == "indel"),
            n_workers=n_workers)
    flush_batches = (opts.flush_batches if opts.flush_batches
                     else max(4, 65536 // batch_size))
    side = ({d: torch.cuda.Stream(d) for d in set(devices)}
            if device.type == "cuda" else None)

    # flush windows drain on a separate thread: the wait for the logits'
    # copy and the farm's submit overlap the main loop's dispatching
    drain_q: "queue.Queue" = queue.Queue(maxsize=2)
    drain_err: List[BaseException] = []
    submitted = 0

    def drain_worker():
        nonlocal submitted
        while True:
            item = drain_q.get()
            if item is None:
                return
            window, hosts, copied, valids, meta_rows = item
            try:
                with spans.span("genome.card_wait", key=window):
                    for event in copied:
                        event.synchronize()
                with spans.span("genome.farm_submit", key=window):
                    submitted += submit_window(hosts, valids, meta_rows)
            except BaseException as e:
                drain_err.append(e)
                return

    def submit_window(hosts, valids, meta_rows) -> int:
        """A flush window's rows to the farm: one chunk per run of
        same-chromosome batches.  Returns the rows submitted."""
        if n_rep == 1:
            flat = hosts[0].numpy()
        else:    # replica i holds rows [i*per, (i+1)*per) of each batch
            flat = np.stack([h.numpy().reshape(-1, per, n_class)
                             for h in hosts], axis=1).reshape(-1, n_class)
        logits_np = [flat[i * batch_size:i * batch_size + n]
                     for i, n in enumerate(valids)]
        i, k, rows = 0, len(valids), 0
        while i < k:
            chrom = meta_rows[i][0]
            j = i
            while j < k and meta_rows[j][0] == chrom:
                j += 1
            pos = np.concatenate([m[1] for m in meta_rows[i:j]])
            neg = np.concatenate([m[2] for m in meta_rows[i:j]])
            farm.submit(chrom, pos, neg, np.concatenate(logits_np[i:j]))
            rows += len(pos)
            i = j
        return rows

    def to_drain(item):
        """Hand ``item`` to the drain thread, raising its error if it has
        stopped (a put on its full queue would wait forever)."""
        while True:
            if drain_err:
                raise drain_err[0]
            try:
                drain_q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    pending: List[List[torch.Tensor]] = [[] for _ in devices]
    pending_valid: List[int] = []
    meta: List = []
    windows = 0

    def drain_copy(flat, d):
        """``flat``'s copy to pinned host memory on ``d``'s side stream,
        after the work enqueued so far: (host tensor, its event)."""
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(d))
        side[d].wait_event(ready)
        with torch.cuda.stream(side[d]):
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side[d])
        flat.record_stream(side[d])
        return host, copied

    def flush():
        nonlocal windows
        if not pending_valid:
            return
        with spans.span("genome.flush", key=windows):
            hosts, copied = [], []
            for i, d in enumerate(devices):
                flat = torch.cat(pending[i])
                if side is not None:
                    host, event = drain_copy(flat, d)
                    copied.append(event)
                else:
                    host = flat
                hosts.append(host)
                pending[i].clear()
            with spans.span("genome.drain_put_wait", key=windows):
                to_drain((windows, hosts, copied, list(pending_valid),
                          list(meta)))
        pending_valid.clear()
        meta.clear()
        windows += 1

    drain_thread = threading.Thread(target=drain_worker, daemon=True,
                                    name="mural-genome-drain")
    drain_thread.start()
    batch_count = 0
    chroms = opts.chroms or genome.names()
    batches = _host_batches(genome, chroms, opts.focal_base, margin,
                            opts.chunk_size, batch_size, local_radius,
                            distal_radius, model_type)
    try:
        with torch.inference_mode():
            while True:
                try:
                    # a span left by the iterator's end is not kept
                    with spans.span("genome.feed", key=batch_count):
                        padded, packed, n_valid, mrow = next(batches)
                        if padded is not None:
                            chunks = {d: to_device(padded, d)
                                      for d in set(devices)}
                        starts = [to_device(packed[i * per:(i + 1) * per],
                                            d)
                                  for i, d in enumerate(devices)]
                except StopIteration:
                    break
                with spans.span("genome.issue", key=batch_count):
                    for i, d in enumerate(devices):
                        pending[i].append(genome_step(i, chunks[d],
                                                      starts[i]))
                pending_valid.append(n_valid)
                meta.append(mrow)
                batch_count += 1
                if len(pending_valid) >= flush_batches:
                    flush()
                if batch_count % opts.progress_every == 0:
                    printer(f"{batch_count} batches, {submitted:,} sites "
                            f"submitted, "
                            f"{submitted / max(time.time() - t0, 1e-9):,.0f}"
                            f" sites/s")
            flush()
        to_drain(None)
        drain_thread.join()
        if drain_err:
            raise drain_err[0]
    except BaseException:
        farm.abort()
        raise
    with spans.span("farm.close"):
        return farm.close(), n_workers
