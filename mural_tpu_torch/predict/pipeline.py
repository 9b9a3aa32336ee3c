"""Prediction on a BED file (counterpart of
``mural_tpu/predict/pipeline.py:80-241``; ref MuRaL/scripts/run_predict.py).

Rehydrates the architecture (SNVNet0-3 or the INDEL U-Net) from
``model.config.pkl``, encodes the BED (with the ``--bw_paths`` tracks'
means and, for a checkpoint trained with them, their per-base distal
channels), runs batched inference on the device (with ``n_devices >
1`` on a replica per device,
:mod:`mural_tpu_torch.parallel.sharded_predict`), applies the saved
calibrator and/or Poisson calibration (always for INDEL), writes the
reference's TSV schema ``chrom start end strand mut_type prob0..N``
sorted by (chrom, start) with ``%.4g`` floats (gzip when the path ends
in ``.gz``), and prints the k-mer (``--kmer_corr``) and regional
(``--region_corr``) correlations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mural_tpu_torch.calibrate.poisson import poisson_calibrate
from mural_tpu_torch.data.batcher import segment_pool_batches
from mural_tpu_torch.data.cache import prepare_dataset_cached
from mural_tpu_torch.data.dataset import prepare_dataset
from mural_tpu_torch.data.prefetch import prefetch
from mural_tpu_torch.device import resolve_device
from mural_tpu_torch.evaluation.evaluator import (_kmer_columns,
                                                  corr_calc_sub,
                                                  freq_kmer_comp_multi)
from mural_tpu_torch.genome.fasta import Genome
from mural_tpu_torch.genome.tracks import TrackSet
from mural_tpu_torch.models.registry import build_model_from_config
from mural_tpu_torch.parallel.mesh import make_devices
from mural_tpu_torch.parallel.sharded_predict import sharded_predict
from mural_tpu_torch.train.checkpoint import (load_calibrator,
                                              load_checkpoint, load_config)
from mural_tpu_torch.train.steps import masked_ce_sum, model_input
from mural_tpu_torch.utils.tsv import write_tsv


@dataclasses.dataclass
class PredictOptions:
    test_data: str
    ref_genome: str
    model_path: str
    model_config_path: str
    calibrator_path: str = ""
    pred_file: str = "pred.tsv.gz"
    poisson_calib: bool = False
    pred_batch_size: int = 16
    segment_center: Optional[int] = None
    bw_paths: Optional[str] = None
    kmer_corr: List[int] = dataclasses.field(default_factory=list)
    region_corr: List[int] = dataclasses.field(default_factory=list)
    pred_time_view: bool = False
    n_devices: int = 1
    fused_inference: bool = False      # BN-folded forward + CUDA stem
    # torch device; None -> the CUDA card (RuntimeError without one)
    device: Optional[object] = None
    with_h5: bool = False              # on-disk site-table cache
    h5f_path: Optional[str] = None
    n_h5_files: int = 1                # cache shard count


def run_predict(opts: PredictOptions, model_type: str = "snv",
                printer=print) -> Dict[str, np.ndarray]:
    """Predict every site of ``opts.test_data``; returns the output
    columns (sorted by chrom, start) and writes ``opts.pred_file``."""
    start_time = time.time()
    device = (torch.device(opts.device) if opts.device is not None
              else resolve_device())
    # --n_devices > 1: a replica per device (parallel/sharded_predict.py)
    devices = (make_devices(opts.n_devices, device) if opts.n_devices > 1
               else None)
    # the reference semantics are float32; cuDNN's TF32 default for
    # convolutions would keep only ~3 decimal digits
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    config = load_config(opts.model_config_path)
    n_class = config["n_class"]
    seq_only = config.get("seq_only", False)
    tracks = (TrackSet.from_list(opts.bw_paths, config["local_radius"])
              if opts.bw_paths else None)
    bw_distal = (tracks is not None
                 and not config.get("without_bw_distal", False)
                 and not seq_only)
    genome = Genome.from_fasta(opts.ref_genome)
    segment_center = opts.segment_center or config["segment_center"]
    if opts.with_h5:
        ds = prepare_dataset_cached(
            opts.test_data, genome, segment_center,
            config["local_radius"], config["local_order"],
            config["distal_radius"], model_type,
            cache_dir=opts.h5f_path, tracks=tracks, seq_only=seq_only,
            printer=printer, bw_distal=bw_distal,
            n_files=opts.n_h5_files)
    else:
        ds = prepare_dataset(
            opts.test_data, genome, central_bp=segment_center,
            local_radius=config["local_radius"],
            local_order=config["local_order"],
            distal_radius=config["distal_radius"],
            distal_order=config.get("distal_order", 1),
            model_type=model_type, tracks=tracks, seq_only=seq_only,
            bw_distal=bw_distal)
    printer("test set preprocess time:", time.time() - start_time)

    ckpt_n_cont = config.get("n_cont")
    if ckpt_n_cont is not None and ckpt_n_cont != ds.n_cont:
        raise ValueError(
            f"checkpoint was trained with n_cont={ckpt_n_cont} track "
            f"feature(s) but predict got {ds.n_cont} -- pass the same "
            "--bw_paths track list used for training")
    model = build_model_from_config(config, ds.n_cont, model_type)
    load_checkpoint(opts.model_path, model)
    model.to(device).eval()

    use_fused = (opts.fused_inference and model_type == "snv"
                 and config.get("model_no") == 2 and ds.n_cont == 0)
    if opts.fused_inference and not use_fused:
        printer("NOTE: --fused_inference only supports SNV model_no 2 "
                "without continuous features; using the standard path.")
    if use_fused and devices is None:
        from mural_tpu_torch.ops.fused_inference import (fold_snv2,
                                                         snv2_fused_forward)
        folded = fold_snv2(model)

        def forward(cat, codes, cont, tracks):
            return snv2_fused_forward(folded, cat, codes)
    else:
        def forward(cat, codes, cont, tracks):
            return model(cat, model_input(codes, False, tracks), cont)

    # the host seconds of the per-base track windows, part of the batch
    # build (--pred_time_view)
    track_s = [0.0]
    if ds.distal_tracks is not None:
        gather_tracks = ds.gather_distal_track_values

        def timed_gather_tracks(rows):
            t = time.time()
            out = gather_tracks(rows)
            track_s[0] += time.time() - t
            return out

        ds.gather_distal_track_values = timed_gather_tracks

    # the host batch build runs on the prefetch thread: its seconds
    build_s = [0.0]

    def timed_batches():
        batches = segment_pool_batches(ds, 1, opts.pred_batch_size,
                                       shuffle=False, pad_final=True)
        while True:
            t = time.time()
            batch = next(batches, None)
            build_s[0] += time.time() - t
            if batch is None:
                return
            yield batch

    test_size = ds.n_sites
    parts = []
    t_fetch = t_pred = fetch_all = pred_all = 0.0
    t_loop = time.time()
    if devices is not None:
        logits, total_loss = sharded_predict(
            model, ds, opts.pred_batch_size, devices=devices,
            fused_inference=use_fused, n_class=n_class)
    else:
        with torch.inference_mode():
            loss_dev = torch.zeros((), dtype=torch.float32, device=device)
            t0 = time.time()
            # t_fetch is the loop's wait for the prefetch thread's next batch
            for count, db in enumerate(prefetch(timed_batches(), device), 1):
                t1 = time.time()
                t_fetch += t1 - t0
                logits = forward(db.cat, db.distal, db.cont, db.distal_tracks)
                # no per-batch host sync: the loss accumulates on the device
                loss_dev += masked_ce_sum(logits, db.y, db.mask)
                parts.append(logits[:db.n_valid])
                t0 = time.time()
                t_pred += t0 - t1
                if opts.pred_time_view and count % 500 == 0:
                    printer(f"batch {count}: fetch {t_fetch:.1f}s "
                            f"predict {t_pred:.1f}s (last 500, async)")
                    fetch_all += t_fetch
                    pred_all += t_pred
                    t_fetch = t_pred = 0.0
            total_loss = float(loss_dev)
            logits = (torch.cat(parts).cpu().numpy() if parts
                      else np.zeros((0, n_class), np.float32))
    t_out = time.time()

    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    if opts.calibrator_path:
        printer("using calibrator for scaling ...")
        probs = load_calibrator(opts.calibrator_path).predict_proba(probs)
    if opts.poisson_calib or model_type == "indel":
        probs = poisson_calibrate(probs)

    printer("Mean Loss, Total Loss, Test Size:",
            total_loss / max(test_size, 1), total_loss, test_size)

    pos = ds.position_frame()
    # stable sort by (chrom name, start); rank[i] = sorted position of
    # the genome's i-th chromosome name
    rank = np.argsort(np.argsort(np.asarray(ds.chrom_names)))
    order = np.lexsort((pos["start"], rank[ds.chrom_id]))
    out = {name: col[order] for name, col in pos.items()}
    out["mut_type"] = ds.y[order]
    for i in range(n_class):
        out[f"prob{i}"] = probs[order, i]
    if opts.pred_file:
        write_tsv(opts.pred_file, out)
    t_corr = time.time()

    if opts.kmer_corr:
        # the dataset-order columns, as the JAX package (k-mer sums do not
        # depend on the row order)
        data_and_prob = ds.local_frame()
        for i in range(n_class):
            data_and_prob[f"prob{i}"] = probs[:, i]
        _kmer_corr(data_and_prob, opts.kmer_corr, n_class, printer)
    if opts.region_corr:
        if min(opts.region_corr) <= 0:
            printer("Warning: please provide positive numbers for window "
                    "sizes. No regional correlation was calculated.")
        else:
            prob_names = [f"prob{i}" for i in range(n_class)]
            for win in opts.region_corr:
                corr = corr_calc_sub(out, win, prob_names)
                printer("regional corr:", f"{win}bp", corr)

    if opts.pred_time_view:
        loop = (f" (host batch build on the prefetch thread "
                f"{build_s[0]:.3f}s"
                + (f", of which track windows {track_s[0]:.3f}s"
                   if ds.distal_tracks is not None else "")
                + f"; waiting for batches {fetch_all + t_fetch:.3f}s, "
                f"forward enqueue {pred_all + t_pred:.3f}s)"
                if devices is None else f" over {len(devices)} replicas")
        printer(f"time view: preprocess and model load "
                f"{t_loop - start_time:.3f}s, batch loop {t_out - t_loop:.3f}s"
                f"{loop}, calibration, sort and output {t_corr - t_out:.3f}s,"
                f" k-mer and regional correlation "
                f"{time.time() - t_corr:.3f}s")
    printer("Total time used: %s seconds" % (time.time() - start_time))
    return out


def _kmer_corr(data_and_prob, kmer_list, n_class: int, printer) -> None:
    if any(k % 2 == 0 or k < 0 for k in kmer_list):
        printer("Warning: please provide odd positive numbers for k-mer "
                "lengths", kmer_list, ". No k-mer correlation was "
                "calculated.")
        return
    for k in kmer_list:
        missing = [c for c in _kmer_columns(k) if c not in data_and_prob]
        if missing:
            # a k larger than the checkpoint's local window warns instead
            # of failing after the whole inference
            printer(f"Warning: skipping {k}-mer correlation (checkpoint "
                    f"local_radius too small; missing columns {missing})")
            continue
        corr = freq_kmer_comp_multi(data_and_prob, k, n_class)
        printer(f"{k}mer correlation: ", corr)
