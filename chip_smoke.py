#!/usr/bin/env python3
"""Smoke run of mural_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n_sites 200000] [--n_train 60000]
    python3 chip_smoke.py --only_kernels

Phases (any failure raises and the script exits non-zero):

1. setup: print the card's name and power limit, build the CUDA kernels
   (``mural_tpu_torch/ops/csrc/*.cu``: K1 ``code_conv1d``, K2/K3
   ``code_conv_pool``, K4 ``window_one_hot``, K5 ``batch_norm``) with
   one nvcc each, all
   started together, write a
   synthetic FASTA and two SNV and two INDEL BEDs from ``--seed``, and
   write two checkpoint triples with the port itself: SNVNet2 and the
   ``--use_reverse`` INDEL U-Net at the CLI default widths with seeded
   weights, randomised BN statistics and a seeded FullDirichlet
   calibrator;
2. K1 against its plain PyTorch version on the card, bit-exact (max
   |diff| == 0): the predict path's shapes (B=4096 at L=401 and the
   strided L=201 crop), the same at B=256 and a ragged 37, rows of
   length 2001, and seeded random tables with C=30 (scalar channels),
   k=5 and C=8 with k=7 (an INDEL-like stem) at B 4096 and 37; timings
   per predict batch (both towers' calls) at B=4096 and B=256 of the
   kernel, the plain version and one library call computing the same
   function (``F.conv1d`` on a prepared one-hot; a yardstick the port
   never calls) beside the kernel's bound;
3. K2 (fused stem forward) and K3 (its backward) against their plain
   versions at both towers' shapes, B in {128, 2048} and a ragged 37,
   also with a random C=30 table (scalar channels, unaligned tile
   edges) and a k=5 table at B 2048 and 37, and on rows of length 2001
   with tower 2's pool: pooled within 1e-6 with identical ``jstar``, dtable within 1e-5
   of its largest entry, two K3 runs bit-identical; timings of kernel,
   plain version and the library composition (``F.conv1d`` +
   ``F.max_pool1d`` on a prepared one-hot, and its autograd backward)
   beside the bounds;
4. the BN-folded fused forward (through K1) against the unfused SNVNet2
   on one batch of 4096 (<= 1e-4), and the card's unfused forward
   against the CPU's on a small batch (<= 1e-4); the top 8 device ops
   of one fused forward at B=4096 from torch.profiler (name, ms, calls)
   and the op that follows each K1 launch;
5. train steps at the CLI default widths, dropout 0: five Adam steps of
   128 with the fused stem (K2/K3) against the unfused model (per-step
   loss within 1e-4), two unfused steps of 16 on the card against the
   CPU (1e-4), and the step time with the device's busy share;
6. ``mural_snv predict --fused_inference --pred_batch_size 4096
   --kmer_corr 3 5 7 --region_corr 100000 500000`` through the CLI on the
   synthetic triple: TSV schema, row count, probabilities summing to 1,
   K1 launched twice per batch, the three k-mer and two regional
   correlation lines (the 3-mer values finite) and the host seconds the
   correlations take; then the same without ``--fused_inference`` and
   without the correlations, whose rows must agree within ``%.4g``;
7. ``mural_snv train --fused_stem on --epochs 2`` through the CLI on the
   ``--n_train`` sites, which takes the default path: device-resident
   data, 8 train steps per CUDA graph replay (the log line says so):
   both checkpoint triples, finite metrics (the
   regional ``score`` included) in both ``epoch_<n>_metrics.txt`` and in
   ``progress.csv``, K2 launched twice per train step and validation
   batch and K3 twice per train step, K5 80 times per train step (its
   20 BatchNorms of 3-D activations; a replay counts the launches its
   graph recorded); then ``get_best_model`` and
   ``predict --fused_inference`` on the best triple; then one epoch with
   ``--fused_stem off --save_valid_preds --poisson_calib --resident_data
   off --steps_per_dispatch 1`` (host-fed, one eager step per batch), whose
   ``checkpoint_0/model.valid_preds.tsv.gz`` has the predict schema,
   whose log has the Poisson-calibrated evaluation lines, and which
   launches K5 88 times per train step (22 BatchNorms without the fused
   stem);
8. ``mural_snv evaluate`` (k-mer and regional; then ``--kmer_only
   --kmer_length 5``) on phase 6's fused TSV and the synthetic FASTA:
   six files with their headers, each ``corr.txt`` with 3 finite rows;
   ``calc_scaling_factor --genomewide_mu 1e-8 --do_scaling`` and ``scale``
   with the same factor: the two scaled files equal line for line,
   probabilities summing to 1 within ``%.4g``; the seconds of each;
9. the INDEL path, which runs K4 and K5 and none of K1-K3: the U-Net at
   the ``mural_indel train`` defaults (8000-bp windows, down_list
   1,4,5,5,5,2, 8 channels, k 7) on the card against the CPU for both
   ``use_reverse`` variants (B=4, <= 1e-4), its forward's device ms at
   B=256 and 1024 and top 8 device ops; the host's batch build of B=128
   windows, two train steps of 16 on the card against the CPU (<= 1e-4,
   dropout 0), one B=128 step's host ms, the host's time to issue it,
   its device-busy share and top ops; then ``mural_indel train
   --use_reverse --epochs 1`` on ``INDEL_TRAIN`` sites (triple, finite
   metrics, ``progress.csv``), ``get_best_model``, ``predict
   --pred_batch_size 1024`` of ``INDEL_SITES`` sites (``prob0..prob7``
   summing to 1, sites/s)
   and ``evaluate --kmer_length 4`` on its TSV; K1, K2 and K3 launched
   0 times in the phase, K4 in each of its three parts, K5 144 times a
   U-Net step in the train step and the CLI's parts and not in the eval
   forward (counts kept);
10. the rest of the SNV family and the track features, at the CLI
    default widths: two seeded bedGraph tracks (integer coverage in
    100-bp steps with radius 50, gzipped fractional scores in 1,000-bp
    steps with the default radius) loaded as ``--bw_paths`` does (load
    seconds printed), their means and per-base windows at 500 sites
    against brute-force float64 sums (the integer track within 1e-9
    relative and exactly, the fractional one within the float32 in-block
    bound); card against CPU forwards (B=4, <= 1e-4) of SNVNet0, SNVNet1,
    SNVNet2 with 2 continuous features and SNVNet3 with 2 at 6 and at 4
    input channels; five Adam steps of 128 with the fused stem (K2/K3)
    against unfused (<= 1e-4) on SNVNet1 and on SNVNet3 with continuous
    features; four one-epoch ``mural_snv train`` runs on 20,000 sites
    (``--model_no 3 --bw_paths``; the same with ``--without_bw_distal
    --fused_stem on``; ``--model_no 1 --fused_stem on``; ``--model_no
    0``): triple, ``n_cont``, finite metrics, K2 twice per train step
    and validation batch and K3 twice per train step in the fused runs,
    none in the others; ``get_best_model`` and ``predict --bw_paths
    --pred_time_view`` of the track-channel SNVNet3 on the predict BED
    (schema, sums, sites/s, the track windows' host seconds, K1 0
    times); ``--fused_inference`` on it prints the NOTE and launches K1 0
    times; without ``--bw_paths`` it raises the ``n_cont`` ValueError;
11. transfer, convert and the trial search, at the CLI default widths:
    ``mural_snv transfer --fused_stem on --epochs 1`` from phase 7's best
    triple on phase 10's 20,000 sites (triple, finite metrics, ``n_class``
    and ``model_no`` from the pretrained config, K2 twice per train step
    and validation batch and K3 twice per train step; train windows/s),
    then ``predict --fused_inference`` of the transferred triple on the
    predict BED (K1 twice per batch); ``mural_indel transfer
    --init_fc_with_pretrained --epochs 1`` from phase 9's best triple on
    its 20,000 sites (K1-K3 0 times); ``mural_snv convert`` of a
    reference-layout triple written from phase 7's weights (duplicate
    ResBlock keys, BN counters, a zero-size ``first_bn_layer``), whose
    forward at B=4096 on the card equals the source's bit for bit; then
    ``train`` on a third of phase 10's sites (6,667): ``--use_ray
    --n_trials 4 --epochs 3 --grace_period 1 --learning_rate 1e-4 1e-2
    --fused_stem on`` in threads, its configs and trial ids drawn from
    ``--seed`` (four trials, each stopped where a replay of its losses
    through the scheduler says, at least one at a rung, the progress
    table, ``best_models.txt``, K2/K3 twice per step and batch of every
    epoch each trial trained, at most one past its last checkpoint (a
    stop its overlapped tail reports may come after the next epoch
    started); wall seconds and each trial's epochs); ``--n_parallel 2
    --n_trials 2 --epochs 1`` (one trial at a time on the one card);
    ``--rerun_failed`` after an ``error.txt`` planted in one of them
    (only that trial runs again); ``--trial_executor process --n_trials
    2 --epochs 1 --fused_stem on`` (both children train on the card with
    the fused stem, no ``error.txt``; each child's start-up seconds);
12. genome-wide predict, at the CLI defaults: ``mural_snv predict_genome
    --chroms chr2 --focal_base A --pred_time_view`` on the 1 Mb
    chromosome with phase 1's SNVNet2 triple, ``--fused_inference
    --n_workers 0``, ``--fused_inference --n_workers 2`` and unfused with
    the automatic worker count (rows = the A and T codes of chr2, the
    schema, ``mut_type`` 0, each row's strand matching its base, sums
    within 5e-3, the inline and worker outputs byte-equal after
    decompression, fused against unfused within ``%.4g``, K1 twice per
    batch fused and 0 times unfused, K4 once per batch unfused and 0
    times fused; sites/s and the phase table of
    each); ``predict --fused_inference`` of a BED of 20,000 of its sites
    (both chromosome ends and random) equal to their genome-wide rows
    within ``%.4g`` (the card's gather against the host's); ``mural_indel
    predict_genome --pred_batch_size 1024`` with phase 1's INDEL triple
    on a seeded 200,000-base chromosome of its own (200,000 rows of
    ``prob0..7`` summing to 1, K1-K3 0 times, K4 once per batch, sites/s)
    and ``predict`` of
    a BED of 5,000 of its sites within ``%.4g``;
13. the device-fed train loop: SNVNet2 at the CLI default widths (B=128,
    dropout 0, Adam, ``--lr_scheduler StepLR2``) on phase 10's 20,000
    training sites, fed six ways: batches built between eager steps of
    torch's Adam (the loop before this slice), host-fed through the
    prefetch thread, host-fed with 8 steps per CUDA graph replay,
    resident with one eager step per batch, resident with 8 steps per
    replay fused and unfused (the graph runs two epochs, the others
    one); each run's windows/s per epoch, step ms and the device's busy
    ms per step (torch.profiler over 16 more steps); with deterministic
    cuDNN, one epoch of resident + 8-step graphs against the host-fed
    eager steps (per-step loss within 1e-4, final parameters within 1e-4
    as relative L2 over all parameters) and 3 eager steps of
    GraphOptimizer against torch's Adam (1e-4), and, recorded without a
    check, 32 steps of each of the first two with the CLI's dropout
    (whether replays draw eager's masks); K2 and K3 launched twice
    per step in every fused run (replays included) and never unfused;
    the INDEL U-Net at its defaults, one resident epoch and one host-fed
    (windows/s, busy share), and 16 steps of each with deterministic
    cuDNN within 1e-4; ``train --profile_dir`` on 2,000 sites writes a
    trace holding device events, K2 among them;
15. mixed precision and trial ensembles: K2 and K3 in their bf16 mode
    (the JAX kernels' ``split=False``; run beside phase 3, on the same
    shapes and tables) against their plain bf16 versions, ``jstar`` and
    ``pooled`` equal and dtable within phase 3's K3 tolerance, timed at
    B=128 and 2048 beside the plain version, the bound (2-byte ``pooled``
    and ``g``) and the library composition under a bf16 autocast; SNVNet2
    at the CLI widths (B=128, dropout 0) on phase 10's 20,000 sites,
    resident with 8-step graphs, float32 against ``--bf16``, fused and
    unfused (windows/s, busy share, K2/K3 launches of each mode: the bf16
    mode twice per step, replays included, in the bf16 fused run, the
    float32 mode never), 64 fused steps of bf16 against float32
    (deterministic cuDNN) within 2e-2 per step over the first 8 and in
    the mean of each window of 8, the INDEL U-Net at its defaults
    one resident epoch in each precision; ``mural_snv train --bf16
    --fused_stem on --epochs 1`` (the bf16 mode twice per train step, the
    float32 mode twice per validation batch) and ``mural_indel train
    --bf16 --epochs 1`` (no launch) through the CLI: triple, finite
    metrics; one ``--bf16`` epoch on 2,000 sites on each other train path
    (host-fed eager and graphs, resident eager, SNVNet0, SNVNet1 fused,
    SNVNet3 with track channels, a trial process, ``transfer`` from phase
    1's triple); ``train --trial_ensemble auto --n_trials 4 --epochs 2`` on
    the same sites in float32 and with ``--bf16`` (one group of 4, every
    trial's files and finite metrics, no K2/K3 launch, the aggregate
    windows/s against phase 13's serial unfused resident rate), and with
    ``--use_ray --grace_period 1 --learning_rate 1e-4 1e-2`` (a member
    stopped before the last epoch whose final weights are its last
    checkpoint's);
16. replicas, data-parallel ranks and the overlapped epoch tail on the
    one card: ``train --dp_devices 2``, ``predict --n_devices 2`` and
    ``predict_genome --n_devices 2`` refused with "requested 2 devices,
    have 1"; ``sharded_predict`` with two replicas on the card against
    one on phase 6's sites, fused and unfused (logits and loss within
    1e-5, K1 twice per shard batch fused, sites/s of each), and
    ``predict_genome --fused_inference`` of the 1 Mb chromosome with two
    replicas against one (the same rows, probabilities within ``%.4g``);
    two spawned gloo ranks on the card against one process, resident
    with the fused stem and one eager step per batch, deterministic
    cuDNN, on phase 10's 20,000 sites, at learning rate 1e-4: 32 SNVNet2
    steps at the CLI widths (B=128, dropout 0; per-step loss within 1e-4
    over the first 8, the 32-step mean within 5e-3, K2/K3 twice per step
    on each rank) and 8 U-Net steps at its defaults (within 1e-4); the
    same SNVNet2 steps at the CLI's 1e-3, whose drift is recorded; one
    spawned NCCL rank with
    8-step CUDA graphs, whose captured gradient all-reduce replays,
    against the same graphs without a group (per-step loss within 1e-4,
    windows/s and busy share of both); ``train --epochs 3 --fused_stem
    on`` through the CLI (three triples, metrics files and
    ``progress.csv`` rows; each epoch's seconds split into train, valid
    and the snapshot fetch beside its tail's seconds on its thread);
17. the site-table cache (``--with_h5``, read and written without h5py)
    and the last modules: one spawned shard writer's start-up seconds
    (it must start without torch); ``mural_snv predict --fused_inference
    --with_h5`` on phase 6's sites, cold (writes the cache) and warm
    ("using cached site encodings:"), then cold with ``--n_h5_files 4``
    into a fresh directory (4 shards and a master), each TSV equal to
    phase 6's fused TSV once decompressed and K1 twice per batch in each;
    ``mural_snv train --fused_stem on --with_h5 --epochs 1`` on phase
    10's 20,000 sites, cold then warm, with deterministic cuDNN (the
    warm run reads the cache, the epoch-0 train losses within 1e-4
    relative, K2/K3 twice per step); ``mural_indel predict --with_h5`` on
    phase 9's 50,000 sites, cold then warm (equal TSVs, no K1-K3 launch);
    each run's preprocess seconds, and each cache's load and write
    seconds; the losses of ``train/losses.py`` on the card against the
    CPU at B=4096 with 4 and 8 classes (values within 1e-5 relative,
    gradients within 1e-5 of the largest entry); the four calibrators of
    ``calibrate/extra.py`` fitted on the host to 50,000 of phase 6's
    probabilities (finite, summing to 1, their pickles loading back);
18. (run after phase 3) K4, the windows' strand-resolved one-hot,
    against its plain version bit for bit: B=4096 windows of W=8000 (the
    INDEL map's batch), 128 x 8000 (INDEL training) and 4096 x 2001 (the
    unfused SNV map) from a 4-Mb chunk of every code 0-15, float32 and
    bf16, mixed strands and none given, and ``one_hot_from_codes`` on
    (128, 8000) codes and a strided view of them; at each shape the
    device ms of the kernel in both dtypes beside its byte bound, of the
    plain version, and of ``F.embedding(codes.long(), table)`` on the
    windows (a yardstick the port never calls); the device ops of one
    INDEL map batch's encode (B=4096);
19. (run after phase 18) K5, the train-mode BatchNorm of (N, C, L)
    activations, against a float64 reference at every BatchNorm plane
    of one U-Net train step (B=128, W=8000) and of the SNV towers
    (B=128, L=2001), float32 and bf16; at each plane the device ms of
    forward + backward of K5, of cuDNN's BatchNorm (a yardstick the port
    no longer calls in train mode) and of the plain composition beside
    K5's byte bound, and their sums over a step; one eager U-Net train
    step (AdamW, B=128) with K5 and with cuDNN's BatchNorm: device ms,
    the host's untraced issue ms and the wall ms of a step, and K5's
    launches a step (144);
14. last, after phase 17: a JSON line of the kernels (with
    ``launches_phase11``, ``launches_phase12``, ``launches_phase13``,
    ``launches_phase16``, ``launches_phase17``, the bf16 mode's records
    with ``launches_phase15``, K4's with ``launches_phase9`` and
    ``launches_phase12``, K5's with ``launches_phase9`` and
    ``launches_phase7``) and a timing
    line.

The last line of standard output is the device record
``{"ok": true, "device": {...}}``.  ``--only_kernels`` runs the setup
(without the synthetic genome), phases 2-3, phase 15's kernel checks and
phases 18-19, prints the kernels' JSON line and exits 0 without the device
record: a quick check of the kernels while they change.  Without a CUDA
device, or without the rest of the repository beside it, the script
exits non-zero and prints no result.  Scratch files go to ``build/chip_smoke/`` beside this script
and are removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gzip
import io
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TOL_LIBRARY = 1e-5      # F.conv1d yardsticks vs the kernels: cuDNN's order
TOL_K2 = 1e-6           # K2 vs plain: the same f32 sums in the same order
TOL_K3_REL = 1e-5       # K3 vs plain (index_add_ on the card: atomics)
TOL_MODEL = 1e-4        # folded vs unfused forward: f32 reassociation
TOL_STEP = 1e-4         # per-step loss, fused vs unfused and card vs CPU
BATCH = 4096
TRAIN_BATCH = 128
# the reference CLI's SNVNet2 defaults (mural_snv train)
CONFIG = dict(
    model_no=2, n_class=4, local_radius=7, local_order=3,
    local_hidden1_size=150, local_hidden2_size=75, emb_dropout=0.1,
    local_dropout=0.1, distal_fc_dropout=0.25, distal_radius=200,
    CNN_kernel_size=3, CNN_out_channels=32, segment_center=300000,
    distal_order=1, n_cont=0, emb_dims=[(65, 2)] * 13)
# the mural_indel train defaults: the reference recipe of the shipped
# INDEL model (8000-bp windows, down_list 1,4,5,5,5,2, 8 channels, k 7,
# use_reverse); local_radius 6 and local_order 1 feed the evaluation only
INDEL_CONFIG = dict(
    model_no=0, n_class=8, local_radius=6, local_order=1,
    distal_radius=4000, CNN_kernel_size=7, CNN_out_channels=8,
    down_list=[1, 4, 5, 5, 5, 2], use_reverse=True, segment_center=300000,
    distal_order=1, n_cont=0, emb_dims=[(4, 1)] * 12)
INDEL_PRED_BATCH = 1024
INDEL_SITES = 50_000    # sites to predict
INDEL_TRAIN = 20_000    # sites to train on
INDEL_TSV_HEADER = ["chrom", "start", "end", "strand", "mut_type"] + [
    f"prob{i}" for i in range(8)]
CHROMS = {"chr1": 3_000_000, "chr2": 1_000_000}
# K5's launches a train step (4 a BatchNorm of a 3-D activation): the
# SNVNet2 towers' 20 BatchNorms after the fused stem, 22 without it; the
# U-Net's 36 (use_reverse: the stem's BatchNorm runs twice)
K5_SNV_FUSED, K5_SNV_UNFUSED, K5_UNET = 80, 88, 144
# (name, pool kernel, pool padding) of each tower's stem, tower 2 first
STEMS = (("tower 2 (Bx401)", 15, 7), ("tower 1 (Bx201 crop)", 3, 1))
# what device_ms timed with CUDA events, the profiler having seen nothing
TIMED_WITH_EVENTS = []


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3, what="") -> float:
    """Mean device busy time of ``fn`` (its kernels and copies, summed
    from a torch.profiler trace) over ``iters`` calls: the kernel's own
    time, which ``cuda_ms`` hides behind the host's enqueue time when a
    call is shorter than its Python wrapper. Where every capture of
    ``device_events`` came back without device events, the time is taken
    with CUDA events instead and ``what`` is noted in
    ``TIMED_WITH_EVENTS``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    busy = device_busy_ms(calls)
    if busy > 0:
        return busy / iters
    log(f"torch.profiler recorded no device time for {what or fn}; "
        "timed with CUDA events instead")
    TIMED_WITH_EVENTS.append(what or repr(fn))
    return cuda_ms(fn, iters, warmup)


def build_kernels():
    """Build every kernel library of the port, one nvcc per source, and
    the native host library (g++), all started together; returns
    (seconds, {kernel library: nvcc output})."""
    from mural_tpu_torch import native
    from mural_tpu_torch.ops import fused_code_conv as fcc
    from mural_tpu_torch.ops import fused_train_stem as fts
    from mural_tpu_torch.ops import batch_norm as bn
    from mural_tpu_torch.ops import window_one_hot as wo
    libs = (fcc.LIBRARY, fts.LIBRARY, wo.LIBRARY, bn.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + 1) as ex:
        builds = [ex.submit(lib.load) for lib in libs]
        builds.append(ex.submit(native.load))
        for build in builds:
            build.result()
    return time.perf_counter() - t0, {lib.name: lib.build_log.strip()
                                      for lib in libs}


def write_inputs(work: Path, rng: np.random.Generator, n_sites: int,
                 n_train: int):
    """Synthetic genome (two chromosomes, ~4 Mb) and two sorted BEDs of
    SNV sites (A under '+' rows, T under '-' rows, uniform labels): one
    to predict and one to train on."""
    from mural_tpu_torch.genome.fasta import decode_sequence
    fasta = work / "seq.fa"
    chroms = CHROMS
    beds = {work / "sites.bed": n_sites, work / "train.bed": n_train}
    lines = {bed: [] for bed in beds}
    with open(fasta, "w") as fh:
        for chrom, n in chroms.items():
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            codes[rng.integers(0, n, size=n // 1000)] = 14      # N
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")
            for bed, total in beds.items():
                k = total * 3 // 4 if chrom == "chr1" else total - total \
                    * 3 // 4
                plus = rng.choice(np.flatnonzero(codes == 0), k // 2,
                                  replace=False)
                minus = rng.choice(np.flatnonzero(codes == 3), k - k // 2,
                                   replace=False)
                pos = np.concatenate([plus, minus])
                strand = np.array(["+"] * len(plus) + ["-"] * len(minus))
                order = np.argsort(pos, kind="stable")
                labels = rng.integers(0, 4, size=len(pos))
                lines[bed] += [f"{chrom}\t{p}\t{p + 1}\t.\t{y}\t{s}"
                               for p, s, y in zip(pos[order], strand[order],
                                                  labels[order])]
    for bed, rows in lines.items():
        bed.write_text("\n".join(rows) + "\n")
    return str(fasta), str(work / "sites.bed"), str(work / "train.bed")


def write_checkpoint(work: Path, seed: int):
    """SNVNet2 triple at the CLI default widths, made by the port."""
    import torch
    from mural_tpu_torch.calibrate.dirichlet import FullDirichletCalibrator
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.registry import build_model_from_config
    from mural_tpu_torch.train.checkpoint import save_checkpoint
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(build_model_from_config(CONFIG, 0, "snv"), gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    noise = np.random.default_rng(seed).normal(size=(4, 5))
    w = np.hstack([np.eye(4), np.zeros((4, 1))]) + 0.1 * noise
    path = str(work / "checkpoint_0" / "model")
    save_checkpoint(path, model, CONFIG,
                    calibrator=FullDirichletCalibrator.from_weights(w))
    return path, model


def bound(n_bytes: float, n_ops: float):
    """Least time (ms) for moving ``n_bytes`` and doing ``n_ops`` float32
    operations on the card, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(shapes, k, C):
    """K1 on ``shapes`` [(B, L), ...]: codes in, table and bias in, f32
    output out; k adds per output."""
    n_bytes = sum(B * L + B * L * C * 4 for B, L in shapes) \
        + len(shapes) * (k * 16 * C + C) * 4
    return bound(n_bytes, sum(B * L * C * k for B, L in shapes))


def stem_calls(B, k, C):
    """[(B, L, pk, pp, P, conv positions inside a pool window)] of one
    train step's two stem calls."""
    from mural_tpu_torch.ops.fused_train_stem import pool_out_len
    out = []
    for (_, pk, pp), L in zip(STEMS, (401, 201)):
        P = pool_out_len(L, pk, pp)
        out.append((B, L, pk, pp, P, min(L + pp, P * pk) - pp))
    return out


def k2_bound(B, k, C, elem=4):
    """K2, both towers: codes, table and bias in; pooled (``elem`` bytes:
    4, or 2 in the bf16 mode) and uint8 jstar out; k tap and bias adds
    and one compare per conv output."""
    calls = stem_calls(B, k, C)
    n_bytes = sum(B * L + B * C * P * (elem + 1) + (k * 16 * C + C) * 4
                  for B, L, _, _, P, _ in calls)
    return bound(n_bytes, sum(B * lv * C * (k + 1)
                              for B, _, _, _, _, lv in calls))


def k3_bound(B, k, C, elem=4):
    """K3, both towers: codes, uint8 jstar and g (``elem`` bytes) in;
    dtable out; k adds per pooled output."""
    calls = stem_calls(B, k, C)
    n_bytes = sum(B * L + B * C * P * (elem + 1) + k * 16 * C * 4
                  for B, L, _, _, P, _ in calls)
    return bound(n_bytes, sum(B * C * P * k for B, _, _, _, P, _ in calls))


def folded_stem(conv1):
    """(table, bias) of a stem's BN + conv at its running statistics."""
    import torch
    from mural_tpu_torch.ops.fused_code_conv import fold_bn_conv_table
    bn, conv = conv1[0], conv1[1]
    with torch.no_grad():
        return fold_bn_conv_table(conv.weight, conv.bias, bn.weight, bn.bias,
                                  bn.running_mean, bn.running_var)


def one_hot16(codes, k):
    """(B, L) codes -> (B, 16, L + k - 1) float32 one-hot of the
    sentinel-padded codes: the library yardstick's prepared input."""
    import torch.nn.functional as F
    from mural_tpu_torch.ops.fused_code_conv import SENTINEL
    p = (k - 1) // 2
    padded = F.pad(codes.long(), (p, p), value=SENTINEL)
    return F.one_hot(padded, 16).float().transpose(1, 2).contiguous()


def random_table(gen, k, C, dev):
    """A seeded (k, 16, C) table whose sentinel row 15 is zero, and a
    (C,) bias."""
    import torch
    t = torch.randn((k, 16, C), generator=gen)
    t[:, 15] = 0.0
    return t.to(dev), torch.randn(C, generator=gen).to(dev)


def random_codes(gen, B, L, dev):
    import torch
    return torch.randint(0, 15, (B, L), generator=gen,
                         dtype=torch.uint8).to(dev)


def phase_k1(model, dev, gen):
    """K1 against its plain version (bit-exact) and its timings beside the
    plain version, the library yardstick and the bound."""
    import torch
    from mural_tpu_torch.ops import fused_code_conv as fcc
    table, bias = folded_stem(model.conv1_2)
    k, _, C = table.shape
    full = random_codes(gen, BATCH, 401, dev)
    ragged = random_codes(gen, 37, 401, dev)
    small = full[:256]
    tables = {"": (table, bias)}
    # C=30 takes the kernel's scalar-channel path, k=5 and k=7 its path
    # for a kernel size other than 3
    for name, (kx, cx) in {" C=30": (k, 30), " k=5": (5, C),
                           " C=8 k=7": (7, 8)}.items():
        tables[name] = random_table(gen, kx, cx, dev)
    cases = [(f"{B}x401", codes, "") for B, codes in
             ((BATCH, full), (256, small), (37, ragged))]
    # tower 1's crop: a strided view (row stride 401, offset 100)
    cases += [(f"{B}x201 crop", codes[:, 100:301], "") for B, codes in
              ((BATCH, full), (256, small), (37, ragged))]
    cases.append(("256x2001", random_codes(gen, 256, 2001, dev), ""))
    cases += [(f"{B}x{what}{name}", codes, name) for name in list(tables)[1:]
              for B, what, codes in ((BATCH, "401", full),
                                     (BATCH, "201 crop", full[:, 100:301]),
                                     (37, "401", ragged))]
    err = 0.0
    for name, codes, tname in cases:
        out = fcc.code_conv1d(codes, *tables[tname])
        ref = fcc.code_conv1d_reference(codes, *tables[tname])
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        log(f"K1 {name}: max |kernel - plain| = {e:.3g}")
        if not e == 0:
            raise AssertionError(f"K1 differs from its plain version on "
                                 f"{name}: max |diff| {e}")
        err = max(err, e)
    return {**time_k1(full, table, bias, k, C), "max_abs_err": err,
            "at_b256": time_k1(small, table, bias, k, C)}


def time_k1(full, table, bias, k, C):
    """K1, its plain version and the library yardstick on one predict
    batch of ``full``: its L=401 rows and their L=201 crop."""
    import torch.nn.functional as F
    from mural_tpu_torch.ops import fused_code_conv as fcc
    crop = full[:, 100:301]
    # the library yardstick: one conv over a prepared 16-channel one-hot
    weight = table.permute(2, 1, 0).contiguous()            # (C, 16, k)
    oh_full, oh_crop = one_hot16(full, k), one_hot16(crop, k)
    e_lib = (F.conv1d(oh_full, weight, bias).transpose(1, 2)
             - fcc.code_conv1d(full, table, bias)).abs().max().item()
    log(f"K1 vs F.conv1d yardstick (B={len(full)}): max |diff| = "
        f"{e_lib:.3g}")
    if not e_lib <= TOL_LIBRARY:
        raise AssertionError(f"F.conv1d yardstick disagrees: {e_lib}")

    def batch_kernel():
        fcc.code_conv1d(full, table, bias)
        fcc.code_conv1d(crop, table, bias)

    def batch_plain():
        fcc.code_conv1d_reference(full, table, bias)
        fcc.code_conv1d_reference(crop, table, bias)

    def batch_library():
        F.conv1d(oh_full, weight, bias)
        F.conv1d(oh_crop, weight, bias)

    B = len(full)
    bound_ms, bound_by = k1_bound([(B, 401), (B, 201)], k, C)
    out = {"ms": device_ms(batch_kernel, what=f"k1 B={B}"),
           "plain_ms": device_ms(batch_plain, what=f"k1_plain B={B}"),
           "library_ms": device_ms(batch_library, what=f"k1_library B={B}"),
           "call_ms": cuda_ms(batch_kernel),
           "plain_call_ms": cuda_ms(batch_plain),
           "library_call_ms": cuda_ms(batch_library),
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"K1 one predict batch at B={B}: " + json.dumps(out))
    return out


# (B, W) of K4's calls on the main path: the INDEL map's batch, INDEL
# training's, and the unfused SNV map's
K4_SHAPES = ((4096, 8000), (128, 8000), (4096, 2001))


def k4_bound(B, W, elem):
    """K4 on B windows of W: code bytes, starts and strand flags in, the
    (B, W, 4) one-hot (``elem`` bytes an entry) out; no arithmetic."""
    return bound(B * W * (1 + 4 * elem) + 9 * B + 64 * elem, 0)


def k4_inputs(gen, B, W, dev):
    """A 4-Mb code chunk with the windows' margins (every code 0-15), B
    window starts in it (its two ends first) and mixed strand flags."""
    import torch
    src = torch.randint(0, 16, ((1 << 22) + 2 * W,), generator=gen,
                        dtype=torch.uint8)
    starts = torch.randint(0, len(src) - W + 1, (B,), generator=gen)
    starts[:2] = torch.tensor([0, len(src) - W])
    neg = torch.rand(B, generator=gen) < 0.5
    return src.to(dev), starts.to(dev), neg.to(dev)


def phase_k4(dev, gen):
    """K4 against its plain version, bit for bit, at the main path's
    shapes in float32 and bf16, with mixed strands and with none given,
    and ``one_hot_from_codes`` on (128, 8000) codes and a strided view;
    float32 timings of kernel, plain version and the library yardstick
    beside the bound, and the bf16 kernel's beside its own; the device
    ops of one INDEL map batch's encode."""
    import torch
    import torch.nn.functional as F
    from mural_tpu_torch.device import constant
    from mural_tpu_torch.ops import window_one_hot as wo
    from mural_tpu_torch.ops.device_gather import make_batch_encoder
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def same(a, b):
        torch.cuda.synchronize()
        return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(bits[a.dtype]), b.view(bits[b.dtype])))

    checks, out = {}, {}
    for B, W in K4_SHAPES:
        src, starts, neg = k4_inputs(gen, B, W, dev)
        for dtype in bits:
            for n, strand in ((neg, "mixed strands"), (None, "no strands")):
                checks[f"{B}x{W} {dtype} {strand}"] = same(
                    wo.window_one_hot(src, starts, W, n, dtype),
                    wo.window_one_hot_plain(src, starts, W, n, dtype))
        codes = src.unfold(0, W, 1)[starts]           # the windows (B, W)
        table = constant(wo.ONE_HOT16, dev, torch.float32)
        rec = {}
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
            rec[f"{tag}ms"] = device_ms(
                lambda: wo.window_one_hot(src, starts, W, neg, dtype),
                what=f"k4 {B}x{W} {dtype}")
            rec[f"{tag}bound_ms"], rec[f"{tag}bound_by"] = k4_bound(
                B, W, torch.finfo(dtype).bits // 8)
            rec[f"{tag}bound_share"] = rec[f"{tag}bound_ms"] / rec[
                f"{tag}ms"]
        rec.update(
            plain_ms=device_ms(
                lambda: wo.window_one_hot_plain(src, starts, W, neg),
                what=f"k4_plain {B}x{W}"),
            library_ms=device_ms(lambda: F.embedding(codes.long(), table),
                                 what=f"k4_library {B}x{W}"),
            call_ms=cuda_ms(lambda: wo.window_one_hot(src, starts, W, neg)))
        log(f"K4 B={B} W={W}: " + json.dumps(rec))
        out[f"{B}x{W}"] = rec
        del src, starts, neg, codes
    codes = k4_inputs(gen, 128, 8000, dev)[0][:128 * 8000].view(128, 8000)
    for form, c in (("(128, 8000)", codes),
                    ("strided view", codes[:, 7:2008])):
        for dtype in bits:
            checks[f"one_hot_from_codes {form} {dtype}"] = same(
                wo.one_hot_from_codes(c, dtype),
                wo.one_hot_from_codes_plain(c, dtype))
    check_all("K4 against its plain version, bit for bit", checks)
    # one INDEL map batch's encode (``mural_indel predict_genome``'s
    # widths): K4 builds the one-hot, no table gather runs
    encode, lw, dw = make_batch_encoder(
        INDEL_CONFIG["local_radius"], INDEL_CONFIG["local_order"],
        INDEL_CONFIG["distal_radius"], "indel")
    src, dstart, neg = k4_inputs(gen, 4096, dw, dev)
    src = src % 15              # a chunk holds genome codes, no sentinel
    encode_trace = forward_trace(
        lambda: encode(src, dstart + (dw - lw) // 2, dstart, neg),
        f"INDEL map encode (B=4096, W={dw})")
    return {"max_abs_err": 0.0, "cases": len(checks), "timings": out,
            "indel_map_encode_trace": encode_trace}


# (N, C, L): calls a step of every train-mode BatchNorm of one U-Net step
# at the human INDEL recipe (B=128, W=8000; the use_reverse stem twice,
# c and 2c channels a level, encoder and decoder, out_conv's) and of one
# SNVNet2 step's towers after the fused stem at the human SNV recipe (L =
# 2001; 4 at the first pooled length, 5 at the second, 1 at the third)
def k5_step_shapes():
    B, L, k = TRAIN_BATCH, 2 * INDEL_CONFIG["distal_radius"], \
        INDEL_CONFIG["CNN_kernel_size"]
    ch = [INDEL_CONFIG["CNN_out_channels"] * (i + 1) for i in range(6)]
    lens, n = [], L
    for s in INDEL_CONFIG["down_list"]:
        n = (n + 2 * ((k - 1) // 2) - k) // s + 1
        lens.append(n)
    unet = {(B, 4, L): 2}
    for lv, (c, n) in enumerate(zip(ch, lens)):
        times = 2 if lv == 5 else 4          # encoder, and decoder below 5
        unet[(B, c, n)] = unet.get((B, c, n), 0) + times
        unet[(B, 2 * c, n)] = unet.get((B, 2 * c, n), 0) + times // 2
    unet[(B, ch[0], lens[0])] += 1            # out_conv
    snv = {}
    for L0, pools in ((2001, ((15, 15, 7), (7, 7, 3), (3, 3, 1))),
                      (201, ((3, 3, 1),) * 3)):
        n, lens = L0, []
        for pk, ps, pp in pools:
            n = (n + 2 * pp - pk) // ps + 1
            lens.append(n)
        for n, times in zip(lens, (4, 5, 1)):
            snv[(B, 32, n)] = times
    return {"indel": unet, "snv": snv}


def k5_bound(N, C, L):
    """K5's forward and backward on an (N, C, L) float32 plane: x in, y
    out; x and dy in, dx out."""
    return bound(5 * 4 * N * C * L, 0)


def k5_check(shape, dtype, dev, gen):
    """K5 forward and backward on one plane against the float64 reference:
    the worst error of y and dx over its bound (<= 1 passes; bounds as
    ``tests/test_torch_port_batch_norm.py test_k5_matches_float64``), and
    whether dweight, dbias and the running statistics are within theirs."""
    import torch
    from mural_tpu_torch.ops import batch_norm as bn
    N, C, L = shape
    x = (torch.randn(shape, generator=gen) * (0.5 + 3 * torch.rand(
        (1, C, 1), generator=gen)) + 2 * torch.randn((1, C, 1),
                                                     generator=gen))
    g = torch.randn(shape, generator=gen)
    x, g = x.to(dev, dtype), g.to(dev, dtype)
    m = bn.BatchNorm1d(C).to(dev)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5)
        m.bias.normal_(0, 0.3)
    w, b = m.weight.detach().double(), m.bias.detach().double()
    xg = x.clone().requires_grad_()
    y = m(xg)
    y.backward(g)
    rm, rv = m.running_mean, m.running_var      # from 0 and 1
    x64, g64 = x.double(), g.double()
    M = N * L
    mean = x64.mean((0, 2))
    xm = x64 - mean[:, None]
    var = (xm * xm).mean((0, 2))
    rstd = 1 / torch.sqrt(var + 1e-5)
    xhat = xm * rstd[:, None]
    ry = xhat * w[:, None] + b[:, None]
    db, dw = g64.sum((0, 2)), (g64 * xhat).sum((0, 2))
    rdx = (w * rstd)[:, None] * (g64 - db[:, None] / M
                                 - xhat * dw[:, None] / M)
    worst = 0.0
    for got, want in ((y, ry), (xg.grad, rdx)):
        err = (got.detach().double() - want).abs()
        bnd = 1e-5 * want.abs().max()
        if dtype == torch.bfloat16:
            bnd = bnd + 2.0 ** -7 * want.abs()
        worst = max(worst, float((err / bnd).max()))
    sums = (torch.all((m.weight.grad.double() - dw).abs()
                      <= 1e-5 * (g64 * xhat).abs().sum((0, 2)))
            and torch.all((m.bias.grad.double() - db).abs()
                          <= 1e-5 * g64.abs().sum((0, 2)))
            and torch.all((rm.double() - 0.1 * mean).abs()
                          <= 1e-5 * mean.abs().clamp(min=1))
            and torch.all((rv.double() - (0.9 + 0.1 * var * M / (M - 1)))
                          .abs() <= 1e-5 * rv.double()))
    return worst, bool(sums)


def bn_composition(x, weight, bias, eps=1e-5):
    """Train-mode BatchNorm's forward written out in plain torch ops
    (``var_mean``, then the affine), the K5 table's plain column; autograd
    gives its backward."""
    import torch
    var, mean = torch.var_mean(x, dim=(0, 2), correction=0)
    scale = torch.rsqrt(var + eps) * weight
    return (x - mean[:, None]) * scale[:, None] + bias[:, None]


def phase_k5(dev, gen, seed):
    """K5 against the float64 reference at every BatchNorm plane of one
    U-Net step (B=128, W=8000) and of the SNV towers (B=128, L=2001) in
    float32 and bf16; at each plane the device ms of forward + backward
    of K5, of cuDNN's BatchNorm (``nn.BatchNorm1d``, a yardstick the port
    no longer calls in train mode on a card) and of the plain composition
    (:func:`bn_composition`), beside
    K5's byte bound, and their sums over one step; then one eager U-Net
    train step at the benchmark's widths (AdamW through
    ``GraphOptimizer``, B=128) with K5 and with cuDNN's BatchNorm: the
    device ms of a step, the host's untraced issue ms of one step onto an
    idle card, and the ms a step of ten issued back to back."""
    import torch
    import torch.nn.functional as F
    from mural_tpu_torch.ops import batch_norm as bn
    checks, planes, per_step = {}, {}, {}
    for kind, shapes in k5_step_shapes().items():
        total = {"ms": 0.0, "cudnn_ms": 0.0, "plain_ms": 0.0,
                 "bound_ms": 0.0, "calls": 0, "elements_per_window": 0}
        for shape, times in shapes.items():
            N, C, L = shape
            tag = "x".join(map(str, shape))
            for dtype in (torch.float32, torch.bfloat16):
                worst, sums = k5_check(shape, dtype, dev, gen)
                checks[f"{kind} {tag} {dtype} y, dx"] = worst <= 1.0
                checks[f"{kind} {tag} {dtype} dweight, dbias, running"] = \
                    sums
            x = torch.randn(shape, generator=gen).to(dev).requires_grad_()
            g = torch.randn(shape, generator=gen).to(dev)
            ours, theirs = bn.BatchNorm1d(C).to(dev), \
                torch.nn.BatchNorm1d(C).to(dev)
            p = [torch.ones(C, device=dev, requires_grad=True),
                 torch.zeros(C, device=dev, requires_grad=True)]

            def fwd_bwd(fn, params):
                # the gradients returned, not accumulated into x.grad
                # (which would add a pass over x to every timing)
                return lambda: torch.autograd.grad(fn(x), (x, *params), g)

            k5 = fwd_bwd(ours, (ours.weight, ours.bias))
            cudnn = fwd_bwd(theirs, (theirs.weight, theirs.bias))
            rec = {
                "ms": device_ms(k5, what=f"k5 {tag}"),
                "cudnn_ms": device_ms(cudnn, what=f"k5_cudnn {tag}"),
                "plain_ms": device_ms(
                    fwd_bwd(lambda t: bn_composition(t, *p), p),
                    what=f"k5_plain {tag}"),
                "call_ms": cuda_ms(k5), "cudnn_call_ms": cuda_ms(cudnn),
                "calls_a_step": times}
            rec["bound_ms"], rec["bound_by"] = k5_bound(*shape)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            rec["cudnn_bound_share"] = rec["bound_ms"] / rec["cudnn_ms"]
            planes[f"{kind} {tag}"] = rec
            log(f"K5 {kind} {tag}: " + json.dumps(rec))
            for key in ("ms", "cudnn_ms", "plain_ms", "bound_ms"):
                total[key] += times * rec[key]
            total["calls"] += times
            total["elements_per_window"] += times * C * L
            del x, g
        total["bound_share"] = total["bound_ms"] / total["ms"]
        total["cudnn_bound_share"] = total["bound_ms"] / total["cudnn_ms"]
        per_step[kind] = total
        log(f"K5 per {kind} train step: " + json.dumps(total))
    check_all("K5 against the float64 reference", checks)
    step = k5_indel_step(dev, seed)
    return {"cases": len(checks), "planes": planes, "per_step": per_step,
            "indel_step": step}


def k5_indel_step(dev, seed):
    """One eager U-Net train step at the benchmark's widths with K5 and
    with cuDNN's BatchNorm (the same weights, the port's BatchNorms'
    class set back to ``nn.BatchNorm1d``): device ms of a step (profiler),
    the host's issue ms of one step onto an idle card (the median of 10,
    each after a synchronise: untraced, nothing waits on the card), and
    the wall ms a step of 10 issued back to back."""
    import torch
    from mural_tpu_torch.ops import batch_norm as bn
    from mural_tpu_torch.train.optim import GraphOptimizer, LRSchedule
    from mural_tpu_torch.train.steps import TrainState, step_update
    gen = torch.Generator().manual_seed(seed + 20)
    base = indel_model(seed + 20)
    B, W = TRAIN_BATCH, 2 * INDEL_CONFIG["distal_radius"]
    distal = torch.eye(4)[torch.randint(0, 4, (B, W), generator=gen)]
    distal, y = distal.to(dev), torch.randint(0, 8, (B,), generator=gen)
    y, mask = y.to(dev), torch.ones(B, device=dev)
    cat = torch.zeros((B, 12), dtype=torch.long, device=dev)
    out = {}
    for name in ("k5", "cudnn"):
        model = copy.deepcopy(base).to(dev)
        if name == "cudnn":
            for m in model.modules():
                if type(m) is bn.BatchNorm1d:
                    m.__class__ = torch.nn.BatchNorm1d
        opt = GraphOptimizer("AdamW", model.parameters(), 0.01)
        state = TrainState(model, opt, LRSchedule.build(
            "StepLR", 1e-3, 0.98, B, B * 1000, 1e-4, 1e-6))
        opt.scalars.copy_(torch.tensor(opt.step_scalars(1e-3, 1)))

        def one():
            return step_update(state, y, cat, distal, mask)

        def steps(n):
            for _ in range(n):
                one()
            torch.cuda.synchronize()

        steps(3)
        issue = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(10)
        wall = (time.perf_counter() - t0) / 10 * 1e3
        before = bn.LAUNCHES
        steps(1)
        launches = bn.LAUNCHES - before
        out[name] = {"device_ms": device_busy_ms(lambda: steps(5)) / 5,
                     "host_issue_ms": float(np.median(issue)),
                     "host_issue_ms_range": [min(issue), max(issue)],
                     "wall_ms": wall, "k5_launches_a_step": launches}
        log(f"U-Net eager train step (B={B}, W={W}), {name} BatchNorm: "
            + json.dumps(out[name]))
        del model, state, opt
    check_all("U-Net step", {
        f"K5 launched {K5_UNET} times a step (36 BatchNorms of 3-D "
        "activations)": out["k5"]["k5_launches_a_step"] == K5_UNET,
        "no K5 launch with cuDNN's BatchNorm":
            out["cudnn"]["k5_launches_a_step"] == 0})
    return out


def check_stem_case(name, codes, table, bias, pk, pp, gen, bf16=False):
    """K2 and K3 against their plain versions on one stem call: K2 within
    TOL_K2 (in the bf16 mode: equal) with identical ``jstar``, K3 within
    TOL_K3_REL of max|dtable| and bit-identical over two runs.  Returns
    (K2 error, K3 error, K3 relative error, g, jstar)."""
    import torch
    from mural_tpu_torch.ops import fused_train_stem as fts
    k = table.shape[0]
    pooled, jstar = fts.code_conv_pool_forward(codes, table, bias, pk, pp,
                                               bf16)
    ref, ref_j = fts.code_conv_pool_reference(codes, table, bias, pk, pp,
                                              bf16)
    g = torch.randn(pooled.shape, generator=gen).to(codes.device,
                                                    pooled.dtype)
    dt = fts.code_conv_pool_backward(codes, jstar, g, k, pk, pp, bf16)
    dt2 = fts.code_conv_pool_backward(codes, jstar, g, k, pk, pp, bf16)
    ref_dt = fts.code_conv_pool_backward_reference(codes, ref_j, g, k, pk,
                                                   pp, bf16)
    torch.cuda.synchronize()
    e2 = (pooled.float() - ref.float()).abs().max().item()
    same_j = torch.equal(jstar, ref_j)
    e3 = (dt - ref_dt).abs().max().item()
    r3 = e3 / ref_dt.abs().max().item()
    same_dt = torch.equal(dt, dt2)
    log(f"K2 {name}{' bf16 mode' if bf16 else ''}: max |kernel - plain| "
        f"= {e2:.3g}, jstar "
        f"{'identical' if same_j else 'DIFFERS'}; K3: max |kernel - plain| "
        f"= {e3:.3g} ({r3:.3g} of max|dtable|), two runs "
        f"{'bit-identical' if same_dt else 'DIFFER'}")
    if not (e2 <= (0 if bf16 else TOL_K2) and same_j and r3 <= TOL_K3_REL
            and same_dt):
        raise AssertionError(f"K2/K3 disagree with their plain versions on "
                             f"{name}")
    return e2, e3, r3, g, jstar


def phase_k2_k3(model, dev, gen, bf16=False):
    """K2 and K3 (in the float32 mode, or the bf16 mode) against their
    plain versions, and their timings beside the library composition and
    the bounds."""
    import torch
    tables = [folded_stem(model.conv1_2), folded_stem(model.conv1)]
    k, _, C = tables[0][0].shape
    # seeded random tables whose sentinel row 15 is zero: C=30 takes the
    # kernels' scalar-channel path and unaligned tile edges, k=5 their
    # path for a kernel size other than 3
    extra = {name: random_table(gen, kx, cx, dev)
             for name, (kx, cx) in {"C=30": (k, 30), "k=5": (5, C)}.items()}
    errs = []
    timings = {}
    for B in (TRAIN_BATCH, 2048, 37):
        full = torch.randint(0, 15, (B, 401), generator=gen,
                             dtype=torch.uint8).to(dev)
        inputs = (full, full[:, 100:301])
        grads, jstars = [], []
        for (name, pk, pp), codes, (table, bias) in zip(STEMS, inputs,
                                                        tables):
            e2, e3, r3, g, jstar = check_stem_case(
                f"{name} B={B}", codes, table, bias, pk, pp, gen, bf16)
            errs.append((e2, e3, r3))
            grads.append(g)
            jstars.append(jstar)
            if B != TRAIN_BATCH:
                errs += [check_stem_case(f"{name} {what} B={B}", codes,
                                         *tb, pk, pp, gen, bf16)[:3]
                         for what, tb in extra.items()]
        if B == 37:
            continue
        timings[B] = time_stem(inputs, tables, grads, jstars, k, bf16)
        log(f"K2/K3{' bf16 mode' if bf16 else ''} one train step at B={B}: "
            + json.dumps(timings[B]))
    # a long row (L=2001) with tower 2's pool
    long_rows = torch.randint(0, 15, (TRAIN_BATCH, 2001), generator=gen,
                              dtype=torch.uint8).to(dev)
    _, pk, pp = STEMS[0]
    errs.append(check_stem_case(f"L=2001 pool {pk} B={TRAIN_BATCH}",
                                long_rows, *tables[0], pk, pp, gen,
                                bf16)[:3])
    err_k2, err_k3, rel_k3 = (max(e) for e in zip(*errs))
    elem = 2 if bf16 else 4
    return {"max_abs_err_k2": err_k2, "max_abs_err_k3": err_k3,
            "max_rel_err_k3": rel_k3, "timings": timings,
            "bound_k2": k2_bound(TRAIN_BATCH, k, C, elem),
            "bound_k3": k3_bound(TRAIN_BATCH, k, C, elem),
            "bound_k2_b2048": k2_bound(2048, k, C, elem),
            "bound_k3_b2048": k3_bound(2048, k, C, elem)}


def time_stem(inputs, tables, grads, jstars, k, bf16=False):
    """Per train step (both towers): K2, K3, their plain versions and the
    library composition (conv on a prepared one-hot + max pool with
    indices, and that composition's autograd backward; in the bf16 mode
    under a bfloat16 autocast), each as device time (``*_ms``) and as
    the caller's time per call (``*_call_ms``)."""
    import torch
    import torch.nn.functional as F
    from mural_tpu_torch.ops import fused_train_stem as fts
    calls = list(zip(STEMS, inputs, tables, grads, jstars))

    def run(fn):
        return lambda: [fn(*c) for c in calls]

    def autocast():
        return torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16)

    lib = []
    for (_, pk, pp), codes, (table, bias), g, _ in calls:
        w = table.permute(2, 1, 0).contiguous().requires_grad_()
        b = bias.detach().clone().requires_grad_()
        oh = one_hot16(codes, k)
        with autocast():
            out, _ = F.max_pool1d(F.conv1d(oh, w, b), pk, pk, pp,
                                  return_indices=True)
        ref, _ = fts.code_conv_pool_forward(codes, table, bias, pk, pp, bf16)
        e = (out.float() - ref.float()).abs().max().item()
        # bf16: the library rounds the one-hot's weight, the kernel the
        # table; 4 bfloat16 steps of the output's scale
        tol = 4 * 2.0 ** -8 * ref.float().abs().max().item() if bf16 \
            else TOL_LIBRARY
        if not e <= tol:
            raise AssertionError(f"library composition disagrees: {e}")
        lib.append((oh, w, b, out, g))

    def library_forward():
        with autocast():
            return [F.max_pool1d(F.conv1d(oh, w, b), s[1], s[1], s[2],
                                 return_indices=True)
                    for (oh, w, b, _, _), s in zip(lib, STEMS)]

    fns = {
        "k2": run(lambda s, c, t, g, j: fts.code_conv_pool_forward(
            c, t[0], t[1], s[1], s[2], bf16)),
        "k2_plain": run(lambda s, c, t, g, j: fts.code_conv_pool_reference(
            c, t[0], t[1], s[1], s[2], bf16)),
        "k2_library": library_forward,
        "k3": run(lambda s, c, t, g, j: fts.code_conv_pool_backward(
            c, j, g, k, s[1], s[2], bf16)),
        "k3_plain": run(
            lambda s, c, t, g, j: fts.code_conv_pool_backward_reference(
                c, j, g, k, s[1], s[2], bf16)),
        "k3_library": lambda: [
            torch.autograd.grad(out, (w, b), g, retain_graph=True)
            for (_, w, b, out, g) in lib],
    }
    B = len(inputs[0])
    mode = " bf16" if bf16 else ""
    out = {f"{name}_ms": device_ms(fn, what=f"{name}{mode} B={B}")
           for name, fn in fns.items()}
    out.update({f"{name}_call_ms": cuda_ms(fn) for name, fn in fns.items()})
    return out


def phase_model(model, dev, gen):
    """Fused (through K1) vs unfused forward on the card, and the card's
    unfused forward vs the CPU's."""
    import torch
    from mural_tpu_torch.models.layers import one_hot_from_codes
    from mural_tpu_torch.ops.fused_inference import (fold_snv2,
                                                     snv2_fused_forward)
    cat = torch.randint(0, 65, (BATCH, 13), generator=gen).to(dev)
    codes = torch.randint(0, 15, (BATCH, 401), generator=gen,
                          dtype=torch.uint8).to(dev)
    model = model.to(dev).eval()
    with torch.inference_mode():
        folded = fold_snv2(model)
        unfused = model(cat, one_hot_from_codes(codes))
        fused = snv2_fused_forward(folded, cat, codes)
        e = (fused - unfused).abs().max().item()
        log(f"fused vs unfused SNVNet2 forward (B={BATCH}): max |diff| = "
            f"{e:.3g}")
        if not (e <= TOL_MODEL and torch.isfinite(fused).all()):
            raise AssertionError(f"fused forward disagrees: {e}")
        cpu_model = copy.deepcopy(model).cpu()
        small = slice(0, 64)
        cpu_out = cpu_model(cat[small].cpu(),
                            one_hot_from_codes(codes[small].cpu()))
        e_cpu = (unfused[small].cpu() - cpu_out).abs().max().item()
        log(f"card vs CPU unfused forward (B=64): max |diff| = {e_cpu:.3g}")
        if not e_cpu <= TOL_MODEL:
            raise AssertionError(f"card and CPU forwards disagree: {e_cpu}")
        fwd_ms = {
            "fused_forward_ms": cuda_ms(
                lambda: snv2_fused_forward(folded, cat, codes), iters=10),
            "unfused_forward_ms": cuda_ms(
                lambda: model(cat, one_hot_from_codes(codes)), iters=10),
            "fused_forward_trace": forward_trace(
                lambda: snv2_fused_forward(folded, cat, codes),
                f"fused forward (B={BATCH})")}
    return max(e, e_cpu), fwd_ms


def forward_trace(fn, what, top=8):
    """The device ops of one call of ``fn`` (``what``: a forward or a train
    step) from torch.profiler: their summed device ms, the ``top`` ops by
    time (name, ms, calls), and the op that runs after each K1 launch
    (what reads K1's output, and whether a copy does)."""
    events = device_events(fn)
    by_name = {}
    for name, _, us in events:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, calls + 1)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    trace = {
        "device_ms": sum(us for _, _, us in events) / 1e3,
        "top": [{"name": name[:160], "ms": ms, "calls": calls}
                for name, (ms, calls) in ops],
        "after_k1": [{"name": events[i + 1][0][:160],
                      "ms": events[i + 1][2] / 1e3}
                     for i, (name, _, _) in enumerate(events[:-1])
                     if "code_conv1d_kernel" in name]}
    log(f"{what}, one call: {trace['device_ms']:.4f} ms of device ops; "
        f"the top {top} by time:")
    for op in trace["top"]:
        log(f"  {op['ms']:.4f} ms  {op['calls']:3d} calls  {op['name']}")
    for op in trace["after_k1"]:
        log(f"  after K1: {op['ms']:.4f} ms  {op['name']}")
    return trace


def train_batches(gen, n, B):
    """``n`` batches (y, cat, codes) of genome-like codes (ACGT, 0.1% N)."""
    import torch
    out = []
    for _ in range(n):
        codes = torch.randint(0, 4, (B, 401), generator=gen,
                              dtype=torch.uint8)
        codes[torch.rand((B, 401), generator=gen) < 1e-3] = 14
        out.append((torch.randint(0, 4, (B,), generator=gen),
                    torch.randint(0, 65, (B, 13), generator=gen), codes))
    return out


def make_state(model, dev, n_steps):
    from mural_tpu_torch.train.optim import LRSchedule, build_optimizer
    from mural_tpu_torch.train.steps import TrainState
    model = copy.deepcopy(model).to(dev)
    return TrainState(model, build_optimizer("Adam", model.parameters(),
                                             1e-5),
                      LRSchedule.build("StepLR", 1e-3, 0.9, TRAIN_BATCH,
                                       TRAIN_BATCH * n_steps, 1e-4, 1e-6))


def run_steps(state, batches, dev, fused):
    import torch
    from mural_tpu_torch.train.steps import model_input, train_step
    losses = []
    for y, cat, codes in batches:
        loss, _ = train_step(
            state, y.to(dev), cat.to(dev),
            model_input(codes.to(dev), fused),
            torch.ones(len(y), device=dev))
        losses.append(loss.item())
    return losses


def phase_train_step(dev, seed):
    """Fused vs unfused Adam steps on the card, card vs CPU, and the step
    time with the device's busy share (torch.profiler kernel time)."""
    import torch
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.registry import build_model_from_config
    from mural_tpu_torch.train.steps import model_input, train_step
    cfg = dict(CONFIG, emb_dropout=0.0, local_dropout=0.0,
               distal_fc_dropout=0.0)
    gen = torch.Generator().manual_seed(seed + 1)
    model = init_weights(build_model_from_config(cfg, 0, "snv"), gen)
    batches = train_batches(gen, 5, TRAIN_BATCH)
    fused = run_steps(make_state(model, dev, 5), batches, dev, True)
    unfused = run_steps(make_state(model, dev, 5), batches, dev, False)
    rel = [abs(a - b) / abs(b) for a, b in zip(fused, unfused)]
    log(f"train steps, fused vs unfused (5 Adam steps of "
        f"{TRAIN_BATCH}): losses {fused} vs {unfused}, max rel diff "
        f"{max(rel):.3g}")
    if not (max(rel) <= TOL_STEP and np.isfinite(fused).all()):
        raise AssertionError(f"fused and unfused train steps disagree: "
                             f"{rel}")
    small = [(y[:16], cat[:16], codes[:16]) for y, cat, codes in batches[:2]]
    card = run_steps(make_state(model, dev, 2), small, dev, False)
    cpu = run_steps(make_state(model, torch.device("cpu"), 2), small,
                    torch.device("cpu"), False)
    rel_cpu = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"train steps, card vs CPU (2 unfused steps of 16): max rel diff "
        f"{rel_cpu:.3g}")
    if not rel_cpu <= TOL_STEP:
        raise AssertionError(f"card and CPU train steps disagree: {rel_cpu}")

    timing = {}
    for name, is_fused in (("fused", True), ("unfused", False)):
        state = make_state(model, dev, 40)
        batch = [(y.to(dev), cat.to(dev), model_input(codes.to(dev),
                                                      is_fused))
                 for y, cat, codes in batches]
        mask = torch.ones(TRAIN_BATCH, device=dev)

        def steps(n):
            for i in range(n):
                y, cat, distal = batch[i % len(batch)]
                train_step(state, y, cat, distal, mask)
            torch.cuda.synchronize()

        steps(5)
        t0 = time.perf_counter()
        steps(20)
        wall_ms = (time.perf_counter() - t0) / 20 * 1e3
        busy_ms = device_busy_ms(lambda: steps(10)) / 10
        timing[name] = {"step_ms": wall_ms, "device_busy_ms": busy_ms,
                        "device_busy_share": (busy_ms / wall_ms
                                              if busy_ms else None)}
    log("train step at B=128 (host clock, device busy from "
        "torch.profiler): " + json.dumps(timing))
    return max(rel), rel_cpu, timing


def device_events(fn, attempts=3):
    """(name, start us, duration us) of each device event (kernels and
    copies) that torch.profiler records while ``fn`` runs, in start
    order; ``fn`` ends in a synchronise or the caller's next one. Now and
    then the profiler hands back a trace without its device events; the
    capture (``fn`` included) is then made again, up to ``attempts``
    times in all, and an empty list means that every one came back so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    events = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted(((e.name, e.time_range.start,
                          e.time_range.elapsed_us())
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e[1])
        if events:
            break
        log("torch.profiler's capture held no device events")
        time.sleep(0.1)
    return events


def device_busy_ms(fn) -> float:
    """Summed duration of the device events (kernels and copies) that
    torch.profiler records while ``fn`` runs; 0 when it records none."""
    return sum(us for _, _, us in device_events(fn)) / 1e3


def read_tsv(path):
    with gzip.open(path, "rt") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    keys = [r[:5] for r in rows]
    probs = np.asarray([[float(v) for v in r[5:]] for r in rows])
    return header, keys, probs


TSV_HEADER = ["chrom", "start", "end", "strand", "mut_type", "prob0",
              "prob1", "prob2", "prob3"]


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def run_cli(cli, argv):
    """One CLI command, its output echoed; returns (exit code, seconds,
    printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        t0 = time.perf_counter()
        rc = cli(argv)
        seconds = time.perf_counter() - t0
    return rc, seconds, buf.getvalue().splitlines()


def cli_predict(cli, common, out, extra=()):
    """One predict through the CLI; returns its run record with the K1
    launches counted from 0 just before it."""
    import torch
    from mural_tpu_torch.ops import fused_code_conv as fcc
    fcc.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, _, lines = run_cli(cli, ["predict", *common, "--pred_file", out,
                                 *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"rc": rc, "seconds": seconds, "launches": fcc.LAUNCHES,
            "lines": lines, "tsv": read_tsv(out)}


_CORR_LINE = re.compile(r"(?:(\d+mer) correlation: +|regional corr: "
                        r"(\d+bp) )\[(.*)\]$")
_CORR_SECONDS = re.compile(r"k-mer and regional correlation ([\d.]+)s")


def printed_correlations(lines):
    """{'3mer' | '<w>bp': [r per class]} of predict's correlation lines."""
    out = {}
    for line in lines:
        m = _CORR_LINE.match(line)
        if m:
            out[m[1] or m[2]] = [float(v) for v in m[3].split(",")]
    return out


def phase_predict(work, fasta, bed, model_path, n_sites, cuda_id):
    """The predict path, through the CLI, fused and unfused."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    common = ["--ref_genome", fasta, "--test_data", bed,
              "--model_path", model_path,
              "--model_config_path", model_path + ".config.pkl",
              "--calibrator_path", model_path + ".fdiri_cal.pkl",
              "--pred_batch_size", str(BATCH), "--cuda_id", str(cuda_id),
              "--pred_time_view"]
    runs = {}
    corr_flags = ["--kmer_corr", "3", "5", "7", "--region_corr", "100000",
                  "500000"]
    for name, extra in (("fused", ["--fused_inference", *corr_flags]),
                        ("unfused", [])):
        runs[name] = run = cli_predict(cli, common,
                                       str(work / f"pred_{name}.tsv.gz"),
                                       extra)
        # the time view's host seconds of the correlations; sites/s is
        # counted without them, as in the runs before they were added
        run["corr_s"] = next((float(m[1]) for m in map(
            _CORR_SECONDS.search, run["lines"]) if m), None)
        run["sites_per_s"] = n_sites / (run["seconds"] - run["corr_s"])
        log(f"predict {name}: {run['seconds']:.3f} s, of which k-mer and "
            f"regional correlation {run['corr_s']:.3f} s; "
            f"{run['sites_per_s']:.1f} sites/s without them, K1 launches "
            f"{run['launches']}")

    n_batches = math.ceil(n_sites / BATCH)
    fused, unfused = runs["fused"], runs["unfused"]
    header, keys, probs = fused["tsv"]
    corr = fused["correlations"] = printed_correlations(fused["lines"])
    log("predict fused, correlations: " + json.dumps(corr))
    check_all("predict", {
        "exit codes 0": fused["rc"] == 0 and unfused["rc"] == 0,
        "TSV schema": header == TSV_HEADER
        and unfused["tsv"][0] == TSV_HEADER,
        f"{n_sites} rows": len(keys) == n_sites,
        "probabilities finite and summing to 1": bool(
            np.isfinite(probs).all()
            and np.abs(probs.sum(1) - 1).max() <= 1e-3),
        f"K1 launched 2 x {n_batches} batches":
            fused["launches"] == 2 * n_batches,
        "no K1 launch unfused": unfused["launches"] == 0,
        "3mer, 5mer, 7mer, 100000bp and 500000bp correlation lines":
            sorted(corr) == sorted(["3mer", "5mer", "7mer", "100000bp",
                                    "500000bp"])
            and all(len(v) == 4 for v in corr.values()),
        "finite 3-mer correlations": bool(np.isfinite(corr.get("3mer",
                                                               [np.nan])
                                                      ).all()),
        "same rows fused and unfused": keys == unfused["tsv"][1],
        # both files print %.4g: one unit in the 4th digit apart at most
        "probabilities agree within %.4g": bool(np.all(
            np.abs(probs - unfused["tsv"][2])
            <= 1.1e-3 * np.maximum(np.abs(probs),
                                   np.abs(unfused["tsv"][2])))),
    })
    return fused, unfused


def check_all(what, checks):
    for name, ok in checks.items():
        log(f"check {what}: {name}: {'ok' if ok else 'FAILED'}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{what} checks failed: {failed}")


_EPOCH_LINE = re.compile(
    r"Epoch (\d+) used time: ([\d.]+)s \(train (\d+) steps in ([\d.]+)s, "
    r"valid (\d+) batches in ([\d.]+)s, fetch ([\d.]+)s; calib/eval/ckpt "
    r"overlap the next epoch\)")
_TAIL_LINE = re.compile(
    r"Epoch (\d+) tail: ([\d.]+)s on its thread \(calibration, "
    r"evaluation ([\d.]+)s, checkpoint\)")


def trial_epochs(trial: Path):
    """The per-epoch records of a trial's ``training.log``: the epoch
    line's seconds (train, validation, the snapshot fetch) and the
    epoch's tail, which runs on its thread while the next epoch trains
    (``tail_s`` None for an epoch whose tail did not log)."""
    text = (trial / "training.log").read_text()
    tails = {int(m[0]): (float(m[1]), float(m[2]))
             for m in _TAIL_LINE.findall(text)}
    epochs = [dict(zip(("epoch", "epoch_s", "train_steps", "train_s",
                        "valid_batches", "valid_s", "fetch_s"),
                       (int(m[0]), float(m[1]), int(m[2]), float(m[3]),
                        int(m[4]), float(m[5]), float(m[6]))))
              for m in _EPOCH_LINE.findall(text)]
    for e in epochs:
        e["train_windows_per_s"] = e["train_steps"] * TRAIN_BATCH \
            / e["train_s"]
        e["tail_s"], e["evaluation_s"] = tails.get(e["epoch"], (None, None))
    return epochs


def cli_train(cli, work, fasta, bed, name, cuda_id, extra,
              command="train"):
    """One ``train`` (or ``transfer``) run through the CLI from ``work``;
    returns its first trial's directory and per-epoch records (every
    trial's in ``trials``), its printed lines and the K2/K3 and K5
    launches counted from 0 just before it."""
    import torch
    from mural_tpu_torch.ops import batch_norm as bn
    from mural_tpu_torch.ops import fused_train_stem as fts
    argv = [command, "--ref_genome", fasta, "--train_data", bed,
            "--experiment_name", name, "--n_trials", "1", "--batch_size",
            str(TRAIN_BATCH), "--valid_ratio", "0.2", "--split_seed", "0",
            "--cuda_id", str(cuda_id), *extra]
    fts.FWD_LAUNCHES = fts.BWD_LAUNCHES = bn.LAUNCHES = 0
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, _, lines = run_cli(cli, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = (fts.FWD_LAUNCHES, fts.BWD_LAUNCHES, bn.LAUNCHES)
    exp = work / "results" / name
    trials = {d: trial_epochs(exp / d) for d in sorted(os.listdir(exp))
              if d.startswith("Train_")}
    first = min(trials, key=lambda d: d.rsplit("_", 1)[-1])
    return {"rc": rc, "seconds": seconds, "trial": exp / first,
            "epochs": trials[first], "trials": trials, "lines": lines,
            "k2": launches[0], "k3": launches[1], "k5": launches[2],
            "n_trials": len(trials)}


def phase_train_cli(work, fasta, bed, n_train, cuda_id):
    """The training path through the CLI: train with the fused stem,
    get_best_model, predict on the best triple; then unfused for one
    epoch."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    run = cli_train(cli, work, fasta, bed, "fused", cuda_id,
                    ["--fused_stem", "on", "--epochs", "2"])
    trial, epochs = run["trial"], run["epochs"]
    steps = sum(e["train_steps"] for e in epochs)
    vbatches = sum(e["valid_batches"] for e in epochs)
    metrics = []
    for epoch in (0, 1):
        path = trial / f"checkpoint_{epoch}" / f"epoch_{epoch}_metrics.txt"
        metrics.append(dict(line.split(": ", 1) for line in
                            path.read_text().splitlines()) if path.exists()
                       else {})
    progress = trial / "progress.csv"
    rows = progress.read_text().splitlines() if progress.exists() else []
    check_all("train --fused_stem on", {
        "exit code 0": run["rc"] == 0,
        f"resident data, {FED_K} steps per CUDA graph replay": any(
            line.startswith("device-resident data: ") and line.endswith(
                f"{FED_K} train steps per CUDA graph replay")
            for line in run["lines"]),
        "one trial": run["n_trials"] == 1,
        "two epochs logged": len(epochs) == 2,
        "checkpoint_0 and checkpoint_1 hold the triple": all(
            (trial / f"checkpoint_{e}" / f).exists() for e in (0, 1)
            for f in ("model", "model.config.pkl", "model.fdiri_cal.pkl")),
        "finite loss, fdiri_loss and score in both metrics files": all(
            np.isfinite(float(m.get(k, "nan"))) for m in metrics
            for k in ("loss", "fdiri_loss", "score")),
        "progress.csv has two epochs, each with a finite score":
            len(rows) == 3 and rows[0].split(",")[4] == "score"
            and all(np.isfinite(float(r.split(",")[4])) for r in rows[1:]),
        f"K2 launched 2 x ({steps} train steps + {vbatches} validation "
        f"batches)": run["k2"] == 2 * (steps + vbatches),
        f"K3 launched 2 x {steps} train steps": run["k3"] == 2 * steps,
        f"K5 launched {K5_SNV_FUSED} x {steps} train steps (CUDA graph "
        "replays included)": run["k5"] == K5_SNV_FUSED * steps > 0,
    })
    log(f"train --fused_stem on: {run['seconds']:.3f} s; K5 launches "
        f"{run['k5']}; epochs "
        + json.dumps(epochs))

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_best = cli(["get_best_model", "--trial_path",
                       str(work / "results" / "fused")])
    log(out.getvalue().rstrip())
    # the first line echoes the command; the best trial's line follows,
    # its path relative to the directory train ran in
    best = os.path.normpath(os.path.join(
        work, out.getvalue().splitlines()[1].split("\t")[0]))
    model_path = os.path.join(best, "model")
    pred = cli_predict(cli, [
        "--ref_genome", fasta, "--test_data", bed,
        "--model_path", model_path,
        "--model_config_path", model_path + ".config.pkl",
        "--calibrator_path", model_path + ".fdiri_cal.pkl",
        "--pred_batch_size", str(BATCH), "--cuda_id", str(cuda_id)],
        str(work / "pred_trained.tsv.gz"), ["--fused_inference"])
    header, keys, probs = pred["tsv"]
    n_batches = math.ceil(n_train / BATCH)
    check_all("get_best_model -> predict --fused_inference", {
        "exit codes 0": rc_best == 0 and pred["rc"] == 0,
        "best checkpoint is one of the trial's":
            os.path.dirname(best) == str(trial),
        "TSV schema": header == TSV_HEADER,
        f"{n_train} rows": len(keys) == n_train,
        "probabilities finite and summing to 1": bool(
            np.isfinite(probs).all()
            and np.abs(probs.sum(1) - 1).max() <= 1e-3),
        f"K1 launched 2 x {n_batches} batches":
            pred["launches"] == 2 * n_batches,
    })

    # the host-fed path with one eager step per batch stays driven here
    off = cli_train(cli, work, fasta, bed, "unfused", cuda_id,
                    ["--fused_stem", "off", "--epochs", "1",
                     "--save_valid_preds", "--poisson_calib",
                     "--resident_data", "off", "--steps_per_dispatch", "1"])
    valid_preds = off["trial"] / "checkpoint_0" / "model.valid_preds.tsv.gz"
    vp = read_tsv(valid_preds) if valid_preds.exists() else ([], [], None)
    off_log = (off["trial"] / "training.log").read_text()
    off_steps = sum(e["train_steps"] for e in off["epochs"])
    check_all("train --fused_stem off --save_valid_preds --poisson_calib "
              "--resident_data off --steps_per_dispatch 1", {
        "exit code 0": off["rc"] == 0,
        "one epoch logged": len(off["epochs"]) == 1,
        "checkpoint_0 holds the triple": all(
            (off["trial"] / "checkpoint_0" / f).exists()
            for f in ("model", "model.config.pkl", "model.fdiri_cal.pkl")),
        "no K2/K3 launch": off["k2"] == 0 and off["k3"] == 0,
        f"K5 launched {K5_SNV_UNFUSED} x {off_steps} eager train steps":
            off["k5"] == K5_SNV_UNFUSED * off_steps > 0,
        "checkpoint_0/model.valid_preds.tsv.gz in the predict schema":
            vp[0] == TSV_HEADER and len(vp[1]) > 0,
        "the log has the (after Poisson_cal) evaluation lines": all(
            f"{k}mer correlation(after Poisson_cal)" in off_log
            for k in (3, 5, 7))
            and "regional score(after Poisson_cal)" in off_log,
    })
    log(f"train --fused_stem off: {off['seconds']:.3f} s; epochs "
        + json.dumps(off["epochs"]))
    run["best_model"] = model_path
    run["k5_unfused"] = off["k5"]
    return run, off


RATE_COLUMNS = [f"{kind}{i}" for kind in ("avg_obs_rate", "avg_pred_rate",
                                          "number_of_mut")
                for i in (1, 2, 3)] + ["number_of_all"]


def read_corr(path):
    """Rows (tag, subtype, r, p) of a ``corr.txt``."""
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    return [(r[0], int(r[1]), float(r[2]), float(r[3])) for r in rows]


def read_lines(path):
    with gzip.open(path, "rt") as fh:
        return fh.read().splitlines()


def phase_evaluate(work, fasta, pred_file):
    """evaluate, calc_scaling_factor and scale through the CLI on phase
    6's fused prediction TSV."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    from mural_tpu_torch.predict.scaling import calc_mu_scaling_factor
    seconds = {}

    def run(name, argv):
        rc, seconds[name], lines = run_cli(cli, argv)
        log(f"{name}: {seconds[name]:.3f} s")
        return rc, lines

    prefix = work / "ev"
    rcs = [run("evaluate", ["evaluate", "--pred_file", pred_file,
                            "--ref_genome", fasta, "--out_prefix",
                            str(prefix)])[0],
           run("evaluate --kmer_only --kmer_length 5", [
               "evaluate", "--pred_file", pred_file, "--ref_genome", fasta,
               "--out_prefix", str(prefix), "--kmer_only", "--kmer_length",
               "5"])[0]]
    rc, lines = run("calc_scaling_factor", [
        "calc_scaling_factor", "--pred_files", pred_file, "--genomewide_mu",
        "1e-8", "--m_proportions", "1", "--g_proportions", "1",
        "--do_scaling"])
    rcs.append(rc)
    printed = next((float(line.split(": ")[1]) for line in lines
                    if line.startswith("scaling factor: ")), math.nan)
    # the exact factor, which the CLI prints to 4 digits only
    factor = calc_mu_scaling_factor([pred_file], 1e-8, [1.0], 4,
                                    printer=lambda *a: None)
    scaled = work / "scaled.tsv.gz"
    rcs.append(run("scale", ["scale", "--pred_file", pred_file,
                             "--scale_factor", repr(factor), "--out_file",
                             str(scaled)])[0])

    files = {f"{prefix.name}.{tag}.{kind}": prefix.with_name(
        f"{prefix.name}.{tag}.{kind}") for tag in ("3-mer", "5-mer", "100Kb")
        for kind in ("mut_rates.tsv", "corr.txt")}
    headers = {name: path.read_text().split("\n", 1)[0].split("\t")
               for name, path in files.items()
               if path.exists() and name.endswith(".tsv")}
    corrs = {name: read_corr(path) for name, path in files.items()
             if path.exists() and name.endswith(".txt")}
    _, _, probs = read_tsv(scaled)
    check_all("evaluate, calc_scaling_factor and scale", {
        "exit codes 0": rcs == [0, 0, 0, 0],
        "six files": all(path.exists() for path in files.values()),
        "k-mer headers": [headers.get(f"ev.{k}-mer.mut_rates.tsv")
                          for k in (3, 5)] == [["type"] + RATE_COLUMNS] * 2,
        "regional header": headers.get("ev.100Kb.mut_rates.tsv") == [
            "chrom", "window_end"] + RATE_COLUMNS + ["used_or_deprecated"],
        "each corr.txt has 3 rows with finite r": len(corrs) == 3 and all(
            [r[1] for r in rows] == [1, 2, 3]
            and all(np.isfinite(r[2]) for r in rows)
            for rows in corrs.values()),
        "the factor finite and positive, printed to 4 digits": bool(
            np.isfinite(factor) and factor > 0
            and abs(printed - factor) <= 5e-4 * factor),
        "the two scaled files equal line for line":
            read_lines(pred_file + ".scaled.tsv.gz") == read_lines(scaled),
        "scaled probabilities summing to 1": bool(
            np.isfinite(probs).all()
            and np.abs(probs.sum(1) - 1).max() <= 1e-3),
    })
    return {"seconds": seconds, "scale_factor": factor,
            "corr": {name: [r[2] for r in rows]
                     for name, rows in corrs.items()}}


def write_indel_inputs(work: Path, rng: np.random.Generator, n_sites: int,
                       n_train: int):
    """Two sorted INDEL BEDs on the synthetic genome (any base, either
    strand, labels uniform over 0..7): one to predict, one to train on."""
    out = []
    for name, total in (("indel_sites.bed", n_sites),
                        ("indel_train.bed", n_train)):
        rows = []
        for chrom, n in CHROMS.items():
            k = total * 3 // 4 if chrom == "chr1" else total - total * 3 // 4
            pos = np.sort(rng.choice(n, k, replace=False))
            strand = rng.choice(["+", "-"], k)
            labels = rng.integers(0, 8, size=k)
            rows += [f"{chrom}\t{p}\t{p + 1}\t.\t{y}\t{s}"
                     for p, s, y in zip(pos, strand, labels)]
        (work / name).write_text("\n".join(rows) + "\n")
        out.append(str(work / name))
    return out


def indel_model(seed, use_reverse=True):
    """The U-Net at the CLI defaults with the reference init from ``seed``
    and randomised BN statistics and affine parameters (within 25% of
    their initial values, so the 28 BNs in a row keep unit scale)."""
    import torch
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.registry import build_model_from_config
    gen = torch.Generator().manual_seed(seed)
    cfg = dict(INDEL_CONFIG, use_reverse=use_reverse)
    model = init_weights(build_model_from_config(cfg, 0, "indel"), gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                n = m.num_features
                m.weight.copy_(0.8 + 0.45 * torch.rand(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.8 + 0.45 * torch.rand(n,
                                                            generator=gen))
    return model


def write_indel_checkpoint(work: Path, seed: int):
    """A ``--use_reverse`` U-Net triple at the CLI defaults, made by the
    port, with a seeded 8-class FullDirichlet calibrator."""
    from mural_tpu_torch.calibrate.dirichlet import FullDirichletCalibrator
    from mural_tpu_torch.train.checkpoint import save_checkpoint
    model = indel_model(seed)
    noise = np.random.default_rng(seed).normal(size=(8, 9))
    w = np.hstack([np.eye(8), np.zeros((8, 1))]) + 0.1 * noise
    path = str(work / "indel_checkpoint_0" / "model")
    save_checkpoint(path, model, INDEL_CONFIG,
                    calibrator=FullDirichletCalibrator.from_weights(w))
    return path


def kernel_launches():
    """(K1, K2, K3) launch counts since their last reset."""
    from mural_tpu_torch.ops import fused_code_conv as fcc
    from mural_tpu_torch.ops import fused_train_stem as fts
    return fcc.LAUNCHES, fts.FWD_LAUNCHES, fts.BWD_LAUNCHES


def counted(fn, *args):
    """``fn(*args)`` with K1-K5 counted from 0; returns (result, K1-K3
    counts); K4's is ``window_one_hot.LAUNCHES``, K5's
    ``batch_norm.LAUNCHES``."""
    from mural_tpu_torch.ops import batch_norm as bn
    from mural_tpu_torch.ops import fused_code_conv as fcc
    from mural_tpu_torch.ops import fused_train_stem as fts
    from mural_tpu_torch.ops import window_one_hot as wo
    bn.LAUNCHES = 0
    fcc.LAUNCHES = fts.FWD_LAUNCHES = fts.BWD_LAUNCHES = wo.LAUNCHES = 0
    out = fn(*args)
    return out, kernel_launches()


def phase_indel_forward(model_path, dev, seed):
    """The card's U-Net forward against the CPU's for both ``use_reverse``
    variants (B=4, eval mode), the device ms of one forward (one-hot
    included) at B=256 and B=1024, and the top device ops of one forward
    at B=1024."""
    import torch
    from mural_tpu_torch.models.layers import one_hot_from_codes
    from mural_tpu_torch.models.registry import build_model_from_config
    from mural_tpu_torch.train.checkpoint import load_checkpoint
    gen = torch.Generator().manual_seed(seed + 3)
    width = 2 * INDEL_CONFIG["distal_radius"]
    codes = torch.randint(0, 4, (INDEL_PRED_BATCH, width), generator=gen,
                          dtype=torch.uint8)
    codes[torch.rand(codes.shape, generator=gen) < 1e-3] = 14
    model = load_checkpoint(model_path, build_model_from_config(
        INDEL_CONFIG, 0, "indel"))
    errs = {}
    with torch.inference_mode():
        for use_reverse, m in ((True, model),
                               (False, indel_model(seed + 4, False))):
            m = m.eval()
            cpu = m(None, one_hot_from_codes(codes[:4]))
            card = copy.deepcopy(m).to(dev)(
                None, one_hot_from_codes(codes[:4].to(dev))).cpu()
            errs[use_reverse] = ((card - cpu).abs().max()
                                 / max(1.0, cpu.abs().max())).item()
            log(f"U-Net card vs CPU forward (B=4, use_reverse "
                f"{use_reverse}): max |diff| {errs[use_reverse]:.3g} of "
                f"max(1, max|out|), outputs {cpu[0].tolist()}")
        model = model.to(dev)
        big = codes.to(dev)
        fwd = {f"forward_ms_b{B}": cuda_ms(
            lambda B=B: model(None, one_hot_from_codes(big[:B])), iters=10)
            for B in (256, INDEL_PRED_BATCH)}
        fwd["forward_trace_b1024"] = forward_trace(
            lambda: model(None, one_hot_from_codes(big)),
            f"U-Net forward (B={INDEL_PRED_BATCH})")
    log("U-Net forward (CUDA events, one-hot included): "
        + json.dumps({k: v for k, v in fwd.items() if "trace" not in k}))
    check_all("INDEL U-Net forward", {
        "card vs CPU within 1e-4, both use_reverse variants":
            all(e <= TOL_MODEL for e in errs.values())})
    return {"card_vs_cpu": errs, **fwd}


def phase_indel_step(dev, seed, fasta, train_bed):
    """Host batch build of B=128 INDEL batches from the training BED;
    two unfused steps of 16 on the card against the CPU (dropout 0); one
    B=128 step's host ms, device busy share and top device ops."""
    import torch
    from mural_tpu_torch.data.batcher import segment_pool_batches
    from mural_tpu_torch.data.dataset import prepare_dataset
    from mural_tpu_torch.train.steps import model_input, train_step
    cfg = INDEL_CONFIG
    ds = prepare_dataset(train_bed, fasta, central_bp=cfg["segment_center"],
                         local_radius=cfg["local_radius"],
                         local_order=cfg["local_order"],
                         distal_radius=cfg["distal_radius"],
                         model_type="indel")
    batches = []
    t0 = time.perf_counter()
    for batch in segment_pool_batches(ds, 10, TRAIN_BATCH, shuffle=True,
                                      rng=np.random.default_rng(seed)):
        batches.append((torch.from_numpy(batch.y).long(),
                        torch.from_numpy(batch.cat).long(),
                        torch.from_numpy(batch.distal)))
        if len(batches) == 20:
            break
    build_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    log(f"INDEL host batch build (B={TRAIN_BATCH}, W={ds.distal_width}, "
        f"dataset gather): {build_ms:.3f} ms per batch")
    model = indel_model(seed + 5)
    model.out_fc[1].p = 0.0
    small = [(y[:16], cat[:16], codes[:16]) for y, cat, codes in batches[:2]]
    card = run_steps(make_state(model, dev, 2), small, dev, False)
    cpu = run_steps(make_state(model, torch.device("cpu"), 2), small,
                    torch.device("cpu"), False)
    rel_cpu = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"U-Net train steps, card vs CPU (2 steps of 16): losses {card} vs "
        f"{cpu}, max rel diff {rel_cpu:.3g}")

    state = make_state(model, dev, 40)
    batch = [(y.to(dev), cat.to(dev), model_input(codes.to(dev), False))
             for y, cat, codes in batches[:5]]
    mask = torch.ones(TRAIN_BATCH, device=dev)

    def steps(n):
        for i in range(n):
            y, cat, distal = batch[i % len(batch)]
            train_step(state, y, cat, distal, mask)
        torch.cuda.synchronize()

    steps(3)
    t0 = time.perf_counter()
    steps(10)
    wall_ms = (time.perf_counter() - t0) / 10 * 1e3
    # the host's time to issue one step onto an idle card
    t0 = time.perf_counter()
    train_step(state, *batch[0], mask)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_busy_ms(lambda: steps(5)) / 5
    timing = {"host_batch_build_ms": build_ms, "step_ms": wall_ms,
              "host_enqueue_ms": enqueue_ms, "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / wall_ms if busy_ms else None}
    log(f"U-Net train step at B={TRAIN_BATCH} (host clock, device busy "
        "from torch.profiler): " + json.dumps(timing))
    timing["trace"] = forward_trace(lambda: steps(1),
                                    f"U-Net train step (B={TRAIN_BATCH})")
    check_all("INDEL train steps", {
        "card vs CPU per-step loss within 1e-4": rel_cpu <= TOL_STEP,
        "finite losses": bool(np.isfinite(card).all())})
    return {"card_vs_cpu_rel": rel_cpu, **timing}


def phase_indel_cli(work, fasta, bed, train_bed, cuda_id):
    """mural_indel train --use_reverse --epochs 1, get_best_model, predict
    --pred_batch_size 1024 on the best triple and evaluate --kmer_length 4
    on its TSV, all through the CLI."""
    from mural_tpu_torch.cli.mural_indel import main as cli
    # cli_train counts K2/K3 from 0 and cli_predict K1: K1 is read here
    # before predict resets it
    run = cli_train(cli, work, fasta, train_bed, "indel", cuda_id,
                    ["--use_reverse", "--epochs", "1"])
    k1_train = kernel_launches()[0]
    trial, epochs = run["trial"], run["epochs"]
    path = trial / "checkpoint_0" / "epoch_0_metrics.txt"
    metrics = (dict(line.split(": ", 1) for line in
                    path.read_text().splitlines()) if path.exists() else {})
    progress = trial / "progress.csv"
    rows = progress.read_text().splitlines() if progress.exists() else []
    check_all("mural_indel train --use_reverse", {
        "exit code 0": run["rc"] == 0,
        "one epoch logged": len(epochs) == 1,
        "checkpoint_0 holds the triple": all(
            (trial / "checkpoint_0" / f).exists()
            for f in ("model", "model.config.pkl", "model.fdiri_cal.pkl")),
        "finite loss, fdiri_loss and score": all(
            np.isfinite(float(metrics.get(k, "nan")))
            for k in ("loss", "fdiri_loss", "score")),
        "progress.csv has the epoch with a finite score":
            len(rows) == 2 and rows[0].split(",")[4] == "score"
            and np.isfinite(float(rows[1].split(",")[4])),
    })
    log(f"mural_indel train: {run['seconds']:.3f} s; epochs "
        + json.dumps(epochs))

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_best = cli(["get_best_model", "--trial_path",
                       str(work / "results" / "indel")])
    log(out.getvalue().rstrip())
    best = os.path.normpath(os.path.join(
        work, out.getvalue().splitlines()[1].split("\t")[0]))
    model_path = os.path.join(best, "model")
    pred_file = str(work / "indel_pred.tsv.gz")
    pred = cli_predict(cli, [
        "--ref_genome", fasta, "--test_data", bed,
        "--model_path", model_path,
        "--model_config_path", model_path + ".config.pkl",
        "--calibrator_path", model_path + ".fdiri_cal.pkl",
        "--pred_batch_size", str(INDEL_PRED_BATCH), "--cuda_id",
        str(cuda_id), "--pred_time_view"], pred_file)
    pred["sites_per_s"] = INDEL_SITES / pred["seconds"]
    header, keys, probs = pred["tsv"]
    log(f"mural_indel predict: {pred['seconds']:.3f} s, "
        f"{pred['sites_per_s']:.1f} sites/s")

    rc_ev, ev_s, _ = run_cli(cli, ["evaluate", "--pred_file", pred_file,
                                   "--ref_genome", fasta, "--out_prefix",
                                   str(work / "indel_ev"), "--kmer_length",
                                   "4"])
    log(f"mural_indel evaluate --kmer_length 4: {ev_s:.3f} s")
    k1, k2, k3 = kernel_launches()
    launches = (k1_train + k1, k2, k3)
    corr_files = [work / f"indel_ev.{tag}.corr.txt"
                  for tag in ("4-mer", "100Kb")]
    corrs = [read_corr(f) for f in corr_files if f.exists()]
    check_all("mural_indel get_best_model -> predict -> evaluate", {
        "exit codes 0": rc_best == 0 and pred["rc"] == 0 and rc_ev == 0,
        "best checkpoint is the trial's":
            os.path.dirname(best) == str(trial),
        "TSV schema with prob0..prob7": header == INDEL_TSV_HEADER,
        f"{INDEL_SITES} rows": len(keys) == INDEL_SITES,
        # Poisson calibration (always on for INDEL) keeps the sum at 1
        # but not the signs; each printed value is within 5e-4 of itself
        "probabilities finite and summing to 1 within %.4g": bool(
            np.isfinite(probs).all()
            and np.all(np.abs(probs.sum(1) - 1)
                       <= 5e-4 * np.abs(probs).sum(1) + 1e-6)),
        "4-mer and 100Kb files, each corr.txt with 7 subtypes": len(
            corrs) == 2 and all(
            (work / f"indel_ev.{tag}.mut_rates.tsv").exists()
            for tag in ("4-mer", "100Kb"))
            and all([r[1] for r in rows] == list(range(1, 8))
                    for rows in corrs),
        "finite 4-mer correlations": bool(corrs) and all(
            np.isfinite(r[2]) for r in corrs[0]),
    })
    return {"train_s": run["seconds"], "train_epochs": epochs,
            "predict_s": pred["seconds"],
            "predict_sites_per_s": pred["sites_per_s"],
            "evaluate_s": ev_s,
            "corr_4mer": [r[2] for r in corrs[0]] if corrs else None,
            "launches": launches, "best_model": model_path}


def phase_indel(work, fasta, model_path, beds, dev, seed):
    """The INDEL path: forward, train step and CLI, with K1-K3 counted
    from 0 around each part; none of them may launch."""
    from mural_tpu_torch.ops import batch_norm as bn
    from mural_tpu_torch.ops import window_one_hot as wo
    bed, train_bed = beds
    out, launches, k4, k5 = {}, [], {}, {}
    for name, fn, args in (
            ("forward", phase_indel_forward, (model_path, dev, seed)),
            ("train_step", phase_indel_step, (dev, seed, fasta, train_bed)),
            ("cli", phase_indel_cli, (work, fasta, bed, train_bed,
                                      dev.index or 0))):
        out[name], counts = counted(fn, *args)
        # the CLI part resets the counters itself and returns its own
        launches.append(out[name].pop("launches", counts))
        k4[name] = wo.LAUNCHES
        k5[name] = bn.LAUNCHES
    total = [sum(c) for c in zip(*launches)]
    log(f"INDEL phase, K1/K2/K3 launches: {total}; K4 launches by part: "
        f"{k4}; K5 launches by part: {k5}")
    check_all("INDEL phase", {
        "K1, K2 and K3 launched 0 times": total == [0, 0, 0],
        "K4 launched in every part": all(k4.values()),
        f"K5 launched in the training parts only, {K5_UNET} times a "
        "U-Net step": (
            k5["forward"] == 0 and k5["train_step"] > 0 and k5["cli"] > 0
            and k5["train_step"] % K5_UNET == 0
            and k5["cli"] % K5_UNET == 0)})
    out["k1_k2_k3_launches"] = total
    out["k4_launches"] = k4
    out["k5_launches"] = k5
    return out


# --- phase 10: the rest of the SNV family and the track features -------

FAMILY_TRAIN = 20_000   # sites of the phase-10 training BED
# the two seeded tracks of phase 10: (file, name, radius or None for the
# default local_radius, bases per interval, integer values)
TRACKS = (("coverage.bedGraph", "coverage", 50, 100, True),
          ("conservation.bedGraph.gz", "conservation", None, 1000, False))
# float32 in-block sums of at most 4096 values: each stored prefix sum is
# within 2^-24 * 4096 * max|value| of its float64 value
INBLOCK_ERR = 2.0 ** -24 * 4096


def write_tracks(work: Path, rng: np.random.Generator):
    """The phase's two bedGraph tracks over the synthetic genome and their
    list file: integer coverage in 100-bp steps (10% of the steps left
    out, reading 0) and fractional conservation scores in 1,000-bp steps,
    gzipped.  Returns the list file and each track's dense per-base
    float64 values by chromosome."""
    dense = []
    rows = []
    for fname, name, radius, step, integer in TRACKS:
        values = {}
        path = work / fname
        opener = gzip.open if fname.endswith(".gz") else open
        with opener(path, "wt") as fh:
            fh.write(f"track type=bedGraph name={name}\n")
            for chrom, n in CHROMS.items():
                starts = np.arange(0, n, step)
                keep = rng.random(len(starts)) >= (0.1 if integer else 0.0)
                vals = (rng.integers(0, 60, len(starts)).astype(np.float64)
                        if integer else
                        np.round(rng.random(len(starts)), 3))
                v = np.zeros(n)
                for s, val in zip(starts[keep], vals[keep]):
                    v[s:s + step] = val
                values[chrom] = v
                fh.write("".join(
                    f"{chrom}\t{s}\t{min(s + step, n)}\t"
                    f"{int(val) if integer else f'{val:.3f}'}\n"
                    for s, val in zip(starts[keep], vals[keep])))
        dense.append(values)
        rows.append(f"{path} {name}" + (f" {radius}" if radius else ""))
    track_list = work / "tracks.txt"
    track_list.write_text("# path name [radius]\n" + "\n".join(rows) + "\n")
    return str(track_list), dense


def phase_tracks(work, rng, bed):
    """Load the two tracks as ``--bw_paths`` does (bedGraph parse, prefix
    build, cache write) and hold the means (the continuous features) and
    per-base windows (the distal track channels) of 500 sites against
    brute-force float64 sums of the generated values: the integer track
    exactly (relative 1e-9 for means), the fractional one within the
    two-level structure's float32 bound."""
    from mural_tpu_torch.genome.bed import BedFile
    from mural_tpu_torch.genome.tracks import TrackSet
    track_list, dense = write_tracks(work, rng)
    t0 = time.perf_counter()
    tracks = TrackSet.from_list(track_list, CONFIG["local_radius"])
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    TrackSet.from_list(track_list, CONFIG["local_radius"])
    cached_s = time.perf_counter() - t0
    names, radii = tracks.names, tracks.radii
    log(f"tracks: {names} with radii {radii} loaded in {load_s:.3f} s "
        f"(bedGraph parse, prefix build, cache write); from the cache in "
        f"{cached_s:.3f} s")
    sites = BedFile.read(bed)
    pick = np.sort(rng.choice(len(sites), 500, replace=False))
    chroms = [sites.chrom[i] for i in pick]
    start, stop = sites.start[pick], sites.stop[pick]
    neg = sites.strand[pick]
    means = tracks.mean_over_sites(chroms, start, stop)
    width = 2 * CONFIG["distal_radius"] + 1
    windows = np.concatenate([tracks.distal_windows(
        c, start[i:i + 1] - CONFIG["distal_radius"], width, neg[i:i + 1])
        for i, c in enumerate(chroms)])
    errs, checks = {}, {}
    for j, ((_, name, _, _, integer), r) in enumerate(zip(TRACKS, radii)):
        want_m, n_bases = np.empty(len(pick)), np.empty(len(pick))
        want_w = np.empty((len(pick), width))
        for i, c in enumerate(chroms):
            v = dense[j][c]
            lo, hi = max(start[i] - r, 0), min(stop[i] + r, len(v))
            want_m[i] = v[lo:hi].mean() if hi > lo else 0.0
            n_bases[i] = max(hi - lo, 1)
            idx = start[i] - CONFIG["distal_radius"] + np.arange(width)
            w = np.where((idx >= 0) & (idx < len(v)),
                         v[np.clip(idx, 0, len(v) - 1)], 0.0)
            want_w[i] = w[::-1] if neg[i] else w
        bound = INBLOCK_ERR * max(np.abs(v).max() for v in dense[j].values())
        m_err = np.abs(means[:, j] - want_m)
        w_err = np.abs(windows[:, :, j] - want_w)
        errs[name] = {"mean_max_rel": float((m_err / np.maximum(
            np.abs(want_m), 1e-30)).max()), "mean_max_abs": float(
            m_err.max()), "window_max_abs": float(w_err.max()),
            "bound_abs": bound}
        if integer:
            checks[f"{name}: means within 1e-9 relative, per-base values "
                   "exact"] = bool((m_err <= 1e-9 * np.abs(want_m)).all()
                                   and w_err.max() == 0)
        else:
            checks[f"{name}: means and per-base values within the float32 "
                   "in-block bound"] = bool(
                (m_err <= 2 * bound / n_bases).all()
                and w_err.max() <= 2 * bound)
    log("tracks vs brute force (500 sites): " + json.dumps(errs))
    check_all("tracks", checks)
    return track_list, {"load_s": load_s, "cached_load_s": cached_s,
                        "errors": errs}


def family_model(cfg, n_cont, in_channels, seed, randomise_bn=True):
    """An SNV model at ``cfg``'s widths with the reference init from
    ``seed`` and, with ``randomise_bn``, randomised BN statistics and
    affine parameters."""
    import torch
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.registry import build_model
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(build_model(cfg["model_no"], cfg, {
        "emb_dims": cfg["emb_dims"], "n_cont": n_cont, "n_class": 4,
        "in_channels": in_channels}, "snv"), gen)
    if not randomise_bn:
        return model
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return model


# (label, model_no, n_cont, in_channels) of the phase's card-vs-CPU
# forwards
FAMILY_FORWARDS = (("SNVNet0", 0, 0, 4), ("SNVNet1", 1, 0, 4),
                   ("SNVNet2, n_cont 2", 2, 2, 4),
                   ("SNVNet3, n_cont 2, 6 channels", 3, 2, 6),
                   ("SNVNet3, n_cont 2, 4 channels", 3, 2, 4))


def family_inputs(gen, B, n_cont, in_channels):
    """(y, cat, codes, cont, tracks) on the CPU: genome-like codes,
    positive cont means and per-base track values."""
    import torch
    codes = torch.randint(0, 4, (B, 401), generator=gen, dtype=torch.uint8)
    codes[torch.rand((B, 401), generator=gen) < 1e-3] = 14
    cont = (1 + torch.rand((B, n_cont), generator=gen)) if n_cont else None
    tracks = (torch.rand((B, 401, in_channels - 4), generator=gen)
              if in_channels > 4 else None)
    return (torch.randint(0, 4, (B,), generator=gen),
            torch.randint(0, 65, (B, 13), generator=gen), codes, cont,
            tracks)


def _on(t, dev):
    return None if t is None else t.to(dev)


def family_steps(model, batches, dev, fused):
    """Five Adam steps of ``model`` on ``batches``; the per-step losses."""
    import torch
    from mural_tpu_torch.train.steps import model_input, train_step
    state = make_state(model, dev, len(batches))
    losses = []
    for y, cat, codes, cont, tracks in batches:
        loss, _ = train_step(state, y.to(dev), cat.to(dev),
                             model_input(codes.to(dev), fused,
                                         _on(tracks, dev)),
                             torch.ones(len(y), device=dev), _on(cont, dev))
        losses.append(loss.item())
    return losses


def phase_family_models(dev, seed):
    """Card against CPU forwards of the SNV family (B=4, eval mode), and
    five Adam steps of 128 with the fused stem (K2/K3) against unfused on
    SNVNet1 and on SNVNet3 with continuous features and 4 channels."""
    import torch
    from mural_tpu_torch.train.steps import model_input
    gen = torch.Generator().manual_seed(seed + 7)
    errs = {}
    with torch.inference_mode():
        for label, no, n_cont, ch in FAMILY_FORWARDS:
            model = family_model(dict(CONFIG, model_no=no), n_cont, ch,
                                 seed + no).eval()
            _, cat, codes, cont, tracks = family_inputs(gen, 4, n_cont, ch)
            cpu = model(cat, model_input(codes, False, tracks), cont)
            card = copy.deepcopy(model).to(dev)(
                cat.to(dev), model_input(codes.to(dev), False,
                                         _on(tracks, dev)),
                _on(cont, dev)).cpu()
            errs[label] = ((card - cpu).abs().max()
                           / max(1.0, cpu.abs().max())).item()
            log(f"{label}: card vs CPU forward (B=4) max |diff| "
                f"{errs[label]:.3g} of max(1, max|out|)")
    cfg = dict(CONFIG, emb_dropout=0.0, local_dropout=0.0,
               distal_fc_dropout=0.0)
    steps = {}
    for label, no, n_cont in (("SNVNet1", 1, 0),
                              ("SNVNet3, n_cont 2, 4 channels", 3, 2)):
        # from the reference init, as a trainer starts (phase 5)
        model = family_model(dict(cfg, model_no=no), n_cont, 4, seed + 9,
                             randomise_bn=False)
        batches = [family_inputs(gen, TRAIN_BATCH, n_cont, 4)
                   for _ in range(5)]
        fused = family_steps(model, batches, dev, True)
        unfused = family_steps(model, batches, dev, False)
        steps[label] = max(abs(a - b) / abs(b)
                           for a, b in zip(fused, unfused))
        log(f"{label}: 5 Adam steps of {TRAIN_BATCH}, fused vs unfused "
            f"losses {fused} vs {unfused}, max rel diff "
            f"{steps[label]:.3g}")
        if not np.isfinite(fused).all():
            steps[label] = math.inf
    check_all("SNV family models", {
        "card vs CPU forwards within 1e-4": all(
            e <= TOL_MODEL for e in errs.values()),
        "fused vs unfused steps within 1e-4": all(
            e <= TOL_STEP for e in steps.values())})
    return {"card_vs_cpu": errs, "steps_fused_vs_unfused": steps}


def write_family_bed(work: Path, train_bed: str,
                     name: str = "family_train.bed") -> str:
    """Every third site of a BED (still sorted), at most FAMILY_TRAIN:
    phase 10's 20,000-site training set from the training BED, and
    phase 11's search set from that."""
    rows = Path(train_bed).read_text().splitlines()[::3][:FAMILY_TRAIN]
    path = work / name
    path.write_text("\n".join(rows) + "\n")
    return str(path)


# (experiment, flags, n_cont, fused) of the phase's train runs
FAMILY_RUNS = (
    ("m3_tracks", ["--model_no", "3", "--bw_paths", "TRACKS"], 2, False),
    ("m3_fused", ["--model_no", "3", "--bw_paths", "TRACKS",
                  "--without_bw_distal", "--fused_stem", "on"], 2, True),
    ("m1_fused", ["--model_no", "1", "--fused_stem", "on"], 0, True),
    ("m0", ["--model_no", "0"], 0, False))


def phase_family_cli(work, fasta, bed, train_bed, track_list, cuda_id):
    """Four one-epoch ``mural_snv train`` runs of the SNV family through
    the CLI (K2/K3 counted from 0 around each), ``get_best_model`` and
    ``predict --bw_paths`` of the track-channel SNVNet3 on the predict
    BED, then the two predicts that must not run as asked."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    family_bed = write_family_bed(work, train_bed)
    runs = {}
    for name, flags, n_cont, fused in FAMILY_RUNS:
        argv = [track_list if a == "TRACKS" else a for a in flags]
        run = runs[name] = cli_train(cli, work, fasta, family_bed, name,
                                     cuda_id, ["--epochs", "1", *argv])
        trial = run["trial"]
        ck = trial / "checkpoint_0"
        metrics = (dict(line.split(": ", 1) for line in (
            ck / "epoch_0_metrics.txt").read_text().splitlines())
            if (ck / "epoch_0_metrics.txt").exists() else {})
        config = {}
        if (ck / "model.config.pkl").exists():
            with open(ck / "model.config.pkl", "rb") as fh:
                config = pickle.load(fh)
        steps = sum(e["train_steps"] for e in run["epochs"])
        vbatches = sum(e["valid_batches"] for e in run["epochs"])
        want = ((2 * (steps + vbatches), 2 * steps) if fused else (0, 0))
        check_all(f"train {' '.join(flags)}", {
            "exit code 0, one epoch logged": run["rc"] == 0
            and len(run["epochs"]) == 1,
            "checkpoint_0 holds the triple": all(
                (ck / f).exists()
                for f in ("model", "model.config.pkl", "model.fdiri_cal.pkl")),
            f"n_cont {n_cont} in the config": config.get("n_cont") == n_cont,
            "finite loss, fdiri_loss and score": all(
                np.isfinite(float(metrics.get(k, "nan")))
                for k in ("loss", "fdiri_loss", "score")),
            f"K2 {want[0]} and K3 {want[1]} launches (2 per train step and "
            "validation batch, 2 per train step)" if fused else
            "no K2/K3 launch": (run["k2"], run["k3"]) == want,
        })
        run["config_n_cont"] = config.get("n_cont")
        log(f"train {' '.join(flags)}: {run['seconds']:.3f} s; K2 "
            f"{run['k2']}, K3 {run['k3']}; epochs "
            + json.dumps(run["epochs"]))

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_best = cli(["get_best_model", "--trial_path",
                       str(work / "results" / "m3_tracks")])
    log(out.getvalue().rstrip())
    best = os.path.normpath(os.path.join(
        work, out.getvalue().splitlines()[1].split("\t")[0]))
    model_path = os.path.join(best, "model")
    common = ["--ref_genome", fasta, "--model_path", model_path,
              "--model_config_path", model_path + ".config.pkl",
              "--calibrator_path", model_path + ".fdiri_cal.pkl",
              "--pred_batch_size", str(BATCH), "--cuda_id", str(cuda_id)]
    n_sites = sum(1 for _ in open(bed))
    pred = cli_predict(cli, ["--test_data", bed, *common,
                             "--bw_paths", track_list, "--pred_time_view"],
                       str(work / "pred_tracks.tsv.gz"))
    pred["sites_per_s"] = n_sites / pred["seconds"]
    view = next((line for line in pred["lines"]
                 if line.startswith("time view")), "")
    m = re.search(r"host batch build on the prefetch thread ([\d.]+)s, of "
                  r"which track windows ([\d.]+)s", view)
    pred["batch_build_s"], pred["track_windows_s"] = (
        (float(m[1]), float(m[2])) if m else (None, None))
    log(f"predict --bw_paths (SNVNet3, 6 channels): {pred['seconds']:.3f} "
        f"s, {pred['sites_per_s']:.1f} sites/s; host batch build "
        f"{pred['batch_build_s']} s, of which track windows "
        f"{pred['track_windows_s']} s; K1 launches {pred['launches']}")
    header, keys, probs = pred["tsv"]
    fused_pred = cli_predict(cli, ["--test_data", family_bed, *common,
                                   "--bw_paths", track_list,
                                   "--fused_inference"],
                             str(work / "pred_tracks_fused.tsv.gz"))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli(["predict", "--test_data", family_bed, *common,
                 "--pred_file", str(work / "pred_no_tracks.tsv.gz")])
        missing = "no error"
    except ValueError as e:
        missing = str(e)
    log(f"predict without --bw_paths on the track checkpoint: {missing}")
    check_all("get_best_model -> predict --bw_paths", {
        "exit codes 0": rc_best == 0 and pred["rc"] == 0
        and fused_pred["rc"] == 0,
        "best checkpoint is the trial's": os.path.dirname(best) == str(
            runs["m3_tracks"]["trial"]),
        "TSV schema": header == TSV_HEADER,
        f"{n_sites} rows": len(keys) == n_sites,
        "probabilities finite and summing to 1": bool(
            np.isfinite(probs).all()
            and np.abs(probs.sum(1) - 1).max() <= 1e-3),
        "the time view reports the track windows' seconds":
            pred["track_windows_s"] is not None,
        "K1 launched 0 times": pred["launches"] == 0,
        "--fused_inference prints the NOTE and launches K1 0 times": any(
            line.startswith("NOTE: --fused_inference only supports")
            for line in fused_pred["lines"]) and fused_pred["launches"] == 0,
        "predict without --bw_paths raises the n_cont ValueError":
            "n_cont=2" in missing,
    })
    return {
        "train": {name: {"seconds": r["seconds"], "epochs": r["epochs"],
                         "k2": r["k2"], "k3": r["k3"]}
                  for name, r in runs.items()},
        "predict_s": pred["seconds"], "predict_sites_per_s":
            pred["sites_per_s"], "predict_batch_build_s":
            pred["batch_build_s"], "predict_track_windows_s":
            pred["track_windows_s"], "k1_launches": pred["launches"]
        + fused_pred["launches"]}


def phase_family(work, rng, fasta, bed, train_bed, dev, seed):
    """Phase 10: tracks, the family's models, and its CLI path."""
    track_list, tracks = phase_tracks(work, rng, bed)
    models = phase_family_models(dev, seed)
    cli = phase_family_cli(work, fasta, bed, train_bed, track_list,
                           dev.index or 0)
    return {"tracks": tracks, "models": models, **cli}


# --- phase 11: transfer, convert and the trial search --------------------

SEARCH_TRIALS = 4       # trials of the ASHA search
SEARCH_EPOCHS = 3       # its max_t (rungs at epochs 1 and 2)


def metrics_of(trial: Path, epoch: int) -> dict:
    path = trial / f"checkpoint_{epoch}" / f"epoch_{epoch}_metrics.txt"
    return (dict(line.split(": ", 1) for line in
                 path.read_text().splitlines()) if path.exists() else {})


def finite_metrics(trial: Path, epoch: int,
                   keys=("loss", "fdiri_loss", "score")) -> bool:
    m = metrics_of(trial, epoch)
    return all(np.isfinite(float(m.get(k, "nan"))) for k in keys)


def saved_config(model_path) -> dict:
    with open(str(model_path) + ".config.pkl", "rb") as fh:
        return pickle.load(fh)


def reference_layout(model) -> dict:
    """``model``'s state_dict as the reference MuRaL writes it: each
    ResBlock's layers again under ``layer.{1,2,4,5}``, the BN
    ``num_batches_tracked`` counters and, for an SNV model without
    continuous features, ``first_bn_layer = BatchNorm1d(0)``."""
    import torch
    sd = dict(model.state_dict())
    for name in list(sd):
        parts = name.split(".")
        if parts[0].startswith("RBs") and parts[2] in ("bn1", "conv1",
                                                      "bn2", "conv2"):
            idx = {"bn1": 1, "conv1": 2, "bn2": 4, "conv2": 5}[parts[2]]
            sd[".".join(parts[:2] + ["layer", str(idx)] + parts[3:])] = \
                sd[name]
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        sd[f"first_bn_layer.{leaf}"] = torch.zeros(0)
    sd["first_bn_layer.num_batches_tracked"] = torch.tensor(0)
    return sd


@contextlib.contextmanager
def watched_runner(seed):
    """The trial runner as the CLI calls it, with three probes: the
    search samples its configs and trial ids from ``seed`` (the CLI
    draws them from the OS), every in-process trial is recorded with the
    number of trials running at its start, and every trial process's
    wall seconds are kept."""
    import dataclasses
    import threading
    from mural_tpu_torch.tune import runner
    real = (runner.run_experiment, runner.train_trial,
            runner._run_trial_in_process)
    lock = threading.Lock()
    seen = {"running": 0, "trials": [], "process_s": {}}

    def run_experiment(space, opts, model_type, exp, **kw):
        return real[0](space, opts, model_type,
                       dataclasses.replace(exp, seed=seed), **kw)

    def train_trial(config, opts, *a, **kw):
        with lock:
            seen["running"] += 1
            seen["trials"].append((os.path.basename(opts.trial_dir),
                                   seen["running"], str(opts.device)))
        try:
            return real[1](config, opts, *a, **kw)
        finally:
            with lock:
                seen["running"] -= 1

    def run_trial_in_process(trial_id, *a, **kw):
        t0 = time.perf_counter()
        out = real[2](trial_id, *a, **kw)
        seen["process_s"][trial_id] = time.perf_counter() - t0
        return out

    (runner.run_experiment, runner.train_trial,
     runner._run_trial_in_process) = (run_experiment, train_trial,
                                      run_trial_in_process)
    try:
        yield seen
    finally:
        (runner.run_experiment, runner.train_trial,
         runner._run_trial_in_process) = real


def phase_transfer(work, fasta, bed, family_bed, snv_model, cuda_id):
    """``mural_snv transfer --fused_stem on`` from phase 7's best triple
    (final FCs re-initialised), then ``predict --fused_inference`` of the
    transferred triple on the predict BED."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    saved = saved_config(snv_model)
    run = cli_train(cli, work, fasta, family_bed, "transfer", cuda_id, [
        "--model_path", snv_model, "--model_config_path",
        snv_model + ".config.pkl", "--fused_stem", "on", "--epochs", "1"],
        command="transfer")
    trial, epochs = run["trial"], run["epochs"]
    steps = sum(e["train_steps"] for e in epochs)
    vbatches = sum(e["valid_batches"] for e in epochs)
    model_path = str(trial / "checkpoint_0" / "model")
    config = saved_config(model_path) if os.path.exists(
        model_path + ".config.pkl") else {}
    check_all("mural_snv transfer --fused_stem on", {
        "exit code 0, one trial, one epoch": run["rc"] == 0
        and run["n_trials"] == 1 and len(epochs) == 1,
        "checkpoint_0 holds the triple": all(
            os.path.exists(model_path + ext)
            for ext in ("", ".config.pkl", ".fdiri_cal.pkl")),
        "finite loss, fdiri_loss and score": finite_metrics(trial, 0),
        "n_class and model_no from the pretrained config, a transfer":
            config.get("n_class") == saved["n_class"] == 4
            and config.get("model_no") == saved["model_no"] == 2
            and config.get("transfer_learning") is True,
        "the --train_all warning printed": any(
            line.startswith("Warning: --train_all is required")
            for line in run["lines"]),
        f"K2 launched 2 x ({steps} train steps + {vbatches} validation "
        f"batches)": run["k2"] == 2 * (steps + vbatches),
        f"K3 launched 2 x {steps} train steps": run["k3"] == 2 * steps,
    })
    windows = epochs[0]["train_windows_per_s"] if epochs else math.nan
    log(f"mural_snv transfer: {run['seconds']:.3f} s, {windows:.1f} train "
        f"windows/s; K2 {run['k2']}, K3 {run['k3']}; epochs "
        + json.dumps(epochs))

    n_sites = sum(1 for _ in open(bed))
    pred = cli_predict(cli, [
        "--ref_genome", fasta, "--test_data", bed,
        "--model_path", model_path,
        "--model_config_path", model_path + ".config.pkl",
        "--calibrator_path", model_path + ".fdiri_cal.pkl",
        "--pred_batch_size", str(BATCH), "--cuda_id", str(cuda_id)],
        str(work / "pred_transferred.tsv.gz"), ["--fused_inference"])
    header, keys, probs = pred["tsv"]
    n_batches = math.ceil(n_sites / BATCH)
    check_all("predict --fused_inference of the transferred triple", {
        "exit code 0": pred["rc"] == 0,
        "TSV schema": header == TSV_HEADER,
        f"{n_sites} rows": len(keys) == n_sites,
        "probabilities finite and summing to 1": bool(
            np.isfinite(probs).all()
            and np.abs(probs.sum(1) - 1).max() <= 1e-3),
        f"K1 launched 2 x {n_batches} batches":
            pred["launches"] == 2 * n_batches,
    })
    pred["sites_per_s"] = n_sites / pred["seconds"]
    log(f"predict of the transferred triple: {pred['seconds']:.3f} s, "
        f"{pred['sites_per_s']:.1f} sites/s, K1 launches "
        f"{pred['launches']}")
    return {"seconds": run["seconds"], "epochs": epochs,
            "train_windows_per_s": windows, "k2": run["k2"],
            "k3": run["k3"], "predict_s": pred["seconds"],
            "predict_sites_per_s": pred["sites_per_s"],
            "k1": pred["launches"]}


def phase_indel_transfer(work, fasta, train_bed, indel_model, cuda_id):
    """``mural_indel transfer --init_fc_with_pretrained`` from phase 9's
    best triple: no kernel of the port launches."""
    from mural_tpu_torch.cli.mural_indel import main as cli
    (run, launches) = counted(lambda: cli_train(
        cli, work, fasta, train_bed, "indel_transfer", cuda_id, [
            "--model_path", indel_model, "--model_config_path",
            indel_model + ".config.pkl", "--init_fc_with_pretrained",
            "--epochs", "1"], command="transfer"))
    saved = saved_config(indel_model)
    model_path = run["trial"] / "checkpoint_0" / "model"
    config = (saved_config(model_path) if os.path.exists(
        str(model_path) + ".config.pkl") else {})
    check_all("mural_indel transfer --init_fc_with_pretrained", {
        "exit code 0, one epoch": run["rc"] == 0
        and len(run["epochs"]) == 1,
        "finite loss, fdiri_loss and score": finite_metrics(run["trial"],
                                                            0),
        "n_class 8 and the U-Net from the pretrained config":
            config.get("n_class") == saved["n_class"] == 8
            and config.get("down_list") == saved["down_list"],
        "K1, K2 and K3 launched 0 times": list(launches) == [0, 0, 0],
    })
    log(f"mural_indel transfer: {run['seconds']:.3f} s; epochs "
        + json.dumps(run["epochs"]))
    return {"seconds": run["seconds"], "epochs": run["epochs"],
            "launches": list(launches)}


def phase_convert(work, snv_model, dev, seed):
    """``mural_snv convert`` of a reference-layout triple written from
    phase 7's weights: the converted model's forward on the card equals
    the source's bit for bit."""
    import torch
    from mural_tpu_torch.cli.mural_snv import main as cli
    from mural_tpu_torch.models.layers import one_hot_from_codes
    from mural_tpu_torch.utils.zoo import input_geometry, load_zoo_checkpoint
    ref, out = work / "reference_ckpt", work / "converted_ckpt"
    ref.mkdir()
    model, config, _ = load_zoo_checkpoint(os.path.dirname(snv_model))
    torch.save(reference_layout(model), ref / "model")
    for ext in (".config.pkl", ".fdiri_cal.pkl"):
        shutil.copy(snv_model + ext, ref / f"model{ext}")
    rc, seconds, _ = run_cli(cli, ["convert", "--checkpoint_dir", str(ref),
                                   "--out_dir", str(out), "--cuda_id",
                                   str(dev.index or 0)])
    gen = torch.Generator().manual_seed(seed)
    n_cat, w = input_geometry(config, "snv")
    cat = torch.randint(0, 4 ** config["local_order"] + 1, (BATCH, n_cat),
                        generator=gen).to(dev)
    distal = one_hot_from_codes(random_codes(gen, BATCH, w, dev))
    outs = []
    for d in (ref, out):
        m, _, _ = load_zoo_checkpoint(str(d))
        with torch.no_grad():
            outs.append(m.to(dev)(cat, distal))
    diff = float((outs[0] - outs[1]).abs().max())
    blob = (out / "model.fdiri_cal.pkl").read_bytes() if (
        out / "model.fdiri_cal.pkl").exists() else b""
    check_all("mural_snv convert of a reference-layout triple", {
        "exit code 0": rc == 0,
        "the triple written": all((out / f).exists() for f in (
            "model", "model.config.pkl", "model.fdiri_cal.pkl")),
        "the calibrator re-pickled onto mural_tpu_torch classes":
            b"mural_tpu_torch" in blob and b"dirichletcal" not in blob,
        f"forward at B={BATCH} on the card bit-identical": diff == 0.0,
    })
    log(f"convert: {seconds:.3f} s; forward max |diff| {diff}")
    return {"seconds": seconds, "max_abs_diff": diff}


def phase_search(work, fasta, search_bed, cuda_id, seed):
    """The trial search through ``mural_snv train``: ASHA over four
    trials in threads, ``--n_parallel 2`` on the one card, two trials in
    spawned processes, and ``--rerun_failed`` of a planted error."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    from mural_tpu_torch.train.early_stopping import EarlyStopping
    from mural_tpu_torch.tune.asha import ASHAScheduler
    from mural_tpu_torch.tune.runner import AFTER_MIN_LOSS_STOP
    out = {}

    # ASHA over four trials (threads, the fused stem)
    with watched_runner(seed):
        run = cli_train(cli, work, fasta, search_bed, "search", cuda_id, [
            "--use_ray", "--n_trials", str(SEARCH_TRIALS), "--epochs",
            str(SEARCH_EPOCHS), "--grace_period", "1", "--learning_rate",
            "1e-4", "1e-2", "--fused_stem", "on"])
    exp = work / "results" / "search"
    trials = run["trials"]
    # a trial's last epoch logs no epoch line when EarlyStopping (its
    # patience is the grace period) ends it: count the epochs by their
    # metrics files.  The epoch tail runs on a thread while the next
    # epoch trains, so a stop that it reports may come after that epoch
    # started, which then trains and validates without a checkpoint:
    # count the epochs trained by the log's learning-rate lines, each
    # with the steps and batches of the first
    ran = {name: len([d for d in os.listdir(exp / name)
                      if d.startswith("checkpoint_")]) for name in trials}
    trained = {name: (exp / name / "training.log").read_text().count(
        "optimizer learning rate:") for name in trials}
    steps = sum(trained[t] * e[0]["train_steps"]
                for t, e in trials.items())
    vbatches = sum(trained[t] * e[0]["valid_batches"]
                   for t, e in trials.items())
    # the stops these losses owe the runner's rules, replayed in launch
    # order (the trials ran one after another): after_min_loss, then
    # ASHA, then EarlyStopping
    asha = ASHAScheduler(max_t=SEARCH_EPOCHS, grace_period=1)
    want, rung_stops = {}, {}
    for name in sorted(trials, key=lambda d: d.rsplit("_", 1)[-1]):
        es = EarlyStopping(patience=1, trace_func=lambda *a: None)
        for epoch in range(SEARCH_EPOCHS):
            m = {k: float(v) for k, v in metrics_of(exp / name,
                                                    epoch).items()}
            if not m:
                break
            want[name] = epoch + 1
            keep = m["after_min_loss"] < AFTER_MIN_LOSS_STOP
            if keep and not asha.on_report(name, epoch + 1, m):
                keep, rung_stops[name] = False, epoch + 1
            es(m["loss"])
            if not keep or es.early_stop:
                break
    table = [line for line in run["lines"] if line.startswith("| Train_")]
    best = (exp / "best_models.txt").read_text().splitlines() if (
        exp / "best_models.txt").exists() else []
    check_all("train --use_ray (ASHA, threads)", {
        "exit code 0": run["rc"] == 0,
        f"{SEARCH_TRIALS} trial directories": run["n_trials"]
        == SEARCH_TRIALS,
        "every trial stopped where the runner's rules say (after_min_loss, "
        "ASHA, EarlyStopping)":
            ran == want,
        "at least one trial stopped at a rung": bool(rung_stops),
        "no trial trained more than one epoch past its last checkpoint":
            all(0 <= trained[t] - ran[t] <= 1 for t in trials),
        "the progress table printed with every trial": len(
            {row.split()[1] for row in table}) == SEARCH_TRIALS,
        f"best_models.txt lists {SEARCH_TRIALS} checkpoints":
            len(best) == SEARCH_TRIALS,
        f"K2 launched 2 x ({steps} train steps + {vbatches} validation "
        f"batches) over all trials": run["k2"] == 2 * (steps + vbatches),
        f"K3 launched 2 x {steps} train steps": run["k3"] == 2 * steps,
    })
    out["asha"] = {"seconds": run["seconds"], "k2": run["k2"],
                   "k3": run["k3"], "trials": {
                       name: {"epochs": ran[name],
                              "epochs_trained": trained[name],
                              "stopped_at_rung":
                              rung_stops.get(name),
                              "learning_rate": saved_config(
                                  exp / name / "checkpoint_0" / "model"
                              ).get("learning_rate")}
                       for name in trials}}
    log(f"search (ASHA, {SEARCH_TRIALS} trials, max {SEARCH_EPOCHS} "
        f"epochs): {run['seconds']:.3f} s wall; " + json.dumps(
            out["asha"]["trials"]))

    # --n_parallel 2 on one card: one trial at a time; then a planted
    # error.txt and --rerun_failed
    with watched_runner(seed) as seen:
        par = cli_train(cli, work, fasta, search_bed, "parallel", cuda_id,
                        ["--n_trials", "2", "--epochs", "1",
                         "--n_parallel", "2"])
        planted = sorted(par["trials"])[0]
        (work / "results" / "parallel" / planted / "error.txt").write_text(
            "planted\n")
        first = list(seen["trials"])
        rerun = cli_train(cli, work, fasta, search_bed, "parallel",
                          cuda_id, ["--n_trials", "2", "--epochs", "1",
                                    "--rerun_failed"])
    again = seen["trials"][len(first):]
    check_all("train --n_parallel 2, then --rerun_failed", {
        "exit codes 0": par["rc"] == 0 and rerun["rc"] == 0,
        "two trials, one at a time on the one card": len(first) == 2
        and max(n for _, n, _ in first) == 1,
        "--rerun_failed re-ran only the planted trial":
            [t for t, _, _ in again] == [planted],
        "no error.txt left": not any(
            (work / "results" / "parallel" / t / "error.txt").exists()
            for t in par["trials"]),
    })
    out["n_parallel_s"], out["rerun_s"] = par["seconds"], rerun["seconds"]
    log(f"--n_parallel 2: {par['seconds']:.3f} s for 2 trials; "
        f"--rerun_failed: {rerun['seconds']:.3f} s for 1")

    # two trials in spawned processes, on the card with the fused stem
    with watched_runner(seed) as seen:
        proc = cli_train(cli, work, fasta, search_bed, "process", cuda_id,
                         ["--n_trials", "2", "--epochs", "1",
                          "--trial_executor", "process", "--fused_stem",
                          "on"])
    pexp = work / "results" / "process"
    startup = {}
    for name in proc["trials"]:
        text = (pexp / name / "training.log").read_text()
        m = re.search(r"training finished, total time ([\d.]+)s", text)
        if m and name in seen["process_s"]:
            startup[name] = seen["process_s"][name] - float(m[1])
    check_all("train --trial_executor process", {
        "exit code 0, two trials": proc["rc"] == 0
        and proc["n_trials"] == 2,
        "no error.txt": not any((pexp / t / "error.txt").exists()
                                for t in proc["trials"]),
        # the regional score needs more validation sites than this set's
        "each child trained on the card with the fused stem (finite "
        "loss and fdiri_loss)": all(
            "fused train stem: on" in (pexp / t / "training.log").read_text()
            and finite_metrics(pexp / t, 0, ("loss", "fdiri_loss"))
            for t in proc["trials"]),
        "no trial ran in this process": not seen["trials"],
    })
    out["process"] = {"seconds": proc["seconds"], "startup_s": startup,
                      "epochs": proc["trials"]}
    log("--trial_executor process: "
        f"{proc['seconds']:.3f} s for 2 trials; each child's start-up "
        "before train_trial (spawn, imports, CUDA init) in s: "
        + json.dumps(startup))
    return out


def phase_transfer_search(work, fasta, bed, train_bed, indel_train_bed,
                          snv_model, indel_model, dev, seed):
    """Phase 11: transfer, convert and the trial search."""
    family_bed = write_family_bed(work, train_bed)
    search_bed = write_family_bed(work, family_bed, "search.bed")
    cuda_id = dev.index or 0
    return {
        "transfer": phase_transfer(work, fasta, bed, family_bed, snv_model,
                                   cuda_id),
        "indel_transfer": phase_indel_transfer(work, fasta, indel_train_bed,
                                               indel_model, cuda_id),
        "convert": phase_convert(work, snv_model, dev, seed),
        "search": phase_search(work, fasta, search_bed, cuda_id, seed)}


# --- phase 12: genome-wide predict ----------------------------------------

GW_CHROM = "chr2"       # the synthetic genome's 1 Mb chromosome
GW_BED_SITES = 20_000   # genome-wide sites re-predicted from a BED
GW_EDGE_SITES = 100     # of which at each end of the chromosome
INDEL_GENOME = 200_000  # bases of the INDEL phase's own chromosome
INDEL_BED_SITES = 5_000
TOL_PRINTED = 1.1e-3    # one unit in the 4th digit of %.4g, relative


def read_genome_tsv(path):
    """(decompressed bytes, header, columns) of a prediction TSV; the
    columns as numpy arrays (start int64, strand and mut_type strings,
    probs float64 (n, n_class))."""
    with gzip.open(path, "rb") as fh:
        raw = fh.read()
    lines = raw.decode().split("\n")
    header = lines[0].split("\t")
    rows = [line.split("\t") for line in lines[1:] if line]
    cols = list(zip(*rows)) or [()] * len(header)
    return raw, header, {
        "chrom": np.asarray(cols[0], dtype=str),
        "start": np.asarray(cols[1], dtype=np.int64),
        "strand": np.asarray(cols[3], dtype=str),
        "mut_type": np.asarray(cols[4], dtype=str),
        "probs": np.asarray(cols[5:], dtype=np.float64).T}


def within_printed(a, b) -> bool:
    """Every value of ``a`` within ``%.4g``'s rounding of ``b``'s."""
    return bool(a.shape == b.shape and np.all(
        np.abs(a - b) <= TOL_PRINTED * np.maximum(np.abs(a), np.abs(b))))


_GW_RATE = re.compile(r"genome-wide predict: ([\d,]+) sites in ([\d.]+)s = "
                      r"([\d,]+) sites/s \((\d+) postprocess workers")
_GW_PHASE = re.compile(r"^  (\S.*?)\s+([\d.]+)s$")


def cli_genome(cli, argv, out):
    """One ``predict_genome`` through the CLI with K1-K4 counted from 0
    just before it; returns its run record with the printed phase table,
    the printed rate and the TSV."""
    import torch
    from mural_tpu_torch.ops import window_one_hot as wo
    argv = ["predict_genome", *argv, "--pred_file", out, "--pred_time_view"]
    torch.cuda.synchronize()
    (rc, seconds, lines), launches = counted(run_cli, cli, argv)
    torch.cuda.synchronize()
    k4_launches = wo.LAUNCHES
    rate = next((m for m in map(_GW_RATE.search, lines) if m), None)
    start = next((i for i, line in enumerate(lines)
                  if line == "predict_genome phase timing:"), len(lines))
    phases = {m[1]: float(m[2]) for m in map(_GW_PHASE.match,
                                              lines[start + 1:]) if m}
    return {"rc": rc, "seconds": seconds, "launches": launches,
            "k4_launches": k4_launches,
            "phases": phases, "tsv": read_genome_tsv(out),
            "printed_sites": rate and int(rate[1].replace(",", "")),
            "printed_sites_per_s": rate and int(rate[3].replace(",", "")),
            "workers": rate and int(rate[4])}


def bed_of(path: Path, chrom: str, starts, strands):
    path.write_text("".join(f"{chrom}\t{p}\t{p + 1}\t.\t0\t{s}\n"
                            for p, s in zip(starts, strands)))
    return str(path)


def phase_genome_snv(work, fasta, model_path, cuda_id, rng):
    """``mural_snv predict_genome`` on the 1 Mb chromosome: fused inline,
    fused with two farm workers, unfused with the automatic worker count;
    then the card's gather against the host's through a BED predict of
    some of its sites."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    from mural_tpu_torch.genome.fasta import Genome
    common = ["--ref_genome", fasta, "--model_path", model_path,
              "--model_config_path", model_path + ".config.pkl",
              "--calibrator_path", model_path + ".fdiri_cal.pkl",
              "--chroms", GW_CHROM, "--focal_base", "A",
              "--cuda_id", str(cuda_id)]
    runs = {}
    for name, extra in (
            ("fused_inline", ["--fused_inference", "--n_workers", "0"]),
            ("fused_workers", ["--fused_inference", "--n_workers", "2"]),
            ("unfused_auto", [])):
        runs[name] = run = cli_genome(cli, common + extra,
                                      str(work / f"gw_{name}.tsv.gz"))
        run["sites_per_s"] = len(run["tsv"][2]["start"]) / run["seconds"]
        log(f"predict_genome {name}: {run['seconds']:.3f} s, "
            f"{run['sites_per_s']:.1f} sites/s ({run['workers']} farm "
            f"workers), K1 launches {run['launches'][0]}; phases "
            + json.dumps(run["phases"]))

    codes = Genome.from_fasta(fasta)[GW_CHROM]
    n_sites = int(np.sum((codes == 0) | (codes == 3)))
    n_batches = math.ceil(n_sites / BATCH)
    inline, workers, unfused = (runs[k]["tsv"] for k in (
        "fused_inline", "fused_workers", "unfused_auto"))
    cols = inline[2]
    probs = cols["probs"]
    check_all("predict_genome (SNV)", {
        "exit codes 0": all(r["rc"] == 0 for r in runs.values()),
        f"{n_sites} rows, the A and T codes of {GW_CHROM}": all(
            len(t[2]["start"]) == n_sites for t in (inline, workers,
                                                    unfused))
        and all(r["printed_sites"] == n_sites for r in runs.values()),
        "TSV schema": all(t[1] == TSV_HEADER for t in (inline, workers,
                                                       unfused)),
        "mut_type 0 in every row": bool(np.all(cols["mut_type"] == "0")),
        "positions ascending": bool(np.all(np.diff(cols["start"]) > 0)),
        "every row's strand matches its base": bool(np.array_equal(
            codes[cols["start"]], np.where(cols["strand"] == "+", 0, 3))),
        "probabilities finite and summing to 1 within 5e-3": bool(
            np.isfinite(probs).all()
            and np.abs(probs.sum(1) - 1).max() <= 5e-3),
        "2 farm workers write the inline bytes": inline[0] == workers[0],
        "fused and unfused rows equal": bool(
            np.array_equal(cols["start"], unfused[2]["start"])
            and np.array_equal(cols["strand"], unfused[2]["strand"])),
        "fused and unfused agree within %.4g": within_printed(
            probs, unfused[2]["probs"]),
        f"K1 launched 2 x {n_batches} batches in each fused run": all(
            runs[k]["launches"] == (2 * n_batches, 0, 0)
            for k in ("fused_inline", "fused_workers")),
        "no K1 launch unfused": runs["unfused_auto"]["launches"] == (0, 0,
                                                                     0),
        f"K4 launched once a batch unfused ({n_batches}), never fused":
            runs["unfused_auto"]["k4_launches"] == n_batches and all(
                runs[k]["k4_launches"] == 0
                for k in ("fused_inline", "fused_workers")),
    })

    # the card's gather against the host's: a BED of sites at both ends
    # of the chromosome and at random, predicted with the host gather
    n = len(cols["start"])
    pick = np.sort(np.concatenate([
        np.arange(GW_EDGE_SITES), np.arange(n - GW_EDGE_SITES, n),
        rng.choice(np.arange(GW_EDGE_SITES, n - GW_EDGE_SITES),
                   GW_BED_SITES - 2 * GW_EDGE_SITES, replace=False)]))
    bed = bed_of(work / "gw_sites.bed", GW_CHROM, cols["start"][pick],
                 cols["strand"][pick])
    pred = cli_predict(cli, [
        "--ref_genome", fasta, "--test_data", bed,
        "--model_path", model_path,
        "--model_config_path", model_path + ".config.pkl",
        "--calibrator_path", model_path + ".fdiri_cal.pkl",
        "--pred_batch_size", str(BATCH), "--cuda_id", str(cuda_id),
        "--fused_inference"], str(work / "gw_bed_pred.tsv.gz"))
    _, keys, bed_probs = pred["tsv"]
    check_all("predict_genome against predict on a BED of its sites", {
        "exit code 0": pred["rc"] == 0,
        f"{len(pick)} rows, the same sites": [int(k[1]) for k in keys]
        == cols["start"][pick].tolist()
        and [k[3] for k in keys] == cols["strand"][pick].tolist(),
        "probabilities agree within %.4g": within_printed(
            bed_probs, probs[pick]),
    })
    return runs, {"sites": len(pick), "seconds": pred["seconds"],
                  "launches": pred["launches"]}, n_sites


def write_indel_genome(work: Path, rng: np.random.Generator):
    """The INDEL phase's own one-chromosome FASTA (``INDEL_GENOME``
    bases, 0.1% N), so the other phases' data do not change."""
    from mural_tpu_torch.genome.fasta import decode_sequence
    codes = rng.integers(0, 4, size=INDEL_GENOME).astype(np.uint8)
    codes[rng.integers(0, INDEL_GENOME, size=INDEL_GENOME // 1000)] = 14
    path = work / "indel_genome.fa"
    path.write_text(f">chrI\n{decode_sequence(codes)}\n")
    return str(path)


def phase_genome_indel(work, indel_path, cuda_id, rng):
    """``mural_indel predict_genome --pred_batch_size 1024`` (every
    position, '+') on its own chromosome, and ``predict`` of a BED of some
    of its sites."""
    from mural_tpu_torch.cli.mural_indel import main as cli
    fasta = write_indel_genome(work, rng)
    triple = ["--model_path", indel_path,
              "--model_config_path", indel_path + ".config.pkl",
              "--calibrator_path", indel_path + ".fdiri_cal.pkl",
              "--pred_batch_size", str(INDEL_PRED_BATCH),
              "--cuda_id", str(cuda_id)]
    run = cli_genome(cli, ["--ref_genome", fasta, *triple],
                     str(work / "gw_indel.tsv.gz"))
    run["sites_per_s"] = len(run["tsv"][2]["start"]) / run["seconds"]
    log(f"predict_genome INDEL: {run['seconds']:.3f} s, "
        f"{run['sites_per_s']:.1f} sites/s ({run['workers']} farm "
        f"workers); phases " + json.dumps(run["phases"]))
    _, header, cols = run["tsv"]
    probs = cols["probs"]
    pick = np.sort(rng.choice(INDEL_GENOME, INDEL_BED_SITES, replace=False))
    bed = bed_of(work / "gw_indel.bed", "chrI", pick, ["+"] * len(pick))
    pred = cli_predict(cli, ["--ref_genome", fasta, "--test_data", bed,
                             *triple], str(work / "gw_indel_bed.tsv.gz"))
    _, keys, bed_probs = pred["tsv"]
    check_all("predict_genome (INDEL)", {
        "exit codes 0": run["rc"] == 0 and pred["rc"] == 0,
        "TSV schema with prob0..prob7": header == INDEL_TSV_HEADER,
        f"{INDEL_GENOME} rows, every position on '+'": bool(
            np.array_equal(cols["start"], np.arange(INDEL_GENOME))
            and np.all(cols["strand"] == "+")),
        # Poisson calibration (always on for INDEL) keeps the sum at 1;
        # each printed value is within 5e-4 of itself
        "probabilities finite and summing to 1 within %.4g": bool(
            np.isfinite(probs).all()
            and np.all(np.abs(probs.sum(1) - 1)
                       <= 5e-4 * np.abs(probs).sum(1) + 1e-6)),
        "K1, K2 and K3 launched 0 times": run["launches"] == (0, 0, 0),
        f"K4 launched once a batch ({-(-INDEL_GENOME // INDEL_PRED_BATCH)})":
            run["k4_launches"] == -(-INDEL_GENOME // INDEL_PRED_BATCH),
        f"predict of a BED of {INDEL_BED_SITES} of its sites agrees "
        "within %.4g": [int(k[1]) for k in keys] == pick.tolist()
        and within_printed(bed_probs, probs[pick]),
    })
    return run


def phase_genome_wide(work, fasta, model_path, indel_path, dev, seed):
    """Phase 12: genome-wide predict, SNV and INDEL."""
    rng = np.random.default_rng(seed + 12)
    cuda_id = dev.index or 0
    snv, bed, n_sites = phase_genome_snv(work, fasta, model_path, cuda_id,
                                         rng)
    indel = phase_genome_indel(work, indel_path, cuda_id, rng)

    def record(run, sites):
        return {"sites": sites, "seconds": run["seconds"],
                "sites_per_s": run["sites_per_s"],
                "printed_sites_per_s": run["printed_sites_per_s"],
                "workers": run["workers"], "phases": run["phases"],
                "k1_launches": run["launches"][0],
                "k4_launches": run["k4_launches"]}

    out = {name: record(run, n_sites) for name, run in snv.items()}
    out["indel"] = dict(record(indel, INDEL_GENOME),
                        k1_k2_k3_launches=indel["launches"])
    out["bed_check"] = dict(bed, k1_launches=bed.pop("launches"))
    return out


# --- phase 13: the device-fed train loop ---------------------------------

FED_K = 8               # train steps per CUDA graph replay (the SNV default)
FED_SEGMENTS = 10       # --sampled_segments' default
PROFILED_STEPS = 16     # steps of each run's torch.profiler window
FED_LR = 1e-3           # --learning_rate's default
# (name, feed, fused stem, K, epochs) of the timed SNV runs, from the
# loop before this slice to resident data with K steps per replay; runs
# that capture a graph take a second epoch, which times the replays alone
FED_RUNS = (("host_inline", "inline", True, 1, 1),
            ("host_prefetch", "prefetch", True, 1, 1),
            ("host_graphs", "prefetch", True, FED_K, 2),
            ("resident", "resident", True, 1, 1),
            ("resident_graphs", "resident", True, FED_K, 2),
            ("resident_graphs_unfused", "resident", False, FED_K, 2))
# eager steps of GraphOptimizer against torch's Adam: the two round the
# update differently on the card, and Adam's dynamics amplify one
# rounding apart several-fold a step, so the card holds the first two
# updates; the CPU tests hold 20 steps of every optimizer bit for bit
FED_OPT_STEPS = 3


def fed_dataset(bed, fasta, cfg, model_type):
    from mural_tpu_torch.data.dataset import prepare_dataset
    return prepare_dataset(bed, fasta, central_bp=cfg["segment_center"],
                           local_radius=cfg["local_radius"],
                           local_order=cfg["local_order"],
                           distal_radius=cfg["distal_radius"],
                           model_type=model_type)


def fed_epoch(feed, state, ds, res, fused, dev, rng, groups, limit=None):
    """One epoch's train steps (the first ``limit`` of them) fed one way;
    returns the per-step losses on the device.  ``inline`` is the loop
    before this slice: each batch built and uploaded between eager steps
    of torch's optimizer at a float LR (``train_step``); ``prefetch`` is
    the host-fed loop and ``resident`` the device-resident one, both in
    ``groups`` of K (GraphOptimizer; one CUDA graph replay per group when
    K > 1)."""
    import itertools

    import torch
    from mural_tpu_torch.data.batcher import segment_pool_batches
    from mural_tpu_torch.data.prefetch import (prefetch, prefetch_stacked,
                                               stacked_inputs)
    from mural_tpu_torch.device import to_device
    from mural_tpu_torch.train.graphs import epoch_scalars
    from mural_tpu_torch.train.resident import (resident_epoch,
                                                stack_epoch_rows,
                                                upload_rows)
    from mural_tpu_torch.train.steps import model_input, train_step
    B = TRAIN_BATCH
    if feed == "resident":
        rows_np, _, _ = stack_epoch_rows(ds, FED_SEGMENTS, B, True, rng)
        rows = upload_rows(rows_np[:limit], dev)
        return resident_epoch(groups, rows, to_device(
            epoch_scalars(state, len(rows)), dev))
    batches = itertools.islice(segment_pool_batches(
        ds, FED_SEGMENTS, B, shuffle=True, rng=rng), limit)
    losses = []
    if feed == "inline":
        mask = torch.ones(B, device=dev)
        for b in batches:
            losses.append(train_step(
                state, to_device(b.y, dev).long(),
                to_device(b.cat, dev).long(),
                model_input(to_device(b.distal, dev), fused), mask)[0])
        return torch.stack(losses)
    n = ds.n_sites // B if limit is None else limit
    scalars = to_device(epoch_scalars(state, n), dev)
    done = 0
    for db in (prefetch(batches, dev) if groups.k == 1
               else prefetch_stacked(batches, groups.k, dev)):
        inputs = stacked_inputs(db)
        k = inputs[0].shape[0]
        losses.append(groups.run(scalars[done:done + k], inputs))
        done += k
    return torch.cat(losses)


def fed_run(feed, fused, k, model, ds, res, dev, seed, epochs, limit=None,
            profile=True, bf16=False):
    """``epochs`` epochs (of ``limit`` steps) of a fresh copy of ``model``
    (Adam, StepLR2, the CLI's weight decay; ``bf16``: mixed precision)
    fed one way: per-step losses, final parameters, each epoch's seconds
    and windows/s, K2/K3 launches of each mode counted from 0 (replays
    included), then with ``profile`` the device's busy ms per step over
    ``PROFILED_STEPS`` more steps (torch.profiler) against the last
    epoch's step ms."""
    import torch
    from mural_tpu_torch.ops import fused_train_stem as fts
    from mural_tpu_torch.train.graphs import StepGroups, host_fed_batch
    from mural_tpu_torch.train.optim import (GraphOptimizer, LRSchedule,
                                             auto_weight_decay,
                                             build_optimizer)
    from mural_tpu_torch.train.resident import resident_batch
    from mural_tpu_torch.train.steps import TrainState
    B = TRAIN_BATCH
    model = copy.deepcopy(model).to(dev)
    # the weight decay of a two-epoch CLI run, whatever this run's epochs
    wd = auto_weight_decay(0.1, B, 2, ds.n_sites, 1e-5)
    state = TrainState(model, (build_optimizer if feed == "inline"
                               else GraphOptimizer)(
        "Adam", model.parameters(), wd),
        LRSchedule.build("StepLR2", FED_LR, 0.9, B, ds.n_sites, 1e-4, 1e-6),
        bf16=bf16)
    groups = None
    if feed != "inline":
        groups = StepGroups(state, k, resident_batch(
            res, fused, torch.ones(B, device=dev)) if feed == "resident"
            else host_fed_batch(fused))
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)                # the dropout masks' stream
    out = {"losses": [], "epoch_s": [], "steps": []}
    fts.reset_launches()
    for _ in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = fed_epoch(feed, state, ds, res, fused, dev, rng, groups,
                           limit)
        torch.cuda.synchronize()
        out["epoch_s"].append(time.perf_counter() - t0)
        out["steps"].append(len(losses))
        out["losses"] += losses.tolist()
        state.epoch += 1
    out.update(fts.launch_counts())
    out["params"] = [p.detach().clone() for p in model.parameters()]
    out["windows_per_s"] = [n * B / s for n, s in zip(out["steps"],
                                                      out["epoch_s"])]
    out["step_ms"] = out["epoch_s"][-1] / out["steps"][-1] * 1e3
    if profile:
        busy = device_busy_ms(lambda: fed_epoch(
            feed, state, ds, res, fused, dev,
            np.random.default_rng(seed + 1), groups,
            PROFILED_STEPS)) / PROFILED_STEPS
        out["device_busy_ms"] = busy
        out["device_busy_share"] = busy / out["step_ms"] if busy else None
    return out


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms while the block runs.  Its default
    weight-gradient algorithms sum in a varying order, and the training
    dynamics amplify one rounding apart to loss differences far above
    1e-4 within an epoch (phase 13 logs how far its timed runs drift), so
    runs that must agree step for step run deterministic."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def rel_l2(a, b) -> float:
    """Relative L2 distance of two parameter lists, over all parameters."""
    num = sum(float((x - y).double().pow(2).sum()) for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return math.sqrt(num / den)


def phase_profile_dir(work, fasta, bed, cuda_id):
    """``train --profile_dir`` through the CLI on every tenth site of
    ``bed`` (2,000 over the whole genome): the trace file and its device
    (kernel) events, K2 among them."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    small = work / "profiled.bed"
    small.write_text("\n".join(Path(bed).read_text().splitlines()[::10])
                     + "\n")
    prof = work / "prof"
    run = cli_train(cli, work, fasta, str(small), "profiled", cuda_id,
                    ["--fused_stem", "on", "--epochs", "1",
                     "--profile_dir", str(prof)])
    trace = prof / "train_epoch0.pt.trace.json"
    events = (json.loads(trace.read_text())["traceEvents"]
              if trace.exists() else [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {"rc": run["rc"], "trace_events": len(events),
           "kernel_events": len(kernels),
           "k2_events": sum("code_conv_pool" in e.get("name", "")
                            for e in kernels)}
    log("train --profile_dir: " + json.dumps(out))
    check_all("train --profile_dir", {
        "exit code 0": run["rc"] == 0,
        "'profiler trace written to' printed": any(
            "profiler trace written to" in line for line in run["lines"]),
        "the trace holds device events": out["kernel_events"] > 0,
        "K2 among them": out["k2_events"] > 0,
    })
    return out


def phase_device_fed(work, fasta, family_bed, indel_bed, dev, seed):
    """Phase 13: the device-fed train loop, SNVNet2 at the CLI default
    widths (dropout 0, ``--lr_scheduler StepLR2``) on phase 10's 20,000
    training sites, each feed timed; resident + K=8 graphs held against
    host-fed eager steps and GraphOptimizer against torch's Adam, with
    deterministic cuDNN; the INDEL U-Net at its defaults, one resident
    epoch against one host-fed; ``--profile_dir``."""
    import torch
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.registry import build_model_from_config
    from mural_tpu_torch.train.resident import make_resident
    cfg = dict(CONFIG, emb_dropout=0.0, local_dropout=0.0,
               distal_fc_dropout=0.0)
    t0 = time.perf_counter()
    ds = fed_dataset(family_bed, fasta, cfg, "snv")
    res = make_resident(ds, dev)
    model = init_weights(build_model_from_config(cfg, 0, "snv"),
                         torch.Generator().manual_seed(seed + 13))
    dropout_model = init_weights(build_model_from_config(CONFIG, 0, "snv"),
                                 torch.Generator().manual_seed(seed + 13))
    part_s = {"setup": time.perf_counter() - t0}
    t0 = time.perf_counter()
    runs = {name: fed_run(feed, fused, k, model, ds, res, dev, seed, epochs)
            for name, feed, fused, k, epochs in FED_RUNS}
    part_s["snv_runs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = {name: {key: run[key] for key in (
        "steps", "epoch_s", "windows_per_s", "step_ms", "device_busy_ms",
        "device_busy_share", "k2", "k3")} for name, run in runs.items()}
    log(f"device-fed train, SNVNet2 at B={TRAIN_BATCH} on {ds.n_sites} "
        f"sites (busy from torch.profiler over {PROFILED_STEPS} more "
        f"steps): " + json.dumps(table))
    # the comparisons, with deterministic cuDNN: one epoch of the resident
    # 8-step graph path against the host-fed path's eager steps, and
    # GraphOptimizer's eager steps against torch's Adam at float LRs
    with deterministic_cudnn():
        ref = fed_run("prefetch", True, 1, model, ds, res, dev, seed, 1,
                      profile=False)
        fed = fed_run("resident", True, FED_K, model, ds, res, dev, seed, 1,
                      profile=False)
        torch_adam = fed_run("inline", True, 1, model, ds, res, dev, seed,
                             1, FED_OPT_STEPS, profile=False)
        # with the CLI's dropout: do replays draw eager's masks?
        dropped = [fed_run(feed, True, k, dropout_model, ds, res, dev, seed,
                           1, 4 * FED_K, profile=False)["losses"]
                   for feed, k in (("prefetch", 1), ("resident", FED_K))]
    rel = [abs(a - b) / abs(b) for a, b in zip(fed["losses"],
                                              ref["losses"])]
    params_rel = rel_l2(fed["params"], ref["params"])
    opt_rels = [abs(a - b) / abs(b) for a, b in zip(torch_adam["losses"],
                                                   ref["losses"])]
    opt_rel = max(opt_rels)
    dropout_rel = max(abs(a - b) / abs(b) for a, b in zip(*dropped))
    # the timed runs (default cuDNN) drift apart chaotically: recorded
    drift = max(abs(a - b) / abs(b) for a, b in zip(
        runs["resident_graphs"]["losses"], runs["host_prefetch"]["losses"]))
    log(f"resident + {FED_K}-step graphs against host-fed eager steps "
        f"(deterministic cuDNN): max per-step loss rel diff {max(rel):.3g} "
        f"over {len(rel)} steps, parameters' relative L2 distance "
        f"{params_rel:.3g}; GraphOptimizer against torch's Adam, per "
        f"step: {[float(f'{r:.3g}') for r in opt_rels]}; the timed runs "
        f"(default cuDNN) {drift:.3g} apart over their first epoch; with "
        f"the CLI's dropout, {4 * FED_K} steps of 8-step graphs against "
        f"eager steps: {dropout_rel:.3g} (0: the replays draw eager's "
        f"masks)")
    steps = [run["steps"] for run in runs.values()]
    part_s["snv_comparisons"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    indel_cfg = dict(INDEL_CONFIG)
    ids = fed_dataset(indel_bed, fasta, indel_cfg, "indel")
    ires = make_resident(ids, dev)
    imodel = indel_model(seed + 14)
    imodel.out_fc[1].p = 0.0
    indel = {name: fed_run(feed, False, 1, imodel, ids, ires, dev, seed, 1)
             for name, feed in (("host_prefetch", "prefetch"),
                                ("resident", "resident"))}
    with deterministic_cudnn():
        icmp = [fed_run(feed, False, 1, imodel, ids, ires, dev, seed, 1,
                        PROFILED_STEPS, profile=False)["losses"]
                for feed in ("prefetch", "resident")]
    irel = max(abs(a - b) / abs(b) for a, b in zip(*icmp))
    itable = {name: {key: run[key] for key in (
        "steps", "epoch_s", "windows_per_s", "step_ms", "device_busy_ms",
        "device_busy_share")} for name, run in indel.items()}
    log(f"device-fed train, INDEL U-Net at B={TRAIN_BATCH} on {ids.n_sites}"
        f" sites (one epoch): " + json.dumps(itable) + f"; resident "
        f"against host-fed over {PROFILED_STEPS} steps (deterministic "
        f"cuDNN): max per-step loss rel diff {irel:.3g}")
    part_s["indel"] = time.perf_counter() - t0
    fused_steps = sum(runs["resident_graphs"]["steps"])
    check_all("device-fed train", {
        "finite losses in every run": all(
            np.isfinite(run["losses"]).all()
            for run in (*runs.values(), *indel.values(), fed, ref)),
        "every SNV run took the same steps per epoch": len(
            {s[0] for s in steps}) == 1,
        f"resident + {FED_K}-step graphs against host-fed eager per-step "
        f"loss within {TOL_STEP}": max(rel) <= TOL_STEP,
        f"final parameters within {TOL_STEP} (relative L2)":
            params_rel <= TOL_STEP,
        f"GraphOptimizer against torch's Adam per-step loss within "
        f"{TOL_STEP}": opt_rel <= TOL_STEP,
        "K2 and K3 launched twice per step in every fused run (replays "
        "included)": all(
            run["k2"] == run["k3"] == 2 * sum(run["steps"])
            for name, run in runs.items()
            if name != "resident_graphs_unfused"),
        f"{2 * fused_steps} K2 and K3 launches on the resident graph run":
            runs["resident_graphs"]["k2"] == 2 * fused_steps,
        "no K2/K3 launch unfused": runs["resident_graphs_unfused"]["k2"]
        == runs["resident_graphs_unfused"]["k3"] == 0,
        f"INDEL resident against host-fed per-step loss within {TOL_STEP}":
            irel <= TOL_STEP,
    })
    t0 = time.perf_counter()
    profiled = phase_profile_dir(work, fasta, family_bed, dev.index or 0)
    part_s["profile_dir"] = time.perf_counter() - t0
    log("phase 13 seconds by part: " + json.dumps(part_s))
    return {"part_s": part_s, "snv": table, "indel": itable,
            "loss_rel_diff": max(rel), "params_rel_l2": params_rel,
            "optimizer_rel_diff": opt_rel, "timed_runs_drift": drift,
            "dropout_graphs_rel_diff": dropout_rel,
            "indel_loss_rel_diff": irel, "profile_dir": profiled}


# --- phase 15: mixed precision and trial ensembles -----------------------

TOL_BF16 = 2e-2         # bf16 against float32 loss: the JAX package's band
BF16_STEPS = 64         # steps of the bf16 against float32 comparison
# the JAX package holds bf16 steps to float32 per step over 8 steps
# (tests/test_bf16.py); over longer runs the two trajectories drift apart
# per step (both packages, tests/test_torch_port_bf16.py), so the later
# steps are held by the mean of each window of 8
BF16_WINDOW = 8
ENS_TRIALS = 4          # trials of each ensemble run
ENS_EPOCHS = 2
# (name, fused stem, bf16) of the timed SNVNet2 runs: resident, K steps
# per replay, two epochs (the second times the replays alone)
BF16_RUNS = (("f32_fused", True, False), ("bf16_fused", True, True),
             ("f32_unfused", False, False), ("bf16_unfused", False, True))
_ENS_RATE = re.compile(r"ensemble epoch (\d+): (\d+)/(\d+) members live, "
                       r"train (\d+) steps in ([\d.]+)s \((\d+) windows/s")


def phase_bf16_steps(ds, res, model, ids, ires, imodel, dev, seed):
    """SNVNet2 at the CLI widths (dropout 0) resident with K-step graphs,
    float32 against bf16, fused and unfused: windows/s, busy share and
    the launches of each kernel mode; 64 steps of bf16 against float32
    (deterministic cuDNN); the INDEL U-Net at its defaults, one resident
    epoch float32 against bf16."""
    runs = {name: fed_run("resident", fused, FED_K, model, ds, res, dev,
                          seed, 2, bf16=bf16)
            for name, fused, bf16 in BF16_RUNS}
    keys = ("steps", "epoch_s", "windows_per_s", "step_ms",
            "device_busy_ms", "device_busy_share", "k2", "k3", "k2_bf16",
            "k3_bf16")
    table = {name: {key: run[key] for key in keys}
             for name, run in runs.items()}
    log(f"bf16 train steps, SNVNet2 at B={TRAIN_BATCH} resident with "
        f"{FED_K}-step graphs on {ds.n_sites} sites: " + json.dumps(table))
    with deterministic_cudnn():
        cmp = {bf16: fed_run("resident", True, FED_K, model, ds, res, dev,
                             seed, 1, BF16_STEPS, profile=False,
                             bf16=bf16)["losses"]
               for bf16 in (False, True)}
    rels = [abs(a - b) / abs(b) for a, b in zip(cmp[True], cmp[False])]
    rel = max(rels)
    w = BF16_WINDOW
    windows = [abs(sum(cmp[True][i:i + w]) / sum(cmp[False][i:i + w]) - 1)
               for i in range(0, len(rels), w)]
    log(f"bf16 against float32, {BF16_STEPS} fused resident steps "
        f"(deterministic cuDNN): max per-step loss rel diff {rel:.3g}, "
        f"{max(rels[:w]):.3g} over the first {w}; mean of each {w}-step "
        f"window: {[float(f'{x:.3g}') for x in windows]}")
    indel = {name: fed_run("resident", False, 1, imodel, ids, ires, dev,
                           seed, 1, bf16=bf16)
             for name, bf16 in (("f32", False), ("bf16", True))}
    itable = {name: {key: run[key] for key in keys[:6]}
              for name, run in indel.items()}
    log(f"bf16 train steps, INDEL U-Net at B={TRAIN_BATCH} resident on "
        f"{ids.n_sites} sites (one epoch): " + json.dumps(itable))
    steps = {name: sum(run["steps"]) for name, run in runs.items()}
    check_all("bf16 train steps", {
        "finite losses in every run": all(
            np.isfinite(run["losses"]).all()
            for run in (*runs.values(), *indel.values())),
        f"bf16 within {TOL_BF16} of float32 per step over the first "
        f"{BF16_WINDOW} steps": max(rels[:BF16_WINDOW]) <= TOL_BF16,
        f"and in the mean of each {BF16_WINDOW}-step window of "
        f"{BF16_STEPS}": len(rels) == BF16_STEPS
        and max(windows) <= TOL_BF16,
        "K2/K3 bf16 mode launched twice per step in the bf16 fused run "
        "(replays included), the float32 mode never": (
            runs["bf16_fused"]["k2_bf16"] == runs["bf16_fused"]["k3_bf16"]
            == 2 * steps["bf16_fused"]
            and runs["bf16_fused"]["k2"] == runs["bf16_fused"]["k3"] == 0),
        "the float32 fused run launched the float32 mode only": (
            runs["f32_fused"]["k2"] == runs["f32_fused"]["k3"]
            == 2 * steps["f32_fused"]
            and runs["f32_fused"]["k2_bf16"] == 0),
        "no K2/K3 launch unfused": not any(
            runs[name][k] for name in ("f32_unfused", "bf16_unfused")
            for k in ("k2", "k3", "k2_bf16", "k3_bf16")),
    })
    return {"snv": table, "bf16_vs_f32_rel_diff": rel,
            "bf16_vs_f32_window_rel_diff": windows, "indel": itable}


def phase_bf16_cli(work, fasta, family_bed, indel_train_bed, cuda_id):
    """``mural_snv train --bf16 --fused_stem on --epochs 1`` (the bf16
    main path: K2/K3 in the bf16 mode per train step, K2 in the float32
    mode per validation batch) and ``mural_indel train --bf16 --epochs
    1`` through the CLI."""
    from mural_tpu_torch.cli.mural_indel import main as indel_cli
    from mural_tpu_torch.cli.mural_snv import main as snv_cli
    from mural_tpu_torch.ops import fused_train_stem as fts
    out = {}
    for name, cli, bed, extra in (
            ("snv", snv_cli, family_bed, ["--fused_stem", "on"]),
            ("indel", indel_cli, indel_train_bed, ["--use_reverse"])):
        fts.reset_launches()
        run = cli_train(cli, work, fasta, bed, f"bf16_{name}", cuda_id,
                        ["--bf16", "--epochs", "1", *extra])
        counts = fts.launch_counts()
        trial, epochs = run["trial"], run["epochs"]
        steps = sum(e["train_steps"] for e in epochs)
        vbatches = sum(e["valid_batches"] for e in epochs)
        want = ({"k2": 2 * vbatches, "k3": 0, "k2_bf16": 2 * steps,
                 "k3_bf16": 2 * steps} if name == "snv" else
                dict.fromkeys(counts, 0))
        check_all(f"{name} train --bf16", {
            "exit code 0": run["rc"] == 0,
            "the mixed-precision line": any(
                "mixed precision: bfloat16" in line
                for line in run["lines"]),
            "one epoch logged": len(epochs) == 1,
            "checkpoint_0 holds the triple": all(
                (trial / "checkpoint_0" / f).exists()
                for f in ("model", "model.config.pkl",
                          "model.fdiri_cal.pkl")),
            "finite loss, fdiri_loss and score": finite_metrics(trial, 0),
            f"launches {want}": counts == want,
        })
        out[name] = {"seconds": run["seconds"], "epochs": epochs,
                     **counts}
        log(f"{name} train --bf16: {run['seconds']:.3f} s; launches "
            f"{counts}; epochs " + json.dumps(epochs))
    return out


# (name, flags) of the one-epoch `--bf16` runs on every other train path
BF16_PATHS = (
    ("host_eager", ["--resident_data", "off", "--steps_per_dispatch", "1",
                    "--fused_stem", "on"]),
    ("host_graphs", ["--resident_data", "off", "--fused_stem", "on"]),
    ("resident_eager", ["--steps_per_dispatch", "1"]),
    ("m0", ["--model_no", "0"]),
    ("m1_fused", ["--model_no", "1", "--fused_stem", "on"]),
    ("m3_tracks", ["--model_no", "3", "--bw_paths", "TRACKS"]),
    ("process", ["--trial_executor", "process", "--fused_stem", "on"]),
    ("transfer", ["--fused_stem", "on"]))


def phase_bf16_paths(work, fasta, family_bed, snv_model, cuda_id):
    """One ``--bf16`` epoch through the CLI on every tenth site of phase
    10's set (2,000) on each other train path: host-fed eager steps and
    graphs, resident eager steps, SNVNet0, SNVNet1 fused, SNVNet3 with
    track channels (phase 10's tracks), a trial process, and ``transfer``
    from phase 1's triple: the mixed-precision line in the trial's log,
    the triple, a finite loss, and in-process fused runs launching K2/K3
    in the bf16 mode twice per train step."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    from mural_tpu_torch.ops import fused_train_stem as fts
    small = work / "bf16_paths.bed"
    small.write_text("\n".join(
        Path(family_bed).read_text().splitlines()[::10]) + "\n")
    tracks = work / "tracks.txt"
    out = {}
    for name, flags in BF16_PATHS:
        command = "train"
        flags = [str(tracks) if a == "TRACKS" else a for a in flags]
        if name == "transfer":
            command = "transfer"
            flags += ["--model_path", snv_model, "--model_config_path",
                      snv_model + ".config.pkl"]
        fts.reset_launches()
        run = cli_train(cli, work, fasta, str(small), f"bf16_{name}",
                        cuda_id, ["--bf16", "--epochs", "1", *flags],
                        command)
        counts = fts.launch_counts()
        trial = run["trial"]
        log_text = (trial / "training.log").read_text()
        steps = sum(e["train_steps"] for e in run["epochs"])
        checks = {
            "exit code 0": run["rc"] == 0,
            "no error.txt": not (trial / "error.txt").exists(),
            "the mixed-precision line": "mixed precision: bfloat16"
            in log_text,
            "checkpoint_0 holds the triple": all(
                (trial / "checkpoint_0" / f).exists()
                for f in ("model", "model.config.pkl",
                          "model.fdiri_cal.pkl")),
            "finite loss": finite_metrics(trial, 0, ("loss",
                                                     "fdiri_loss")),
        }
        if "--fused_stem" in flags and name != "process":
            checks[f"K2/K3 bf16 mode twice per train step ({steps})"] = (
                counts["k2_bf16"] == counts["k3_bf16"] == 2 * steps > 0)
        check_all(f"train --bf16 ({name})", checks)
        out[name] = {"seconds": run["seconds"], "epochs": run["epochs"],
                     **counts}
    log("train --bf16 on every path: " + json.dumps(
        {k: {"seconds": v["seconds"], "k2_bf16": v["k2_bf16"]}
         for k, v in out.items()}))
    return out


@contextlib.contextmanager
def kept_ensembles():
    """Keep every :class:`EnsembleState` that the runs in the block
    create, to read the members' final weights afterwards."""
    from mural_tpu_torch.train import ensemble
    created = []
    init = ensemble.EnsembleState.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        created.append(self)

    ensemble.EnsembleState.__init__ = record
    try:
        yield created
    finally:
        ensemble.EnsembleState.__init__ = init


def phase_ensembles(work, fasta, family_bed, cuda_id, seed, serial_rate):
    """``train --trial_ensemble auto --n_trials 4 --epochs 2`` on phase
    10's sites at B=128, in float32 and with ``--bf16``: the group lines,
    every trial's files, no K2/K3 launch, the aggregate windows/s against
    the serial resident rate of phase 13; then ``--use_ray --grace_period
    1`` over two learning rates: a member stopped before the last epoch
    keeps the weights of its last checkpoint."""
    import torch
    from mural_tpu_torch.cli.mural_snv import main as cli
    from mural_tpu_torch.ops import fused_train_stem as fts
    out = {}
    runs = (("f32", []), ("bf16", ["--bf16"]),
            ("asha", ["--use_ray", "--grace_period", "1", "--learning_rate",
                      "1e-4", "1e-2"]))
    for name, extra in runs:
        fts.reset_launches()
        with watched_runner(seed), kept_ensembles() as created:
            run = cli_train(cli, work, fasta, family_bed, f"ens_{name}",
                            cuda_id, ["--trial_ensemble", "auto",
                                      "--n_trials", str(ENS_TRIALS),
                                      "--epochs", str(ENS_EPOCHS), *extra])
        exp = work / "results" / f"ens_{name}"
        trials = sorted(run["trials"])
        rates = [m for m in map(_ENS_RATE.search, run["lines"]) if m]
        last = {t: max((int(d.split("_")[1]) for d in os.listdir(exp / t)
                        if d.startswith("checkpoint_")), default=-1)
                for t in trials}
        checks = {
            "exit code 0": run["rc"] == 0,
            f"one group of {ENS_TRIALS}": sum(
                line.startswith(f"trial ensemble: {ENS_TRIALS} members")
                for line in run["lines"]) == 1 and len(created) == 1,
            "the shared arena line": any(
                line.startswith("trial ensemble: shared train arena")
                for line in run["lines"]),
            f"{ENS_TRIALS} trial directories, each with its triple per "
            "epoch run, progress.csv and training.log": len(trials)
            == ENS_TRIALS and all(
                (exp / t / "progress.csv").exists()
                and (exp / t / "training.log").exists() and all(
                    (exp / t / f"checkpoint_{e}" / f).exists()
                    for e in range(last[t] + 1)
                    for f in ("model", "model.config.pkl",
                              "model.fdiri_cal.pkl"))
                for t in trials),
            "finite metrics in every checkpoint": all(
                finite_metrics(exp / t, e) for t in trials
                for e in range(last[t] + 1)),
            "no K2/K3 launch": not any(fts.launch_counts().values()),
        }
        rec = {"seconds": run["seconds"], "last_epoch": last,
               "windows_per_s": [int(m[6]) for m in rates],
               "epoch_train_s": [float(m[5]) for m in rates]}
        if name != "asha":
            checks[f"{ENS_EPOCHS} epochs of every member"] = all(
                v == ENS_EPOCHS - 1 for v in last.values())
            rec["vs_serial"] = rec["windows_per_s"][-1] / serial_rate \
                if rates else None
        else:
            ens = created[0] if created else None
            stopped = [t for t in trials if last[t] < ENS_EPOCHS - 1]
            same = []
            for t in stopped:
                member = ens.member_state_dict(
                    sorted(trials, key=lambda d: d.rsplit("_", 1)[-1])
                    .index(t))
                saved = torch.load(exp / t / f"checkpoint_{last[t]}" /
                                   "model")
                same.append(all(torch.equal(v.cpu(), member[k].cpu())
                                for k, v in saved.items()))
            checks["a member stopped before the last epoch"] = bool(stopped)
            checks["each stopped member's final weights are its last "
                   "checkpoint's"] = bool(same) and all(same)
            rec["stopped"] = stopped
        check_all(f"train --trial_ensemble auto ({name})", checks)
        log(f"trial ensemble {name}: " + json.dumps(rec))
        out[name] = rec
    return out


def phase_mixed_ensembles(work, fasta, family_bed, indel_bed, snv_model,
                          dev, seed, serial_rate):
    """Phase 15: the bf16 mode of K2/K3 is checked with phases 2-3; here
    the bf16 train steps, the CLI runs, ``--bf16`` on every train path
    and the trial ensembles."""
    import torch
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.registry import build_model_from_config
    from mural_tpu_torch.train.resident import make_resident
    part_s = {}
    t0 = time.perf_counter()
    cfg = dict(CONFIG, emb_dropout=0.0, local_dropout=0.0,
               distal_fc_dropout=0.0)
    ds = fed_dataset(family_bed, fasta, cfg, "snv")
    res = make_resident(ds, dev)
    model = init_weights(build_model_from_config(cfg, 0, "snv"),
                         torch.Generator().manual_seed(seed + 15))
    ids = fed_dataset(indel_bed, fasta, dict(INDEL_CONFIG), "indel")
    ires = make_resident(ids, dev)
    imodel = indel_model(seed + 16)
    imodel.out_fc[1].p = 0.0
    steps = phase_bf16_steps(ds, res, model, ids, ires, imodel, dev, seed)
    part_s["steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = phase_bf16_cli(work, fasta, family_bed, indel_bed, dev.index or 0)
    part_s["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = phase_bf16_paths(work, fasta, family_bed, snv_model,
                             dev.index or 0)
    part_s["paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ens = phase_ensembles(work, fasta, family_bed, dev.index or 0, seed,
                          serial_rate)
    part_s["ensembles"] = time.perf_counter() - t0
    log("phase 15 seconds by part: " + json.dumps(part_s))
    return {"part_s": part_s, "steps": steps, "cli": cli, "paths": paths,
            "ensembles": ens}


DP_STEPS = 32           # train steps of phase 16's two-rank checks
DP_INDEL_STEPS = 8      # of which the U-Net's
# the learning rate of the two-rank comparisons: at the CLI's 1e-3 the
# float32 trajectories of two ranks and of one process part chaotically
# (a pool's argmax or an Adam step's sign flips on a rounding), past 1e-4
# by the 7th step on the CPU and on the card, with Adam or SGD; at 1e-4
# they stay within 4e-6 over 32 steps (the CPU rehearsal), as
# tests/test_torch_port_train_trial.py holds its epochs at 1e-4.  The
# CLI rate's drift is recorded, not checked
DP_LR = 1e-4
DP_GRAPH_STEPS = 64     # steps of each one-rank NCCL graph run (8 replays)
TOL_DP_MEAN = 5e-3      # the mean of 32 steps' losses, two ranks vs one
TOL_SHARDED = 1e-5      # sharded logits and loss against one replica
TAIL_EPOCHS = 3         # epochs of the overlapped-tail CLI run


def dp_steps(ctx, fasta, bed, model_type, n_steps, k, seed,
             busy_steps=0, device="cuda:0", lr=FED_LR):
    """``n_steps`` resident train steps (the fused stem for SNV) at the
    CLI widths, dropout 0, Adam and StepLR2 from ``lr``, in groups of
    ``k`` (a CUDA
    graph per group when ``k`` > 1), with deterministic cuDNN, on one
    rank ``ctx`` of a data-parallel group (its rows of each batch, the
    cross-rank BN when the group has two ranks, the gradients summed) or
    alone on ``device`` (``ctx`` None): global per-step losses, the steps' seconds after
    the first group, this process's K2/K3 launches, and with
    ``busy_steps`` the device's busy ms per step over that many more
    steps.  Runs in the ranks that ``spawn_ranks`` starts."""
    import torch
    from mural_tpu_torch.device import to_device
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.registry import build_model_from_config
    from mural_tpu_torch.ops import fused_train_stem as fts
    from mural_tpu_torch.parallel.sync_bn import convert_batchnorm
    from mural_tpu_torch.train.graphs import StepGroups, epoch_scalars
    from mural_tpu_torch.train.optim import (GraphOptimizer, LRSchedule,
                                             auto_weight_decay)
    from mural_tpu_torch.train.resident import (make_resident,
                                                resident_batch,
                                                resident_epoch,
                                                stack_epoch_rows,
                                                upload_rows)
    from mural_tpu_torch.train.steps import TrainState
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(ctx.device if ctx is not None else device)
    snv = model_type == "snv"
    cfg = (dict(CONFIG, emb_dropout=0.0, local_dropout=0.0,
                distal_fc_dropout=0.0) if snv else dict(INDEL_CONFIG))
    ds = fed_dataset(bed, fasta, cfg, model_type)
    res = make_resident(ds, dev)
    model = init_weights(build_model_from_config(cfg, 0, model_type),
                         torch.Generator().manual_seed(seed + 16))
    if not snv:
        model.out_fc[1].p = 0.0
    model = model.to(dev)
    if ctx is not None and ctx.world > 1:
        convert_batchnorm(model)
    B = TRAIN_BATCH
    wd = auto_weight_decay(0.1, B, 2, ds.n_sites, 1e-5)
    state = TrainState(model, GraphOptimizer("Adam", model.parameters(), wd),
                       LRSchedule.build("StepLR2", lr, 0.9, B, ds.n_sites,
                                        1e-4, 1e-6))
    cols = slice(None)
    if ctx is not None:
        state.grad_reduce = ctx.reduce_grads
        cols = ctx.shard(B)
    groups = StepGroups(state, k, resident_batch(
        res, snv, torch.ones(B if ctx is None else B // ctx.world,
                             device=dev)))
    rows_np, _, _ = stack_epoch_rows(ds, FED_SEGMENTS, B, True,
                                     np.random.default_rng(seed))
    rows = upload_rows(np.ascontiguousarray(rows_np[:n_steps, cols]), dev)
    scalars = to_device(epoch_scalars(state, n_steps), dev)
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fts.reset_launches()
    with deterministic_cudnn():
        first = resident_epoch(groups, rows[:k], scalars[:k])
        sync()
        t0 = time.perf_counter()
        rest = resident_epoch(groups, rows[k:], scalars[k:])
        sync()
        seconds = time.perf_counter() - t0
    launches = fts.launch_counts()
    losses = torch.cat([first, rest])
    if ctx is not None:
        ctx.all_reduce_(losses)
    out = {"losses": losses.tolist(), "steps_s": seconds,
           "timed_steps": n_steps - k,
           "windows_per_s": (n_steps - k) * B / seconds,
           "k2": launches["k2"], "k3": launches["k3"]}
    if busy_steps:
        more = upload_rows(np.ascontiguousarray(
            rows_np[n_steps:n_steps + busy_steps, cols]), dev)
        more_scalars = to_device(epoch_scalars(state, busy_steps), dev)
        out["device_busy_ms"] = device_busy_ms(lambda: resident_epoch(
            groups, more, more_scalars)) / busy_steps
        out["step_ms"] = seconds / (n_steps - k) * 1e3
        out["device_busy_share"] = out["device_busy_ms"] / out["step_ms"]
    return out


def dp_rank_runs(ctx, fasta, snv_bed, indel_bed, seed, device="cuda:0"):
    """Phase 16's two-rank gloo runs on one rank (or alone on
    ``device``): SNVNet2 and the U-Net at ``DP_LR``, and SNVNet2 at the
    CLI's learning rate."""
    return {"snv": dp_steps(ctx, fasta, snv_bed, "snv", DP_STEPS, 1, seed,
                            device=device, lr=DP_LR),
            "indel": dp_steps(ctx, fasta, indel_bed, "indel",
                              DP_INDEL_STEPS, 1, seed, device=device,
                              lr=DP_LR),
            "snv_cli_lr": dp_steps(ctx, fasta, snv_bed, "snv", DP_STEPS, 1,
                                   seed, device=device)}


def refusal(cli, argv) -> str:
    """The error a CLI call raises ('' when it runs)."""
    try:
        cli(argv)
    except ValueError as e:
        return str(e)
    return ""


def phase_sharded_predict(work, fasta, bed, model_path, dev):
    """Two replicas on one card against one: ``sharded_predict`` on the
    predict BED, fused and unfused (logits, loss, K1 launches, sites/s),
    and ``predict_genome --fused_inference`` of the 1 Mb chromosome."""
    import torch
    from mural_tpu_torch.models.registry import build_model_from_config
    from mural_tpu_torch.ops import fused_code_conv as fcc
    from mural_tpu_torch.parallel.sharded_predict import sharded_predict
    from mural_tpu_torch.predict.genome_wide import (GenomePredictOptions,
                                                     run_genome_predict)
    from mural_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  load_config)
    config = load_config(model_path + ".config.pkl")
    model = build_model_from_config(config, 0, "snv")
    load_checkpoint(model_path, model)
    ds = fed_dataset(bed, fasta, config, "snv")
    runs, checks = {}, {}
    n_batches = -(-ds.n_sites // BATCH)
    for fused in (True, False):
        got = {}
        for n in (1, 2):
            fcc.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, loss = sharded_predict(model, ds, BATCH,
                                           devices=[dev] * n,
                                           fused_inference=fused, n_class=4)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got[n] = (logits, loss)
            runs[f"{'fused' if fused else 'unfused'}_{n}"] = {
                "seconds": seconds, "sites_per_s": ds.n_sites / seconds,
                "k1_launches": fcc.LAUNCHES, "loss": loss}
        name = "fused" if fused else "unfused"
        err = float(np.abs(got[2][0] - got[1][0]).max())
        runs[f"{name}_2"]["max_abs_err"] = err
        checks[f"{name}: logits of two replicas within {TOL_SHARDED}"] = (
            got[2][0].shape == got[1][0].shape == (ds.n_sites, 4)
            and err <= TOL_SHARDED)
        checks[f"{name}: loss within {TOL_SHARDED} relative"] = abs(
            got[2][1] - got[1][1]) <= TOL_SHARDED * abs(got[1][1])
    checks["K1 twice per shard batch (two replicas, fused)"] = (
        runs["fused_2"]["k1_launches"] == 2 * 2 * n_batches)
    checks["K1 not launched unfused"] = (
        runs["unfused_2"]["k1_launches"] == 0)
    genome = {}
    for n in (1, 2):
        out = str(work / f"gw_replicas_{n}.tsv.gz")
        fcc.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = run_genome_predict(GenomePredictOptions(
            ref_genome=fasta, model_path=model_path,
            model_config_path=model_path + ".config.pkl",
            calibrator_path=model_path + ".fdiri_cal.pkl", pred_file=out,
            focal_base="A", chroms=[GW_CHROM], batch_size=BATCH,
            n_workers=0, fused_inference=True, device=dev,
            devices=[dev] * n), "snv", printer=lambda *a: None)
        seconds = time.perf_counter() - t0
        genome[n] = {"sites": total, "seconds": seconds,
                     "sites_per_s": total / seconds,
                     "k1_launches": fcc.LAUNCHES,
                     "tsv": read_genome_tsv(out)}
    one, two = genome[1].pop("tsv"), genome[2].pop("tsv")
    checks["predict_genome: two replicas write the same rows"] = (
        one[1] == two[1] and all(np.array_equal(one[2][c], two[2][c])
                                 for c in ("chrom", "start", "strand",
                                           "mut_type")))
    checks["predict_genome: probabilities within %.4g"] = within_printed(
        two[2]["probs"], one[2]["probs"])
    checks["predict_genome: K1 twice per shard batch"] = (
        genome[2]["k1_launches"] == 2 * genome[1]["k1_launches"])
    runs["genome"] = genome
    log("sharded predict on two replicas of one card: " + json.dumps(runs))
    check_all("sharded predict on two replicas of one card", checks)
    return runs


def phase_dp_train(fasta, family_bed, indel_bed, dev, seed):
    """Two gloo ranks on one card against one process (SNVNet2 and the
    U-Net), and one NCCL rank with 8-step CUDA graphs against the graphs
    without a group."""
    from mural_tpu_torch.parallel.distributed import spawn_ranks
    out, checks = {}, {}
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_rank_runs, [dev, dev],
                        (fasta, family_bed, indel_bed, seed),
                        backend="gloo")
    out["gloo_spawn_and_run_s"] = time.perf_counter() - t0
    alone = dp_rank_runs(None, fasta, family_bed, indel_bed, seed, dev)
    for name, first in (("snv", 8), ("indel", DP_INDEL_STEPS),
                        ("snv_cli_lr", 8)):
        ref = np.asarray(alone[name]["losses"])
        rel = [np.abs(np.asarray(r[name]["losses"]) - ref) / np.abs(ref)
               for r in ranks]
        mean_rel = abs(np.mean(ranks[0][name]["losses"]) - ref.mean()) \
            / abs(ref.mean())
        out[name] = {"max_rel_first": float(max(r[:first].max()
                                                for r in rel)),
                     "max_rel_all": float(max(r.max() for r in rel)),
                     "mean_rel": float(mean_rel),
                     "ranks": [{k: v for k, v in r[name].items()
                                if k != "losses"} for r in ranks],
                     "alone": {k: v for k, v in alone[name].items()
                               if k != "losses"}}
        if name == "snv_cli_lr":       # recorded: the drift at 1e-3
            out[name]["rel_per_step"] = [float(f"{v:.3g}") for v in rel[0]]
            continue
        checks[f"{name}: per-step loss within {TOL_STEP} over the first "
               f"{first} steps"] = out[name]["max_rel_first"] <= TOL_STEP
        checks[f"{name}: both ranks report the same losses"] = (
            ranks[0][name]["losses"] == ranks[1][name]["losses"])
    checks[f"snv: the {DP_STEPS}-step mean within {TOL_DP_MEAN}"] = (
        out["snv"]["mean_rel"] <= TOL_DP_MEAN)
    checks["snv: K2/K3 twice per step on each rank"] = all(
        r["snv"]["k2"] == r["snv"]["k3"] == 2 * DP_STEPS for r in ranks)
    checks["indel: no K2/K3 launch"] = all(
        r["indel"]["k2"] == r["indel"]["k3"] == 0 for r in ranks)
    # one NCCL rank: the captured all-reduce of the gradients replays
    t0 = time.perf_counter()
    nccl = spawn_ranks(dp_steps, [dev], (fasta, family_bed, "snv",
                                         DP_GRAPH_STEPS, FED_K, seed,
                                         PROFILED_STEPS), backend="nccl")[0]
    out["nccl_spawn_and_run_s"] = time.perf_counter() - t0
    graphs = dp_steps(None, fasta, family_bed, "snv", DP_GRAPH_STEPS, FED_K,
                      seed, PROFILED_STEPS, dev)
    rel = np.abs(np.asarray(nccl["losses"]) - graphs["losses"]) \
        / np.abs(graphs["losses"])
    out["nccl_graphs"] = {k: v for k, v in nccl.items() if k != "losses"}
    out["graphs"] = {k: v for k, v in graphs.items() if k != "losses"}
    out["nccl_max_rel"] = float(rel.max())
    checks[f"NCCL rank, {FED_K}-step graphs: per-step loss within "
           f"{TOL_STEP} of the graphs without a group"] = (
        out["nccl_max_rel"] <= TOL_STEP)
    checks["NCCL rank: K2/K3 twice per step, replays included"] = (
        nccl["k2"] == nccl["k3"] == 2 * DP_GRAPH_STEPS)
    log("data-parallel train steps: " + json.dumps(out))
    check_all("data-parallel train steps", checks)
    return out


def phase_tail_cli(work, fasta, family_bed, cuda_id):
    """``train --epochs 3 --fused_stem on`` through the CLI: the files of
    every epoch, and each epoch's seconds beside its tail's on its
    thread."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    run = cli_train(cli, work, fasta, family_bed, "tail", cuda_id,
                    ["--fused_stem", "on", "--epochs", str(TAIL_EPOCHS)])
    trial, epochs = run["trial"], run["epochs"]
    log("train with the overlapped epoch tail: " + json.dumps(epochs))
    check_all("train with the overlapped epoch tail", {
        "exit code 0": run["rc"] == 0,
        f"{TAIL_EPOCHS} checkpoint triples and metrics files": all(
            (trial / f"checkpoint_{e}" / f).exists()
            for e in range(TAIL_EPOCHS)
            for f in ("model", "model.config.pkl", "model.fdiri_cal.pkl",
                      f"epoch_{e}_metrics.txt")),
        f"{TAIL_EPOCHS} progress.csv rows": len(
            (trial / "progress.csv").read_text().splitlines())
        == TAIL_EPOCHS + 1,
        "finite metrics": all(finite_metrics(trial, e)
                              for e in range(TAIL_EPOCHS)),
        "every epoch and tail logged": len(epochs) == TAIL_EPOCHS and all(
            e["tail_s"] is not None for e in epochs),
    })
    return {"seconds": run["seconds"], "epochs": epochs,
            "k2": run["k2"], "k3": run["k3"]}


def phase_parallel(work, fasta, bed, family_bed, indel_bed, model_path,
                   dev, seed):
    """Phase 16: the refusals of ``--dp_devices 2`` / ``--n_devices 2`` on
    one card, replicas on one card, two gloo ranks and one NCCL rank, and
    the overlapped epoch tail."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    part_s = {}
    t0 = time.perf_counter()
    want = "requested 2 devices, have 1"
    common = ["--ref_genome", fasta, "--model_path", model_path,
              "--model_config_path", model_path + ".config.pkl"]
    refusals = {
        "train": refusal(cli, ["train", "--ref_genome", fasta,
                               "--train_data", family_bed,
                               "--experiment_name", "dp2",
                               "--dp_devices", "2"]),
        "predict": refusal(cli, ["predict", *common, "--test_data", bed,
                                 "--pred_file", str(work / "n2.tsv.gz"),
                                 "--n_devices", "2"]),
        "predict_genome": refusal(cli, ["predict_genome", *common,
                                        "--chroms", GW_CHROM, "--pred_file",
                                        str(work / "gw_n2.tsv.gz"),
                                        "--n_devices", "2"])}
    check_all("--dp_devices 2 and --n_devices 2 on one card", {
        f"{name} refused with '{want}'": text == want
        for name, text in refusals.items()})
    part_s["refusals"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = phase_sharded_predict(work, fasta, bed, model_path, dev)
    part_s["sharded_predict"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = phase_dp_train(fasta, family_bed, indel_bed, dev, seed)
    part_s["dp_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tail = phase_tail_cli(work, fasta, family_bed, dev.index or 0)
    part_s["tail_cli"] = time.perf_counter() - t0
    out = {"part_s": part_s, "sharded": sharded, "dp": dp, "tail": tail}
    log("phase 16: " + json.dumps(out))
    return out


# --- phase 17: the site-table cache and the last modules -----------------

LOSS_BATCH = 4096       # rows of the losses' card-vs-CPU check
TOL_LOSSES = 1e-5       # values relative; gradients of the largest entry
CAL_ROWS = 50_000       # rows of phase 6's predictions the calibrators fit
_PREPROCESS = re.compile(r"(?:test|training) set preprocess (?:used )?"
                         r"time: ([\d.]+)")


def preprocess_s(lines):
    """The seconds of the run's preprocess line (cache write or read
    included)."""
    return next((float(m[1]) for m in map(_PREPROCESS.search, lines) if m),
                None)


def tsv_text(path):
    with gzip.open(path, "rt") as fh:
        return fh.read()


def shard_probe():
    """Run in a spawned process, as a cache shard writer is: the seconds
    to import the cache module and whether torch came with it."""
    t0 = time.perf_counter()
    import mural_tpu_torch.data.cache  # noqa: F401
    return time.perf_counter() - t0, "torch" in sys.modules


def shard_process_start():
    """Seconds from creating a one-process spawn pool to the result of
    ``shard_probe`` in it: what one shard writer costs to start on this
    host."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        import_s, torch_loaded = pool.submit(shard_probe).result()
    return {"start_s": time.perf_counter() - t0, "import_s": import_s,
            "torch_loaded": torch_loaded}


def cache_io(h5_dir: Path, fasta, n_files, work):
    """Seconds of the cache functions on the cache in ``h5_dir``: its
    load, and a fresh write of the loaded dataset with ``n_files``
    files."""
    from mural_tpu_torch.data import cache
    from mural_tpu_torch.genome.fasta import Genome
    (path,) = h5_dir.glob("*.sites.h5")
    genome = Genome.from_fasta(fasta)
    t0 = time.perf_counter()
    # the encoding parameters are not in the file and time nothing
    ds = cache.load_dataset_cache(str(path), genome, 0, 0, 0, 0)
    read_s = time.perf_counter() - t0
    out = work / "cache_io" / path.name
    t0 = time.perf_counter()
    cache.save_dataset_cache(ds, str(out), n_files)
    write_s = time.perf_counter() - t0
    shutil.rmtree(out.parent)
    return {"read_s": read_s, "write_s": write_s, "n_sites": ds.n_sites,
            "n_files": n_files}


def cache_files(h5_dir: Path):
    return sorted(p.name for p in h5_dir.iterdir()) if h5_dir.exists() \
        else []


def phase_cache_predict(work, fasta, bed, model_path, n_sites, cuda_id):
    """``predict --fused_inference --with_h5`` cold, warm, and cold with
    4 shards; each TSV equal to phase 6's fused TSV once decompressed."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    common = ["--ref_genome", fasta, "--test_data", bed,
              "--model_path", model_path,
              "--model_config_path", model_path + ".config.pkl",
              "--calibrator_path", model_path + ".fdiri_cal.pkl",
              "--pred_batch_size", str(BATCH), "--cuda_id", str(cuda_id),
              "--fused_inference", "--with_h5"]
    want = tsv_text(work / "pred_fused.tsv.gz")
    runs = {}
    for name, h5, extra in (("cold", "h5_snv", []), ("warm", "h5_snv", []),
                            ("cold_4_files", "h5_snv4",
                             ["--n_h5_files", "4"])):
        out = work / f"pred_h5_{name}.tsv.gz"
        run = cli_predict(cli, common, str(out),
                          ["--h5f_path", str(work / h5), *extra])
        runs[name] = {"rc": run["rc"], "seconds": run["seconds"],
                      "launches": run["launches"],
                      "preprocess_s": preprocess_s(run["lines"]),
                      "lines": run["lines"],
                      "same_tsv": tsv_text(out) == want,
                      "files": cache_files(work / h5)}
        log(f"predict --with_h5 {name}: {run['seconds']:.3f} s, test set "
            f"preprocess {runs[name]['preprocess_s']} s, K1 launches "
            f"{run['launches']}, cache files {runs[name]['files']}")
    n_batches = math.ceil(n_sites / BATCH)
    cold, warm, sharded = runs["cold"], runs["warm"], runs["cold_4_files"]
    masters = [f for f in sharded["files"] if f.endswith(".sites.h5")]
    check_all("predict --fused_inference --with_h5", {
        "exit codes 0": all(r["rc"] == 0 for r in runs.values()),
        "the cold runs wrote the cache": any(
            line.startswith("wrote site-encoding cache (1 file(s)):")
            for line in cold["lines"]) and any(
            line.startswith("wrote site-encoding cache (4 file(s)):")
            for line in sharded["lines"]),
        "the warm run used it": any(
            line.startswith("using cached site encodings:")
            for line in warm["lines"]),
        "one file; 4 shards and a master": len(cold["files"]) == 1
        and len(masters) == 1 and sharded["files"] == sorted(
            masters + [f"{masters[0]}.part{k:02d}of04" for k in range(4)]),
        "each TSV equal to phase 6's fused TSV": all(
            r["same_tsv"] for r in runs.values()),
        f"K1 launched 2 x {n_batches} batches in each run": all(
            r["launches"] == 2 * n_batches for r in runs.values()),
    })
    for r in runs.values():
        del r["lines"]
    return runs


def phase_cache_train(work, fasta, family_bed, cuda_id):
    """``train --fused_stem on --with_h5 --epochs 1`` cold, then warm, with
    deterministic cuDNN: the warm run reads the cache and its epoch-0
    train loss equals the cold run's within 1e-4 relative."""
    from mural_tpu_torch.cli.mural_snv import main as cli
    h5 = work / "h5_train"
    runs = {}
    with deterministic_cudnn():
        for name in ("cold", "warm"):
            run = cli_train(cli, work, fasta, family_bed, f"h5_{name}",
                            cuda_id, ["--fused_stem", "on", "--epochs", "1",
                                      "--with_h5", "--h5f_path", str(h5)])
            text = (run["trial"] / "training.log").read_text().splitlines()
            losses = [float(line.split(":", 1)[1]) for line in text
                      if line.startswith("Training Loss:")]
            runs[name] = {"rc": run["rc"], "seconds": run["seconds"],
                          "preprocess_s": preprocess_s(text),
                          "train_loss": losses[0] if losses else None,
                          "epochs": run["epochs"], "k2": run["k2"],
                          "k3": run["k3"], "log": text}
            log(f"train --with_h5 {name}: {run['seconds']:.3f} s, training "
                f"set preprocess {runs[name]['preprocess_s']} s, epoch-0 "
                f"train loss {runs[name]['train_loss']}, K2/K3 "
                f"{run['k2']}/{run['k3']}")
    cold, warm = runs["cold"], runs["warm"]
    launches_ok = all(
        len(r["epochs"]) == 1
        and r["k2"] == 2 * (r["epochs"][0]["train_steps"]
                            + r["epochs"][0]["valid_batches"])
        and r["k3"] == 2 * r["epochs"][0]["train_steps"]
        for r in runs.values())
    check_all("train --fused_stem on --with_h5", {
        "exit codes 0": cold["rc"] == 0 and warm["rc"] == 0,
        "the cold run wrote the cache": any(
            line.startswith("wrote site-encoding cache (1 file(s)):")
            for line in cold["log"]),
        "the warm run used it": any(
            line.startswith("using cached site encodings:")
            for line in warm["log"]),
        "K2 twice per train step and validation batch, K3 twice per train "
        "step": launches_ok,
        "epoch-0 train losses within 1e-4 relative":
            cold["train_loss"] is not None and warm["train_loss"] is not None
            and abs(warm["train_loss"] - cold["train_loss"])
            <= 1e-4 * abs(cold["train_loss"]),
    })
    for r in runs.values():
        del r["log"]
    return runs


def phase_cache_indel(work, fasta, bed, model_path, cuda_id):
    """``mural_indel predict --with_h5`` cold, then warm: equal TSVs and
    no launch of K1-K3."""
    from mural_tpu_torch.cli.mural_indel import main as cli
    common = ["--ref_genome", fasta, "--test_data", bed,
              "--model_path", model_path,
              "--model_config_path", model_path + ".config.pkl",
              "--calibrator_path", model_path + ".fdiri_cal.pkl",
              "--pred_batch_size", str(INDEL_PRED_BATCH), "--cuda_id",
              str(cuda_id), "--with_h5", "--h5f_path",
              str(work / "h5_indel")]
    runs, texts = {}, {}
    for name in ("cold", "warm"):
        out = work / f"indel_h5_{name}.tsv.gz"
        (run, counts) = counted(cli_predict, cli, common, str(out))
        texts[name] = tsv_text(out)
        runs[name] = {"rc": run["rc"], "seconds": run["seconds"],
                      "preprocess_s": preprocess_s(run["lines"]),
                      "rows": len(run["tsv"][1]), "launches": counts,
                      "lines": run["lines"]}
        log(f"mural_indel predict --with_h5 {name}: {run['seconds']:.3f} s, "
            f"test set preprocess {runs[name]['preprocess_s']} s")
    cold, warm = runs["cold"], runs["warm"]
    check_all("mural_indel predict --with_h5", {
        "exit codes 0": cold["rc"] == 0 and warm["rc"] == 0,
        "the cold run wrote the cache, the warm run used it": any(
            line.startswith("wrote site-encoding cache (1 file(s)):")
            for line in cold["lines"]) and any(
            line.startswith("using cached site encodings:")
            for line in warm["lines"]),
        f"{INDEL_SITES} rows": cold["rows"] == INDEL_SITES,
        "equal TSVs": texts["cold"] == texts["warm"],
        "K1, K2 and K3 launched 0 times": all(
            r["launches"] == (0, 0, 0) for r in runs.values()),
    })
    for r in runs.values():
        del r["lines"]
    return runs


def phase_losses(dev, seed):
    """The port's losses on the card against the same call on the CPU,
    B=4096 with 4 and 8 classes: values within 1e-5 relative, gradients
    in the logits within 1e-5 of their largest entry."""
    import torch
    from mural_tpu_torch.train import losses
    rng = np.random.default_rng(seed + 17)
    out = {}
    for k in (4, 8):
        logits = rng.normal(size=(LOSS_BATCH, k)).astype(np.float32)
        labels = torch.from_numpy(rng.integers(0, k, LOSS_BATCH))
        counts = np.bincount(labels.numpy(), minlength=k) * 10 + 3
        one_hot = torch.eye(k)[labels]
        alpha = torch.from_numpy(rng.uniform(0.2, 2.0, (LOSS_BATCH, k))
                                 .astype(np.float32))
        calls = {
            "focal_ce_loss": lambda x, d: losses.focal_ce_loss(
                x, labels.to(d), 2.0),
            "sigmoid_focal_loss": lambda x, d: losses.sigmoid_focal_loss(
                one_hot.to(d), x, alpha.to(d), 2.0)}
        for kind in ("sigmoid", "focal", "softmax"):
            calls[f"class_balanced_loss_{kind}"] = (
                lambda kind: lambda x, d: losses.class_balanced_loss(
                    x, labels.to(d), counts, k, kind, 0.9999, 2.0))(kind)
        for name, fn in calls.items():
            res = []
            for d in ("cpu", dev):
                x = torch.tensor(logits, device=d, requires_grad=True)
                value = fn(x, d)
                value.backward()
                res.append((value.item(), x.grad.cpu().numpy()))
            (v_cpu, g_cpu), (v_dev, g_dev) = res
            out[f"{name}_{k}"] = {
                "value": v_dev,
                "value_rel": abs(v_dev - v_cpu) / abs(v_cpu),
                "grad_rel": float(np.abs(g_dev - g_cpu).max()
                                  / np.abs(g_cpu).max())}
    log("losses, card against CPU: " + json.dumps(out))
    check_all("losses on the card", {
        f"{name}: value and gradient within {TOL_LOSSES}":
            r["value_rel"] <= TOL_LOSSES and r["grad_rel"] <= TOL_LOSSES
            for name, r in out.items()})
    return out


def phase_extra_calibrators(work, pred_file):
    """The four extra calibrators fitted on the host to phase 6's fused
    probabilities and observed classes (the first CAL_ROWS rows):
    probabilities finite and summing to 1; each pickle loads back through
    ``load_calibrator`` with the same probabilities."""
    from mural_tpu_torch.calibrate import extra
    from mural_tpu_torch.train.checkpoint import load_calibrator
    _, keys, probs = read_tsv(pred_file)
    y = np.asarray([int(k[4]) for k in keys[:CAL_ROWS]])
    probs = probs[:CAL_ROWS]
    logits = np.log(np.clip(probs, 1e-12, 1))
    out, checks = {}, {}
    for name, cal, X in (
            ("DiagDirichlet", extra.DiagDirichlet(), probs),
            ("FixedDiagDirichlet", extra.FixedDiagDirichlet(), probs),
            ("MatrixScaling", extra.MatrixScaling(), logits),
            ("DirichletCalibrator", extra.DirichletCalibrator(
                "diagonal", l2=1e-3), probs)):
        t0 = time.perf_counter()
        cal.fit(X, y)
        fit_s = time.perf_counter() - t0
        p = cal.predict_proba(X)
        path = work / f"{name}.pkl"
        path.write_bytes(pickle.dumps(cal))
        same = np.array_equal(load_calibrator(str(path)).predict_proba(X),
                              p)
        out[name] = {"fit_s": fit_s, "max_sum_err": float(
            np.abs(p.sum(1) - 1).max())}
        checks[f"{name}: finite, summing to 1 within 1e-9, pickle loads"] = (
            bool(np.isfinite(p).all()) and out[name]["max_sum_err"] <= 1e-9
            and same)
    log("extra calibrators: " + json.dumps(out))
    check_all("extra calibrators", checks)
    return out


def phase_cache(work, fasta, bed, family_bed, model_path, indel_path,
                indel_bed, n_sites, dev, seed):
    """Phase 17: the site-table cache on BED predict, train and INDEL
    predict, a shard writer's start-up, the cache's own read and write
    seconds, and the last modules (losses, extra calibrators)."""
    cuda_id = dev.index or 0
    part_s = {}
    t0 = time.perf_counter()
    start = shard_process_start()
    log("one spawned shard writer's start: " + json.dumps(start))
    check_all("shard writer", {"starts without torch":
                               not start["torch_loaded"]})
    part_s["shard_start"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    predict = phase_cache_predict(work, fasta, bed, model_path, n_sites,
                                  cuda_id)
    part_s["predict"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = phase_cache_train(work, fasta, family_bed, cuda_id)
    part_s["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    indel = phase_cache_indel(work, fasta, indel_bed, model_path=indel_path,
                              cuda_id=cuda_id)
    part_s["indel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    io_s = {name: cache_io(work / h5, fasta, n_files, work)
            for name, h5, n_files in (
                ("snv_predict", "h5_snv", 1),
                ("snv_predict_4_files", "h5_snv4", 4),
                ("snv_train", "h5_train", 1),
                ("indel_predict", "h5_indel", 1))}
    log("cache read and write seconds: " + json.dumps(io_s))
    part_s["cache_io"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss = phase_losses(dev, seed)
    part_s["losses"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cals = phase_extra_calibrators(work, str(work / "pred_fused.tsv.gz"))
    part_s["calibrators"] = time.perf_counter() - t0
    out = {"part_s": part_s, "shard_start": start, "predict": predict,
           "train": train, "indel": indel, "cache_io": io_s,
           "losses": loss, "calibrators": cals}
    log("phase 17: " + json.dumps(out))
    return out


def kernel_records(k1, k23, k1_launches, train_on, family=None,
                   later=None, genome=None, fed=None, k23_bf16=None,
                   mixed=None, parallel=None, cached=None, k4=None,
                   indel=None, k5=None):
    """The kernels' JSON records from phases 2-3; ``launches`` come from
    the main path's runs (None when it did not run): K1 from phase 6's
    fused predict, K2/K3 from phase 7's fused train (resident data, 8
    steps per CUDA graph replay; each replay counts the launches its
    graph recorded); ``launches_phase10`` from phase 10's runs
    (``family``: K1 on its predicts, K2/K3 on each train run);
    ``launches_phase11`` from phase 11's runs in this process (``later``:
    K1 on the transferred predict, K2/K3 on the SNV transfer and the ASHA
    search; all three on the INDEL transfer); ``launches_phase12``: K1 on
    each of phase 12's runs (``genome``); ``launches_phase13``: K2/K3 on
    each of phase 13's SNV runs (``fed``).  The bf16 mode of K2/K3 has
    records of its own (``k23_bf16``, phase 3's checks and timings in that
    mode); their ``launches`` come from phase 15's ``train --bf16
    --fused_stem on`` (``mixed``), and ``launches_phase15`` from its step
    runs.  ``launches_phase16`` (``parallel``): K1 on the sharded
    predicts and genome-wide runs, K2/K3 on each data-parallel rank and
    the overlapped-tail CLI run.  ``launches_phase17`` (``cached``): K1 on
    each ``predict --with_h5`` run, K2/K3 on the cold and warm ``train
    --with_h5``.  K4's record (``k4``, phase 18) takes its ``launches``
    from phase 12's INDEL ``predict_genome`` (``genome``) and
    ``launches_phase9`` from phase 9's parts (``indel``: the forward, the
    train steps, and the CLI's train and predict).  K5's record (``k5``,
    phase 19) gives its per-step sums over one U-Net train step's
    BatchNorms; ``launches`` from phase 9's train steps,
    ``launches_phase9`` from each of phase 9's parts and
    ``launches_phase7`` from phase 7's fused train (``train_on``: CUDA
    graph replays) and its unfused eager epoch."""
    p11 = None
    if later is not None:
        tr, ind = later["transfer"], later["indel_transfer"]["launches"]
        asha = later["search"]["asha"]
        p11 = [{"predict_transferred": tr["k1"], "indel_transfer": ind[0]},
               {"transfer": tr["k2"], "search": asha["k2"],
                "indel_transfer": ind[1]},
               {"transfer": tr["k3"], "search": asha["k3"],
                "indel_transfer": ind[2]}]
    per_step = (f"one train step: B={TRAIN_BATCH} at L=401 (pool 15) and "
                f"the L=201 crop (pool 3)")
    t128 = k23["timings"][TRAIN_BATCH]
    kernels = [{
        "name": "code_conv1d", "route": "cuda",
        "source": "mural_tpu_torch/ops/csrc/code_conv1d.cu",
        "replaces": "mural_tpu/ops/fused_code_conv.py:115",
        "launches": k1_launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "call_ms": k1["call_ms"], "plain_call_ms": k1["plain_call_ms"],
        "library_call_ms": k1["library_call_ms"],
        "per": f"one predict batch: B={BATCH} at L=401 and the L=201 crop",
        "at_b256": k1["at_b256"],
        "launches_phase10": family and family["k1_launches"],
        "launches_phase11": p11 and p11[0],
        "launches_phase12": genome and {
            name: run["k1_launches"] for name, run in genome.items()},
        "launches_phase16": parallel and {
            **{name: run["k1_launches"] for name, run in
               parallel["sharded"].items() if name != "genome"},
            **{f"genome_{n}_replicas": run["k1_launches"] for n, run in
               parallel["sharded"]["genome"].items()}},
        "launches_phase17": cached and {
            name: run["launches"] for name, run in
            cached["predict"].items()},
    }, {
        "name": "code_conv_pool_fwd", "route": "cuda",
        "source": "mural_tpu_torch/ops/csrc/code_conv_pool.cu",
        "replaces": "mural_tpu/ops/fused_train_stem.py:339",
        "launches": train_on and train_on["k2"],
        "max_abs_err": k23["max_abs_err_k2"], "ms": t128["k2_ms"],
        "plain_ms": t128["k2_plain_ms"], "bound_ms": k23["bound_k2"][0],
        "bound_by": k23["bound_k2"][1], "library_ms": t128["k2_library_ms"],
        "call_ms": t128["k2_call_ms"], "per": per_step,
        "bound_ms_b2048": k23["bound_k2_b2048"][0], "at_b128": t128, "at_b2048": k23["timings"][2048],
        "launches_phase10": family and {
            name: run["k2"] for name, run in family["train"].items()},
        "launches_phase11": p11 and p11[1],
        "launches_phase13": fed and {
            name: run["k2"] for name, run in fed["snv"].items()},
        "launches_phase16": parallel and {
            "gloo_ranks": [r["k2"] for r in
                           parallel["dp"]["snv"]["ranks"]],
            "nccl_rank_graphs": parallel["dp"]["nccl_graphs"]["k2"],
            "tail_cli": parallel["tail"]["k2"]},
        "launches_phase17": cached and {
            name: run["k2"] for name, run in cached["train"].items()},
    }, {
        "name": "code_conv_pool_bwd", "route": "cuda",
        "source": "mural_tpu_torch/ops/csrc/code_conv_pool.cu",
        "replaces": "mural_tpu/ops/fused_train_stem.py:375",
        "launches": train_on and train_on["k3"],
        "max_abs_err": k23["max_abs_err_k3"],
        "max_rel_err": k23["max_rel_err_k3"], "ms": t128["k3_ms"],
        "plain_ms": t128["k3_plain_ms"], "bound_ms": k23["bound_k3"][0],
        "bound_by": k23["bound_k3"][1], "library_ms": t128["k3_library_ms"],
        "call_ms": t128["k3_call_ms"], "per": per_step,
        "bound_ms_b2048": k23["bound_k3_b2048"][0], "at_b128": t128, "at_b2048": k23["timings"][2048],
        "launches_phase10": family and {
            name: run["k3"] for name, run in family["train"].items()},
        "launches_phase11": p11 and p11[2],
        "launches_phase13": fed and {
            name: run["k3"] for name, run in fed["snv"].items()},
        "launches_phase16": parallel and {
            "gloo_ranks": [r["k3"] for r in
                           parallel["dp"]["snv"]["ranks"]],
            "nccl_rank_graphs": parallel["dp"]["nccl_graphs"]["k3"],
            "tail_cli": parallel["tail"]["k3"]},
        "launches_phase17": cached and {
            name: run["k3"] for name, run in cached["train"].items()},
    }]
    if k23_bf16 is not None:
        b128 = k23_bf16["timings"][TRAIN_BATCH]
        cli = mixed and mixed["cli"]["snv"]
        steps = mixed and mixed["steps"]["snv"]
        for kk, name, line in (("k2", "fwd", 339), ("k3", "bwd", 375)):
            kernels.append({
                "name": f"code_conv_pool_{name}_bf16", "route": "cuda",
                "mode": "bf16 (the Pallas kernels' split=False)",
                "source": "mural_tpu_torch/ops/csrc/code_conv_pool.cu",
                "replaces": f"mural_tpu/ops/fused_train_stem.py:{line}",
                "launches": cli and cli[f"{kk}_bf16"],
                "max_abs_err": k23_bf16[f"max_abs_err_{kk}"],
                "ms": b128[f"{kk}_ms"], "plain_ms": b128[f"{kk}_plain_ms"],
                "bound_ms": k23_bf16[f"bound_{kk}"][0],
                "bound_by": k23_bf16[f"bound_{kk}"][1],
                "library_ms": b128[f"{kk}_library_ms"],
                "call_ms": b128[f"{kk}_call_ms"], "per": per_step,
                "bound_ms_b2048": k23_bf16[f"bound_{kk}_b2048"][0],
                "at_b128": b128, "at_b2048": k23_bf16["timings"][2048],
                "launches_phase15": steps and {
                    run: rec[f"{kk}_bf16"] for run, rec in steps.items()},
            })
    if k4 is not None:
        main = k4["timings"][f"{K4_SHAPES[0][0]}x{K4_SHAPES[0][1]}"]
        kernels.append({
            "name": "window_one_hot", "route": "cuda",
            "source": "mural_tpu_torch/ops/csrc/window_one_hot.cu",
            "replaces": None,
            "launches": genome and genome["indel"]["k4_launches"],
            "max_abs_err": k4["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "call_ms": main["call_ms"],
            "per": "one INDEL map batch: B=4096 windows of W=8000, float32",
            "timings": k4["timings"],
            "launches_phase9": indel and indel["k4_launches"],
            "launches_phase12": genome and {
                name: run["k4_launches"] for name, run in genome.items()
                if name != "bed_check"},
        })
    if k5 is not None:
        main = k5["per_step"]["indel"]
        kernels.append({
            "name": "batch_norm", "route": "cuda",
            "source": "mural_tpu_torch/ops/csrc/batch_norm.cu",
            "replaces": None,
            "launches": indel and indel["k5_launches"]["train_step"],
            "max_abs_err": None, "cases": k5["cases"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": main["cudnn_ms"],
            "per": "one U-Net train step's 36 BatchNorm calls, forward and "
                   "backward: B=128, W=8000, float32",
            "per_step": k5["per_step"], "planes": k5["planes"],
            "indel_step": k5["indel_step"],
            "launches_phase9": indel and indel["k5_launches"],
            "launches_phase7": train_on and {
                "fused": train_on["k5"], "unfused": train_on["k5_unfused"]},
        })
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_sites", type=int, default=200_000)
    ap.add_argument("--n_train", type=int, default=60_000)
    ap.add_argument("--only_kernels", action="store_true",
                    help="setup, phases 2-3, the bf16 mode's kernel "
                         "checks and phases 18-19 (K4, K5) only, then the "
                         "kernels' JSON line; no "
                         "device record (for iterating on the kernels)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from mural_tpu_torch.ops import fused_code_conv as fcc
        from mural_tpu_torch.ops import fused_train_stem as fts
    except ImportError as e:
        print(f"chip_smoke: the mural_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # 1. setup
    card = card_line()
    log(f"card (name, power limit): {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t_build, build_logs = build_kernels()
    log(f"kernels built and loaded in {t_build:.2f} s (in parallel)")
    for name, text in build_logs.items():
        log(f"nvcc on {name}.cu said:\n{text}")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    if not args.only_kernels:
        fasta, bed, train_bed = write_inputs(work, rng, args.n_sites,
                                             args.n_train)
        indel_beds = write_indel_inputs(work, rng, INDEL_SITES, INDEL_TRAIN)
        indel_path = write_indel_checkpoint(work, args.seed)
    model_path, model = write_checkpoint(work, args.seed)
    log(f"synthetic inputs and checkpoints in "
        f"{time.perf_counter() - t0:.2f} s (SNV: {args.n_sites} sites to "
        f"predict, {args.n_train} to train; INDEL: {INDEL_SITES} "
        f"and {INDEL_TRAIN})")
    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    # 2-3. kernels vs plain
    k1 = timed("k1", phase_k1, model.to(dev).eval(), dev, gen)
    k23 = timed("k2_k3", phase_k2_k3, model, dev, gen)
    # 15 (kernels). K2/K3's bf16 mode against its plain version
    k23_bf16 = timed("k2_k3_bf16", phase_k2_k3, model, dev, gen, True)
    # 18. K4 against its plain version
    k4 = timed("k4", phase_k4, dev, gen)
    # 19. K5 against the float64 reference, and the U-Net step with it
    k5 = timed("k5", phase_k5, dev, gen, args.seed)
    if args.only_kernels:
        shutil.rmtree(work, ignore_errors=True)
        log(json.dumps({"kernels": kernel_records(
            k1, k23, None, None, k23_bf16=k23_bf16, k4=k4, k5=k5)}))
        log(json.dumps({"card": card, "build_s": t_build,
                        "phase_s": phase_s,
                        "timed_with_cuda_events": TIMED_WITH_EVENTS,
                        "total_s": time.perf_counter() - t_start}))
        return 0
    # 4-5. model and train step on the card
    model_err, fwd_ms = timed("model", phase_model, model, dev, gen)
    step_rel, step_rel_cpu, step_timing = timed(
        "train_step", phase_train_step, dev, args.seed)
    # 6. the predict path (K1 counted from 0 around each run)
    fused, unfused = timed("predict", phase_predict, work, fasta, bed,
                           model_path, args.n_sites, dev.index or 0)
    # 7. the training path (K2/K3 counted from 0 around each run)
    train_on, train_off = timed("train_cli", phase_train_cli, work, fasta,
                                train_bed, args.n_train, dev.index or 0)
    # 8. evaluate and scale phase 6's predictions
    evaluation = timed("evaluate_scale", phase_evaluate, work, fasta,
                       str(work / "pred_fused.tsv.gz"))
    # 9. the INDEL path (K4 and K5; none of K1-K3)
    indel = timed("indel", phase_indel, work, fasta, indel_path, indel_beds,
                  dev, args.seed)
    # 10. the rest of the SNV family and the track features
    family = timed("snv_family", phase_family, work,
                   np.random.default_rng(args.seed + 10), fasta, bed,
                   train_bed, dev, args.seed)
    # 11. transfer, convert and the trial search
    later = timed("transfer_search", phase_transfer_search, work, fasta,
                  bed, train_bed, indel_beds[1], train_on.pop("best_model"),
                  indel["cli"].pop("best_model"), dev, args.seed)
    # 12. genome-wide predict (K1 on the fused SNV runs only)
    genome = timed("genome_wide", phase_genome_wide, work, fasta,
                   model_path, indel_path, dev, args.seed)
    # 13. the device-fed train loop (K2/K3 counted from 0 around each run)
    family_bed = write_family_bed(work, train_bed)
    fed = timed("device_fed", phase_device_fed, work, fasta, family_bed,
                indel_beds[1], dev, args.seed)
    # 15. mixed precision and trial ensembles (K2/K3 in both modes
    # counted from 0 around each run); members run unfused, so phase 13's
    # unfused resident graph rate is their serial yardstick
    mixed = timed("mixed_ensembles", phase_mixed_ensembles, work, fasta,
                  family_bed, indel_beds[1], model_path, dev, args.seed,
                  fed["snv"]["resident_graphs_unfused"]["windows_per_s"][-1])
    # 16. replicas and data-parallel ranks on the one card, the overlapped
    # epoch tail (K1-K3 counted from 0 around each run, in each rank)
    parallel = timed("parallel", phase_parallel, work, fasta, bed,
                     family_bed, indel_beds[1], model_path, dev, args.seed)
    # 17. the site-table cache and the last modules (K1-K3 counted from 0
    # around each run)
    cached = timed("cache", phase_cache, work, fasta, bed, family_bed,
                   model_path, indel_path, indel_beds[0], args.n_sites, dev,
                   args.seed)
    shutil.rmtree(work, ignore_errors=True)

    # 14. results
    log(json.dumps({"kernels": kernel_records(
        k1, k23, fused["launches"], train_on, family, later, genome, fed,
        k23_bf16, mixed, parallel, cached, k4, indel, k5)}))
    log(json.dumps({
        "card": card, "build_s": t_build,
        "model_max_abs_err": model_err, **fwd_ms,
        "train_step_rel_diff_fused_unfused": step_rel,
        "train_step_rel_diff_card_cpu": step_rel_cpu,
        "train_step_b128": step_timing,
        "predict_fused_s": fused["seconds"],
        "predict_fused_sites_per_s": fused["sites_per_s"],
        "predict_unfused_s": unfused["seconds"],
        "predict_unfused_sites_per_s": unfused["sites_per_s"],
        "predict_fused_correlation_s": fused["corr_s"],
        "predict_fused_correlations": fused["correlations"],
        "evaluate_scale": evaluation,
        "train_fused_epochs": train_on["epochs"],
        "train_unfused_epochs": train_off["epochs"],
        "indel": indel,
        "snv_family": family,
        "transfer_search": later,
        "genome_wide": genome,
        "device_fed": fed,
        "k2_k3_bf16": {k: v for k, v in k23_bf16.items() if k != "timings"},
        "mixed_ensembles": mixed,
        "parallel": parallel,
        "cache": cached,
        "n_sites": args.n_sites, "n_train": args.n_train,
        "n_indel_sites": INDEL_SITES,
        "n_indel_train": INDEL_TRAIN, "batch": BATCH,
        "train_batch": TRAIN_BATCH, "phase_s": phase_s,
        "timed_with_cuda_events": TIMED_WITH_EVENTS,
        "total_s": time.perf_counter() - t_start}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
