#!/usr/bin/env python3
"""Smoke run of mural_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n_sites 200000]

Phases (any failure raises and the script exits non-zero):

1. setup: print the card's name and power limit, build the CUDA kernel
   K1 (``mural_tpu_torch/ops/csrc/code_conv1d.cu``) with nvcc, write a
   synthetic FASTA and BED from ``--seed``, and write a checkpoint triple
   with the port itself: SNVNet2 at the CLI default widths with seeded
   weights, randomised BN statistics and a seeded FullDirichlet
   calibrator;
2. K1 against its plain PyTorch version on the card at the main path's
   shapes (max |diff| <= 1e-5), with timings of the kernel, the plain
   version and one library call computing the same function
   (``F.conv1d`` on a prepared one-hot; a yardstick the port never
   calls) beside the kernel's bound;
3. the BN-folded fused forward (through K1) against the unfused SNVNet2
   on one batch of 4096 (<= 1e-4), and the card's unfused forward
   against the CPU's on a small batch (<= 1e-4);
4. ``mural_snv predict --fused_inference --pred_batch_size 4096`` through
   the CLI on the synthetic triple: TSV schema, row count, probabilities
   summing to 1, K1 launched twice per batch; then the same without
   ``--fused_inference``, whose rows must agree within ``%.4g``;
5. a JSON line of the kernels and a timing line.

The last line of standard output is the device record
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.  Scratch files go to ``build/chip_smoke/`` beside this script
and are removed at the end.
"""

from __future__ import annotations

import argparse
import gzip
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TOL_KERNEL = 1e-5       # K1 vs plain: both sum the same f32 terms in order
TOL_MODEL = 1e-4        # folded vs unfused forward: f32 reassociation
BATCH = 4096
# the reference CLI's SNVNet2 defaults (mural_snv train)
CONFIG = dict(
    model_no=2, n_class=4, local_radius=7, local_order=3,
    local_hidden1_size=150, local_hidden2_size=75, emb_dropout=0.1,
    local_dropout=0.1, distal_fc_dropout=0.25, distal_radius=200,
    CNN_kernel_size=3, CNN_out_channels=32, segment_center=300000,
    distal_order=1, n_cont=0, emb_dims=[(65, 2)] * 13)


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


def write_inputs(work: Path, rng: np.random.Generator, n_sites: int):
    """Synthetic genome (two chromosomes, ~4 Mb) and a sorted BED of SNV
    sites: A under '+' rows, T under '-' rows."""
    from mural_tpu_torch.genome.fasta import decode_sequence
    fasta, bed = work / "seq.fa", work / "sites.bed"
    chroms = {"chr1": 3_000_000, "chr2": 1_000_000}
    per_chrom = {"chr1": n_sites * 3 // 4}
    per_chrom["chr2"] = n_sites - per_chrom["chr1"]
    lines = []
    with open(fasta, "w") as fh:
        for chrom, n in chroms.items():
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            codes[rng.integers(0, n, size=n // 1000)] = 14      # N
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")
            k = per_chrom[chrom]
            plus = rng.choice(np.flatnonzero(codes == 0), k // 2,
                              replace=False)
            minus = rng.choice(np.flatnonzero(codes == 3), k - k // 2,
                               replace=False)
            pos = np.concatenate([plus, minus])
            strand = np.array(["+"] * len(plus) + ["-"] * len(minus))
            order = np.argsort(pos, kind="stable")
            labels = rng.integers(0, 4, size=len(pos))
            lines += [f"{chrom}\t{p}\t{p + 1}\t.\t{y}\t{s}"
                      for p, s, y in zip(pos[order], strand[order],
                                         labels[order])]
    bed.write_text("\n".join(lines) + "\n")
    return str(fasta), str(bed)


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


def k1_bound(shapes, k, C):
    """Least time for K1's work on ``shapes`` [(B, L), ...]: the bytes it
    must move (codes in, table and bias in, f32 output out) over the
    memory rate, or its adds over the float32 rate, whichever is
    larger."""
    n_bytes = sum(B * L + B * L * C * 4 for B, L in shapes) \
        + len(shapes) * (k * 16 * C + C) * 4
    n_ops = sum(B * L * C * k for B, L in shapes)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(model, dev, gen):
    """K1 against its plain version and the library yardstick."""
    import torch
    import torch.nn.functional as F
    from mural_tpu_torch.ops import fused_code_conv as fcc
    stem = model.conv1_2
    with torch.no_grad():
        table, bias = fcc.fold_bn_conv_table(
            stem[1].weight, stem[1].bias, stem[0].weight, stem[0].bias,
            stem[0].running_mean, stem[0].running_var)
    k, _, C = table.shape
    full = torch.randint(0, 15, (BATCH, 401), generator=gen,
                         dtype=torch.uint8).to(dev)
    ragged = torch.randint(0, 15, (37, 401), generator=gen,
                           dtype=torch.uint8).to(dev)
    crop = full[:, 100:301]                     # tower 1: strided view
    cases = {f"{BATCH}x401": full, f"{BATCH}x201 crop": crop,
             "37x401": ragged}
    err = 0.0
    for name, codes in cases.items():
        out = fcc.code_conv1d(codes, table, bias)
        ref = fcc.code_conv1d_reference(codes, table, bias)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        log(f"K1 {name}: max |kernel - plain| = {e:.3g}")
        if not e <= TOL_KERNEL:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{name}: {e} > {TOL_KERNEL}")
        err = max(err, e)

    # the library yardstick: one conv over a prepared 16-channel one-hot
    p = (k - 1) // 2
    weight = table.permute(2, 1, 0).contiguous()            # (C, 16, k)

    def one_hot16(codes):
        padded = F.pad(codes.long(), (p, p), value=fcc.SENTINEL)
        return F.one_hot(padded, 16).float().transpose(1, 2).contiguous()

    oh_full, oh_crop = one_hot16(full), one_hot16(crop)
    lib = F.conv1d(oh_full, weight, bias)
    e_lib = (lib.transpose(1, 2) - fcc.code_conv1d(full, table, bias)
             ).abs().max().item()
    log(f"K1 vs F.conv1d yardstick: max |diff| = {e_lib:.3g}")
    if not e_lib <= TOL_KERNEL:
        raise AssertionError(f"F.conv1d yardstick disagrees: {e_lib}")

    # one predict batch runs K1 on both towers' shapes
    def batch_kernel():
        fcc.code_conv1d(full, table, bias)
        fcc.code_conv1d(crop, table, bias)

    def batch_plain():
        fcc.code_conv1d_reference(full, table, bias)
        fcc.code_conv1d_reference(crop, table, bias)

    def batch_library():
        F.conv1d(oh_full, weight, bias)
        F.conv1d(oh_crop, weight, bias)

    ms_k1, ms_plain, ms_lib = (cuda_ms(batch_kernel), cuda_ms(batch_plain),
                               cuda_ms(batch_library))
    per_shape = {}
    for name, codes, oh in ((f"{BATCH}x401", full, oh_full),
                            (f"{BATCH}x201 crop", crop, oh_crop)):
        per_shape[name] = {
            "ms": cuda_ms(lambda: fcc.code_conv1d(codes, table, bias)),
            "plain_ms": cuda_ms(
                lambda: fcc.code_conv1d_reference(codes, table, bias)),
            "library_ms": cuda_ms(lambda: F.conv1d(oh, weight, bias)),
            "bound_ms": k1_bound([tuple(codes.shape)], k, C)[0]}
    bound_ms, bound_by = k1_bound([(BATCH, 401), (BATCH, 201)], k, C)
    return {"max_abs_err": err, "ms": ms_k1, "plain_ms": ms_plain,
            "library_ms": ms_lib, "bound_ms": bound_ms,
            "bound_by": bound_by, "per_shape": per_shape}


def phase_model(model, dev, gen):
    """Fused (through K1) vs unfused forward on the card, and the card's
    unfused forward vs the CPU's."""
    import copy

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
                lambda: model(cat, one_hot_from_codes(codes)), iters=10)}
    return max(e, e_cpu), fwd_ms


def read_tsv(path):
    with gzip.open(path, "rt") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    keys = [r[:5] for r in rows]
    probs = np.asarray([[float(v) for v in r[5:]] for r in rows])
    return header, keys, probs


def phase_predict(work, fasta, bed, model_path, n_sites, cuda_id):
    """The main path, through the CLI, fused and unfused."""
    import torch
    from mural_tpu_torch.cli.mural_snv import main as cli
    from mural_tpu_torch.ops import fused_code_conv as fcc
    common = ["--ref_genome", fasta, "--test_data", bed,
              "--model_path", model_path,
              "--model_config_path", model_path + ".config.pkl",
              "--calibrator_path", model_path + ".fdiri_cal.pkl",
              "--pred_batch_size", str(BATCH), "--cuda_id", str(cuda_id),
              "--pred_time_view"]
    runs = {}
    for name, extra in (("fused", ["--fused_inference"]), ("unfused", [])):
        out = str(work / f"pred_{name}.tsv.gz")
        fcc.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli(["predict", *common, "--pred_file", out, *extra])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[name] = {"rc": rc, "seconds": seconds,
                      "sites_per_s": n_sites / seconds,
                      "launches": fcc.LAUNCHES, "tsv": read_tsv(out)}
        log(f"predict {name}: {seconds:.3f} s, "
            f"{n_sites / seconds:.1f} sites/s, K1 launches {fcc.LAUNCHES}")

    n_batches = math.ceil(n_sites / BATCH)
    fused, unfused = runs["fused"], runs["unfused"]
    header, keys, probs = fused["tsv"]
    want = ["chrom", "start", "end", "strand", "mut_type",
            "prob0", "prob1", "prob2", "prob3"]
    checks = {
        "exit codes 0": fused["rc"] == 0 and unfused["rc"] == 0,
        "TSV schema": header == want and unfused["tsv"][0] == want,
        f"{n_sites} rows": len(keys) == n_sites,
        "probabilities finite and summing to 1": bool(
            np.isfinite(probs).all()
            and np.abs(probs.sum(1) - 1).max() <= 1e-3),
        f"K1 launched 2 x {n_batches} batches":
            fused["launches"] == 2 * n_batches,
        "no K1 launch unfused": unfused["launches"] == 0,
        "same rows fused and unfused": keys == unfused["tsv"][1],
        # both files print %.4g: one unit in the 4th digit apart at most
        "probabilities agree within %.4g": bool(np.all(
            np.abs(probs - unfused["tsv"][2])
            <= 1.1e-3 * np.maximum(np.abs(probs),
                                   np.abs(unfused["tsv"][2])))),
    }
    for what, ok in checks.items():
        log(f"check {what}: {'ok' if ok else 'FAILED'}")
    failed = [what for what, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"predict checks failed: {failed}")
    return fused, unfused


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_sites", type=int, default=200_000)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from mural_tpu_torch.ops import fused_code_conv as fcc
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
    t0 = time.perf_counter()
    fcc.load_library()
    t_build = time.perf_counter() - t0
    log(f"K1 built and loaded in {t_build:.2f} s; nvcc said:\n"
        f"{fcc.BUILD_LOG.strip()}")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    fasta, bed = write_inputs(work, rng, args.n_sites)
    model_path, model = write_checkpoint(work, args.seed)
    log(f"synthetic inputs and checkpoint in {time.perf_counter() - t0:.2f}"
        f" s ({args.n_sites} sites)")

    # 2. kernel vs plain
    k1 = phase_kernel(model.to(dev).eval(), dev, gen)
    # 3. model on the card
    model_err, fwd_ms = phase_model(model, dev, gen)
    # 4. main path
    fused, unfused = phase_predict(work, fasta, bed, model_path,
                                   args.n_sites, dev.index or 0)
    shutil.rmtree(work, ignore_errors=True)

    # 5. results
    kernel = {
        "name": "code_conv1d", "route": "cuda",
        "source": "mural_tpu_torch/ops/csrc/code_conv1d.cu",
        "replaces": "mural_tpu/ops/fused_code_conv.py:115",
        "launches": fused["launches"],
        "max_abs_err": k1["max_abs_err"],
        "max_abs_diff": k1["max_abs_err"],
        "ms": k1["ms"], "kernel_ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "per": f"one predict batch: B={BATCH} at L=401 and the L=201 crop",
        "per_shape": k1["per_shape"],
    }
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({
        "card": card, "build_s": t_build,
        "model_max_abs_err": model_err, **fwd_ms,
        "predict_fused_s": fused["seconds"],
        "predict_fused_sites_per_s": fused["sites_per_s"],
        "predict_unfused_s": unfused["seconds"],
        "predict_unfused_sites_per_s": unfused["sites_per_s"],
        "n_sites": args.n_sites, "batch": BATCH,
        "total_s": time.perf_counter() - t_start}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
