"""Genome-wide map cells: ``run_genome_predict`` (``predict/genome_wide.py``,
the function behind ``mural_snv predict_genome`` and ``mural_indel
predict_genome``) on a genome made from the seed.

Set-up writes the genome as FASTA and the checkpoint triple (weights
drawn on the device, the configuration, a FullDirichlet calibrator) into
a fresh directory under ``$TMPDIR``, and calls ``run_genome_predict``
with the cell's options.  The harness watches the call through two
hooks that change nothing it computes: the farm class, whose instance it
keeps to read the rows it has written (``PostprocessFarm.total``), and
the generator of the genome's batches, which it passes through.  Set-up
ends once the farm has written ``warm_sites`` rows (its workers are up
and the forward has run every shape) and another ``warm_sites`` sites
have been fed (the pipeline is full): then the window opens.  The window
closes at the first batch after ``--seconds``.  The farm writes a chunk
at a time, so the rate is taken between two writes: the rows written
from the farm's first write after the window opened to its last before
it closed, over the time between those two writes.  The generator then
ends, and the program drains and closes the farm outside the window.
After the call a sample of the written rows, drawn from the seed, is
judged against the plain reference.
"""

from __future__ import annotations

import gzip
import pickle
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from harness import checks as ck
from harness import gen
from harness.outcome import Outcome
from harness.trace import Tracer
from reference import calib as rcal
from reference import data as rdata
from reference.models import build_reference

CHROM = "chr1"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_fasta(path: Path, codes: np.ndarray, line: int = 1 << 20) -> None:
    letters = np.frombuffer(rdata.BASES, np.uint8)[codes]
    with open(path, "wb") as fh:
        fh.write(f">{CHROM}\n".encode())
        for lo in range(0, len(letters), line):
            fh.write(letters[lo:lo + line].tobytes() + b"\n")


class Inputs:
    """The genome, weights and calibrator of one run, written where the
    program reads them."""

    def __init__(self, cell, seed: int, device, work: Path, n_bases: int):
        from mural_tpu_torch.calibrate.dirichlet import \
            FullDirichletCalibrator
        cfg = self.cfg = cell.config
        self.codes = gen.genome(seed, n_bases, device)
        self.fasta = work / "genome.fa"
        write_fasta(self.fasta, self.codes)
        self.n_cat = (2 * cfg["local_radius"] + 1 - cfg["local_order"] + 1
                      if cfg["model_type"] == "snv" else 0)
        self.weights = {k: v.cpu() for k, v in calibrated_weights(
            cfg, self.n_cat, seed, self.codes, device).items()}
        self.model_path = work / "model"
        torch.save(self.weights, self.model_path)
        config = dict(cfg)
        vocab = 4 ** cfg["local_order"] + 1
        config.update(n_cont=0, emb_dims=[(vocab, min(16, int(vocab ** 0.25)))]
                      * self.n_cat)
        with open(str(self.model_path) + ".config.pkl", "wb") as fh:
            pickle.dump(config, fh)
        self.cal_weights = gen.calibrator_weights(seed, cfg["n_class"])
        with open(str(self.model_path) + ".fdiri_cal.pkl", "wb") as fh:
            pickle.dump(FullDirichletCalibrator.from_weights(
                self.cal_weights), fh)


def calibrated_weights(cfg, n_cat: int, seed: int, codes: np.ndarray,
                       device, n: int = 1024):
    """A trained model's stand-in: weights drawn from the seed, then every
    BatchNorm's running statistics set to those of ``n`` sites of the
    genome (drawn from the seed), as training leaves them, so that the
    eval-mode forward is normalised as a trained model's is."""
    model = build_reference(cfg, n_cat)
    model.load_state_dict(gen.weights(model, seed, device, trained=True))
    model.to(device)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.reset_running_stats()
            m.momentum = None                   # a plain average
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    pos, neg = rdata.focal_sites(codes, cfg["focal_base"])
    rows = np.random.default_rng(gen.stream(seed, "bn")).choice(
        len(pos), n, replace=False)
    p, ng = pos[rows], neg[rows]
    dwin = rdata.windows(codes, p, ng, cfg["distal_radius"],
                         cfg["model_type"])
    lwin = rdata.windows(codes, p, ng, cfg["local_radius"],
                         cfg["model_type"])
    with torch.no_grad():
        model(torch.from_numpy(rdata.kmer_ids(lwin, cfg["local_order"]))
              .to(device), torch.from_numpy(rdata.one_hot(dwin))
              .to(device, torch.float32))
    return model.state_dict()


def reference_probs(inputs: Inputs, pos, neg, device, dtype=torch.float64,
                    tf32: bool = False, block: int = 512) -> np.ndarray:
    """What the plain reference writes for the sites ``pos``/``neg``: the
    model's output in eval mode, softmax, calibration, and for INDEL
    models the Poisson calibration; float64 ``(n, n_class)``."""
    cfg = inputs.cfg
    model = build_reference(cfg, inputs.n_cat)
    model.load_state_dict(inputs.weights)
    model.to(device, dtype).eval()
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    out = []
    try:
        with torch.no_grad():
            for lo in range(0, len(pos), block):
                p, n = pos[lo:lo + block], neg[lo:lo + block]
                dwin = rdata.windows(inputs.codes, p, n,
                                     cfg["distal_radius"], cfg["model_type"])
                lwin = rdata.windows(inputs.codes, p, n,
                                     cfg["local_radius"], cfg["model_type"])
                cat = torch.from_numpy(rdata.kmer_ids(lwin,
                                                      cfg["local_order"]))
                onehot = torch.from_numpy(rdata.one_hot(dwin))
                logits = model(cat.to(device), onehot.to(device, dtype))
                out.append(logits.double().cpu().numpy())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    probs = rcal.full_dirichlet(rcal.softmax(np.concatenate(out)),
                                inputs.cal_weights)
    return rcal.poisson(probs) if cfg["poisson"] else probs


def read_rows(path: Path, rows: np.ndarray):
    """(n_rows in the file, the fields of each row in ``rows``)."""
    with gzip.open(path, "rb") as fh:      # one pass over every member
        data = fh.read()
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    # line 0 is the header
    fields = [data[starts[r + 1]:ends[r + 1]].decode().split("\t")
              for r in rows]
    return len(ends) - 1, fields


def judge(inputs: Inputs, pred: Path, fed: int, seed: int, n_check: int,
          device):
    """The numbers that decide ``correct``: rows in the file against the
    sites fed to the program, sampled rows whose site is not the one the
    reference expects at that line, and the largest gap of a written
    probability beyond its ``%.4g`` rounding."""
    pos_all, neg_all = rdata.focal_sites(inputs.codes,
                                         inputs.cfg["focal_base"])
    rng = np.random.default_rng(gen.stream(seed, "check"))
    rows = np.sort(rng.choice(fed, min(n_check, fed), replace=False))
    n_rows, fields = read_rows(pred, rows)
    pos, neg = pos_all[rows], neg_all[rows]
    expect = [[CHROM, str(p), str(p + 1), "-" if n else "+", "0"]
              for p, n in zip(pos.tolist(), neg.tolist())]
    wrong_site = sum(f[:5] != e for f, e in zip(fields, expect))
    written = np.array([[float(x) for x in f[5:]] for f in fields])
    exact = reference_probs(inputs, pos, neg, device)
    return {"rows_missing": float(abs(n_rows - fed)),
            "sites_mismatched": float(wrong_site),
            "prob_gap": rcal.excess_gap(written, exact,
                                        inputs.cfg["poisson"])}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Outcome:
    from mural_tpu_torch.predict import genome_wide as gw
    cfg, tr = cell.config, cell.traffic
    work = Path(tempfile.mkdtemp(prefix="genome_cell_"))
    n_bases = int(cfg["map_bases_per_s"] * (seconds + tr["spare_seconds"]))
    inputs = Inputs(cell, seed, device, work, n_bases)
    farms = []

    class WatchedFarm(gw.PostprocessFarm):
        """The program's farm, with the time of each change of its row
        count noted (the count changes once per chunk written)."""

        @property
        def total(self):
            return self._total

        @total.setter
        def total(self, value):
            self._total = value
            self.writes.append((time.perf_counter(), value))

        def __init__(self, *args, **kwargs):
            self.writes = []
            super().__init__(*args, **kwargs)
            farms.append(self)

    clock = {}
    tracer = Tracer() if trace else None
    feed = gw._host_batches
    warm = tr["warm_sites"]

    def watched_batches(*args, **kwargs):
        fed, stage, trace_end, refill_from = 0, "fill", None, 0
        for item in feed(*args, **kwargs):
            now = time.perf_counter()
            if stage == "fill" and farms[0].total >= warm:
                # the farm has written rows: its workers are up
                stage, refill_from = "refill", fed
            elif stage == "refill" and fed - refill_from >= warm:
                clock["t0"] = now
                clock["setup_s"] = time.time() - t_process
                stage = "window"
            elif stage == "window":
                if trace_end is not None:
                    if now < trace_end:
                        clock["traced"] += 1
                    else:
                        _sync(device)
                        tracer.end(units=clock["traced"])
                        trace_end = None
                if (trace_end is None and tracer is not None
                        and tracer.wanted
                        and now - clock["t0"] > 0.4 * seconds):
                    _sync(device)
                    clock.setdefault("trace_t", time.perf_counter())
                    tracer.begin()
                    clock["traced"] = 1
                    trace_end = time.perf_counter() + tracer.length(seconds)
                if now - clock["t0"] >= seconds and trace_end is None:
                    clock["t1"], clock["fed"] = now, fed
                    return
            fed += item[2]
            yield item
        raise RuntimeError(
            f"the genome's {n_bases} bases ran out before the window "
            f"closed: raise map_bases_per_s in {cell.config_name}")

    opts = gw.GenomePredictOptions(
        ref_genome=str(inputs.fasta), model_path=str(inputs.model_path),
        model_config_path=str(inputs.model_path) + ".config.pkl",
        calibrator_path=str(inputs.model_path) + ".fdiri_cal.pkl",
        pred_file=str(work / "pred.tsv.gz"), poisson_calib=cfg["poisson"],
        focal_base=cfg["focal_base"], batch_size=tr["batch_size"],
        flush_batches=tr.get("flush_batches"), n_workers=tr.get("n_workers"),
        fused_inference=tr["fused_inference"], device=device)
    gw.PostprocessFarm, gw._host_batches = WatchedFarm, watched_batches
    try:
        total = gw.run_genome_predict(opts, cfg["model_type"],
                                      printer=_stderr)
        # the program's peak, before the reference runs on the card
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        out_bytes = (work / "pred.tsv.gz").stat().st_size
        found = judge(inputs, work / "pred.tsv.gz", clock["fed"], seed,
                      tr["check_sites"], device)
    finally:
        gw.PostprocessFarm, gw._host_batches = WatchedFarm.__base__, feed
        shutil.rmtree(work)
    # the window runs from the farm's first write after it opened to its
    # last write before it closed
    writes = [(t, n) for t, n in farms[0].writes
              if clock["t0"] <= t <= clock["t1"]]
    if len(writes) < 2:
        raise RuntimeError(f"the farm wrote {len(writes)} chunks in the "
                           "window: lengthen it")
    window_s = writes[-1][0] - writes[0][0]
    done = writes[-1][1] - writes[0][1]
    # a traced run's untraced pace: its writes before the profiler began
    before = [(t, n) for t, n in writes if t <= clock.get("trace_t", 0)]
    untraced = ((before[-1][1] - before[0][1]) / (before[-1][0] - before[0][0])
                if len(before) >= 2 else done / window_s)
    found["rows_missing"] = max(found["rows_missing"],
                                float(abs(total - clock["fed"])))
    checks = [ck.Check(name, float(found[name]), float(limit))
              for name, limit in cell.limits.items()]
    return Outcome(
        setup_s=clock["setup_s"], window_s=window_s,
        rates={"predict_sites_per_s": done / window_s},
        attempted=int(done), failed=0, checks=checks,
        memory_peak_bytes=int(peak),
        stretch=tracer.stretch if tracer else None,
        facts={"kind": "predict", "batch": tr["batch_size"],
               "rate": untraced, "sites_written": int(total),
               "chunks_in_window": len(writes) - 1,
               "output_bytes": int(out_bytes)})


def _stderr(*args, **kwargs):
    import sys
    print(*args, file=sys.stderr, flush=True)
