"""File-level evaluation pipelines of the ``evaluate`` sub-command
(counterpart of ``mural_tpu/evaluation/corr_files.py``).

Re-implements the reference's streaming scripts with chunked, vectorised
per-chromosome processing over the uint8 genome codes:

- k-mer correlation      (MuRaL/scripts/calc_kmer_corr.py:194-271)
- regional correlation   (calc_regional_corr.py:168-213)
- motif correlation      (calc_motif_corr.py:191-260)

Prediction TSVs stream in chunks of ``mural_tpu_torch.utils.tsv.
CHUNK_ROWS`` rows (the inputs are genome-wide, up to billions of rows),
accumulating obs counts and prob sums per k-mer or window like the
reference's line loops.  Output file names and column schemas match the
reference: ``<prefix>.<k>-mer.mut_rates.tsv`` / ``.corr.txt``,
``<prefix>.<N>Kb.mut_rates.tsv`` / ``.corr.txt``,
``<prefix>.<k>-motif.mut_rates.tsv`` / ``.corr.txt``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.fasta import COMPLEMENT, Genome, decode_sequence
from mural_tpu_torch.utils.tsv import Frame, read_pred_chunks


def _extend_interval(start, stop, left, right, model_type):
    """(ref preprocessing.py:559-567) asymmetric-radius window."""
    if model_type == "snv":
        return start - left, stop + right
    return start - left + 1, stop + right


def _gather_kmers(genome: Genome, frame: Frame, left: int, right: int,
                  width: int, model_type: str):
    """Per-row k-mer codes (n, width) plus validity mask (ACGT-only and
    fully inside the chromosome)."""
    chroms = frame["chrom"]
    n = len(chroms)
    out = np.full((n, width), 14, dtype=np.uint8)
    inside = np.zeros(n, dtype=bool)
    s0, e0 = _extend_interval(frame["start"], frame["end"], left, right,
                              model_type)
    for c in np.unique(chroms):
        m = chroms == c
        if c not in genome:
            continue
        codes = genome[c]
        out[m] = enc.gather_windows(codes, s0[m], width,
                                    np.zeros(m.sum(), bool))
        inside[m] = (s0[m] >= 0) & (s0[m] + width <= len(codes))
    # rows whose own window length differs from the k-mer width (e.g.
    # multi-base INDEL gap rows, end - start > 1) are skipped like the
    # reference's len(seq) != kmer_length check (calc_kmer_corr.py:
    # 235-241) rather than scored with a start-anchored wrong window
    valid = inside & (e0 - s0 == width) & (out < 4).all(axis=1)
    return out, valid


def _pack(codes: np.ndarray) -> np.ndarray:
    key = np.zeros(len(codes), dtype=np.int64)
    for j in range(codes.shape[1]):
        key = key * 4 + codes[:, j]
    return key


def _revcomp_key(codes: np.ndarray) -> np.ndarray:
    return _pack(COMPLEMENT[codes][:, ::-1])


def _key_to_kmer(key: int, k: int) -> str:
    digits = []
    for _ in range(k):
        digits.append(key % 4)
        key //= 4
    return decode_sequence(np.asarray(digits[::-1], dtype=np.uint8))


def _probs(frame: Frame, n_class: int) -> np.ndarray:
    return np.stack([frame[f"prob{i}"] for i in range(n_class)], axis=1)


class _Accumulator:
    """Per-key obs counts and prob sums (chunk-incremental)."""

    def __init__(self, n_keys: int, n_class: int):
        self.obs = np.zeros((n_keys, n_class))
        self.pred = np.zeros((n_keys, n_class))
        self.n_class = n_class

    def add(self, keys, mut, probs):
        n_keys = self.obs.shape[0]
        for i in range(self.n_class):
            self.obs[:, i] += np.bincount(
                keys, weights=(mut == i).astype(np.float64),
                minlength=n_keys)
            self.pred[:, i] += np.bincount(keys, weights=probs[:, i],
                                           minlength=n_keys)


def _rates(obs: np.ndarray, pred: np.ndarray, n_class: int) -> Frame:
    """The mut_rates.tsv rate and count columns
    (ref calc_kmer_corr.py:124-163 / calc_regional_corr.py:83-140)."""
    total = obs.sum(axis=1)
    out = {}
    for i in range(1, n_class):
        out[f"avg_obs_rate{i}"] = obs[:, i] / total
    for i in range(1, n_class):
        out[f"avg_pred_rate{i}"] = pred[:, i] / total
    for i in range(1, n_class):
        out[f"number_of_mut{i}"] = obs[:, i].astype(np.int64)
    out["number_of_all"] = total.astype(np.int64)
    return out


def _cell(v) -> str:
    """A field as pandas' ``to_csv`` writes it: float64 as its shortest
    round-trip repr (NaN empty), ints and strings as ``str``."""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def _write_rates(path: str, cols: Frame) -> None:
    names = list(cols)
    columns = [cols[n] for n in names]
    with open(path, "w") as fh:
        fh.write("\t".join(names) + "\n")
        for row in zip(*columns):
            fh.write("\t".join(_cell(v) for v in row) + "\n")


def _correlations(cols: Frame, n_class: int, rows=slice(None)
                  ) -> Dict[int, Tuple[float, float]]:
    from scipy.stats import pearsonr
    return {i: tuple(pearsonr(cols[f"avg_obs_rate{i}"][rows],
                              cols[f"avg_pred_rate{i}"][rows]))
            for i in range(1, n_class)}


def _write_corr(path: str, tag: str, corr, printer) -> None:
    with open(path, "w") as fh:
        for subtype, (c, p) in corr.items():
            fh.write(f"{tag}\t{subtype}\t{c:.5f}\t{p:.10e}\n")
    for subtype, (c, p) in corr.items():
        printer(f"{tag} subtype {subtype}: r={c:.5f} p={p:.3e}")


def _kmer_table(acc: _Accumulator, k: int, n_class: int) -> Frame:
    present = np.flatnonzero(acc.obs.sum(axis=1) > 0)
    cols = {"type": np.asarray([_key_to_kmer(i, k) for i in present])}
    cols.update(_rates(acc.obs[present], acc.pred[present], n_class))
    return cols


def run_kmer_corr(pred_file: str, ref_genome: str, out_prefix: str,
                  kmer_length: int, n_class: int, model_type: str = "snv",
                  strand_override: Optional[str] = None, genome=None,
                  printer=print) -> Dict[int, Tuple[float, float]]:
    """k-mer obs/pred correlation (ref calc_kmer_corr.py).

    ``strand_override``: INDEL mode replaces per-row strand with the CLI
    --strand value ('+', '-' or 'both'; ref :223-224)."""
    if model_type == "indel":
        # INDEL windows span the gap: width = 2*(k//2) needs EVEN k
        # (reference defaults 2/4/6, MuRaL/commands/evaluate.py:146)
        if kmer_length <= 0 or kmer_length % 2 != 0:
            raise ValueError("--kmer_length must be a positive even "
                             "integer for INDEL evaluation")
    elif kmer_length <= 1 or kmer_length % 2 != 1:
        raise ValueError("--kmer_length must be a positive odd integer >1")
    genome = genome or Genome.from_fasta(ref_genome)
    radius = kmer_length // 2
    acc = _Accumulator(4 ** kmer_length, n_class)

    for frame in read_pred_chunks(pred_file, n_class):
        codes, valid = _gather_kmers(genome, frame, radius, radius,
                                     kmer_length, model_type)
        mut, probs = frame["mut_type"], _probs(frame, n_class)
        if strand_override and model_type == "indel":
            strand = np.full(len(mut), strand_override)
        else:
            strand = frame["strand"]
        fwd_key = _pack(codes)
        rev_key = _revcomp_key(codes)
        plus = valid & ((strand == "+") | (strand == "both"))
        minus = valid & ((strand == "-") | (strand == "both"))
        if plus.any():
            acc.add(fwd_key[plus], mut[plus], probs[plus])
        if minus.any():
            acc.add(rev_key[minus], mut[minus], probs[minus])

    rates = _kmer_table(acc, kmer_length, n_class)
    corr = _correlations(rates, n_class)
    _write_rates(f"{out_prefix}.{kmer_length}-mer.mut_rates.tsv", rates)
    _write_corr(f"{out_prefix}.{kmer_length}-mer.corr.txt",
                f"{kmer_length}-mer", corr, printer)
    return corr


def _first_seen_windows(chroms: np.ndarray, window_end: np.ndarray
                        ) -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    """Per-row ids of the distinct (chrom, window_end) pairs of a chunk,
    numbered in first-seen order, and the pairs in that order."""
    names, chrom_id = np.unique(chroms, return_inverse=True)
    chrom_id = chrom_id.ravel().astype(np.int64)
    span = int(window_end.max() - window_end.min()) + 1
    pair = chrom_id * span + (window_end - window_end.min())
    _, first, inverse = np.unique(pair, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first)               # uniques by first appearance
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    uniques = [(str(names[chrom_id[first[j]]]), int(window_end[first[j]]))
               for j in order]
    return rank[inverse.ravel()], uniques


def run_regional_corr(pred_file: str, out_prefix: str, window_size: int,
                      ratio_cutoff: float, n_class: int,
                      printer=print) -> Dict[int, Tuple[float, float]]:
    """Regional obs/pred correlation with median-based window filtering
    (ref calc_regional_corr.py:168-213).  Streams the prediction file;
    windows are keyed by (chrom, window_end) like the reference's dict,
    in first-seen order."""
    key_index: Dict[Tuple[str, int], int] = {}
    obs = np.zeros((0, n_class))
    pred = np.zeros((0, n_class))

    for frame in read_pred_chunks(pred_file, n_class):
        window_end = (frame["start"] // window_size * window_size
                      + window_size)
        codes, uniques = _first_seen_windows(frame["chrom"], window_end)
        gids = np.asarray([key_index.setdefault(u, len(key_index))
                           for u in uniques], dtype=np.int64)
        if len(key_index) > obs.shape[0]:
            grow = len(key_index) - obs.shape[0]
            obs = np.vstack([obs, np.zeros((grow, n_class))])
            pred = np.vstack([pred, np.zeros((grow, n_class))])
        g = gids[codes]
        mut, probs = frame["mut_type"], _probs(frame, n_class)
        for i in range(n_class):
            obs[:, i] += np.bincount(g, weights=(mut == i).astype(float),
                                     minlength=obs.shape[0])
            pred[:, i] += np.bincount(g, weights=probs[:, i],
                                      minlength=obs.shape[0])
    keys = list(key_index)
    out = {"chrom": np.asarray([k[0] for k in keys]),
           "window_end": np.asarray([k[1] for k in keys], dtype=np.int64)}
    out.update(_rates(obs, pred, n_class))

    cutoff = ratio_cutoff * np.median(out["number_of_all"])
    used = out["number_of_all"] >= cutoff
    out["used_or_deprecated"] = np.where(used, "used", "deprecated")
    corr = _correlations(out, n_class, used)

    kb = f"{window_size // 1000}Kb"
    _write_rates(f"{out_prefix}.{kb}.mut_rates.tsv", out)
    _write_corr(f"{out_prefix}.{kb}.corr.txt", kb, corr, printer)
    return corr


def run_motif_corr(pred_file: str, ref_genome: str, out_prefix: str,
                   motif_length: int, n_class: int,
                   model_type: str = "indel", merge_reverse: bool = True,
                   genome=None, printer=print
                   ) -> Dict[int, Tuple[float, float]]:
    """Motif correlation: every motif placement covering the site counts
    (ref calc_motif_corr.py:191-260).  Reverse-complement motif pairs are
    merged into one canonical key, the lexicographically smaller one (the
    reference merges into whichever orientation it saw first, :48-69;
    the partition, and so the correlations, are the same)."""
    if model_type == "indel":
        # gap-spanning placements (left + right == motif_length) work
        # for any length >= 2; the reference default is 6
        if motif_length < 2:
            raise ValueError("--motif_length must be an integer >=2")
    elif motif_length <= 1 or motif_length % 2 != 1:
        raise ValueError("--motif_length must be a positive odd integer >1")
    genome = genome or Genome.from_fasta(ref_genome)

    if model_type == "indel":
        placements = [(i, motif_length - i) for i in range(1, motif_length)]
    else:
        placements = [(i, motif_length - 1 - i) for i in range(motif_length)]

    acc = _Accumulator(4 ** motif_length, n_class)
    for frame in read_pred_chunks(pred_file, n_class):
        mut, probs = frame["mut_type"], _probs(frame, n_class)
        for left, right in placements:
            codes, valid = _gather_kmers(genome, frame, left, right,
                                         motif_length, model_type)
            if not valid.any():
                continue
            key = _pack(codes[valid])
            if merge_reverse:
                key = np.minimum(key, _revcomp_key(codes[valid]))
            acc.add(key, mut[valid], probs[valid])

    rates = _kmer_table(acc, motif_length, n_class)
    corr = _correlations(rates, n_class)
    _write_rates(f"{out_prefix}.{motif_length}-motif.mut_rates.tsv", rates)
    _write_corr(f"{out_prefix}.{motif_length}-motif.corr.txt",
                f"{motif_length}-motif", corr, printer)
    return corr
