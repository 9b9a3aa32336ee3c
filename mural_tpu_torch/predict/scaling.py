"""Mutation-rate scaling (counterpart of ``mural_tpu/predict/scaling.py``;
ref MuRaL/scripts/scaling.py).

``apply_scaling``: multiply the mutated-class probabilities by a factor
and reset prob0 = 1 - sum(mutated) (:11-29).  ``calc_mu_scaling_factor``:
factor = genomewide_mu * n_sites * m_proportion / g_proportion / sum of
predicted mutated probability, optionally restricted to benchmark
regions (:44-107).  The pybedtools intersect is a numpy interval-overlap
test.  Prediction files are read with
:func:`mural_tpu_torch.utils.tsv.read_pred_chunks` and written with
:func:`mural_tpu_torch.utils.tsv.write_tsv`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mural_tpu_torch.utils.tsv import open_text, read_pred_chunks, write_tsv


def apply_scaling(pred_file: str, scale_factor: float, n_class: int,
                  out_file: str) -> None:
    chunks = list(read_pred_chunks(pred_file, n_class))
    cols = {name: np.concatenate([c[name] for c in chunks])
            for name in chunks[0]}
    mutated = np.stack([cols[f"prob{i}"] for i in range(1, n_class)],
                       axis=1) * scale_factor
    for i in range(1, n_class):
        cols[f"prob{i}"] = mutated[:, i - 1]
    # pandas' row sum skips NaN
    cols["prob0"] = 1 - np.nansum(mutated, axis=1)
    write_tsv(out_file, cols)


def scaling_files(pred_files: List[str], scale_factors: List[float],
                  n_class: int, out_files: List[str]) -> None:
    for pred_file, factor, out_file in zip(pred_files, scale_factors,
                                           out_files):
        apply_scaling(pred_file, factor, n_class, out_file)


def _load_regions(bed_path: str) -> Dict[str, np.ndarray]:
    """chrom -> sorted (n, 2) interval array."""
    per: Dict[str, List] = {}
    with open_text(bed_path) as fh:
        for line in fh:
            if not line.strip() or line.startswith(("#", "track")):
                continue
            f = line.split()
            per.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    out = {}
    for c, v in per.items():
        iv = np.asarray(sorted(v), dtype=np.int64)
        # merge overlapping/nested intervals so the membership test below
        # is exact (equivalent to bedtools intersect for overlap queries)
        merged = [iv[0].tolist()]
        for s_, e_ in iv[1:]:
            if s_ <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e_)
            else:
                merged.append([s_, e_])
        out[c] = np.asarray(merged, dtype=np.int64)
    return out


def _in_regions(chroms, starts, ends, regions: Dict[str, np.ndarray]
                ) -> np.ndarray:
    """True where [start, end) overlaps any region (bedtools intersect
    default semantics: >= 1bp overlap)."""
    mask = np.zeros(len(starts), dtype=bool)
    chroms = np.asarray(chroms)
    for c in np.unique(chroms):
        iv = regions.get(c)
        m = chroms == c
        if iv is None or not len(iv):
            continue
        s, e = starts[m], ends[m]
        # intervals are merged and disjoint: the only candidate is the
        # last region starting before the site's end
        idx = np.searchsorted(iv[:, 0], e - 1, side="right") - 1
        ok = idx >= 0
        hit = np.zeros(m.sum(), dtype=bool)
        hit[ok] = iv[idx[ok], 1] > s[ok]
        mask[m] = hit
    return mask


def _mutated_mass(pred_file: str, n_class: int, regions) -> np.ndarray:
    """Per-site sum of the mutated-class probabilities (NaN as 0), of the
    sites inside ``regions`` when given."""
    parts = []
    for frame in read_pred_chunks(pred_file, n_class):
        score = np.nansum(np.stack([frame[f"prob{j}"]
                                    for j in range(1, n_class)], axis=1),
                          axis=1)
        if regions is not None:
            score = score[_in_regions(frame["chrom"], frame["start"],
                                      frame["end"], regions)]
        parts.append(score)
    return np.concatenate(parts)


def calc_mu_scaling_factor(pred_files: List[str], genomewide_mu: float,
                           m_proportions: List[float],
                           n_class: int, model_type: str = "snv",
                           g_proportions: Optional[List[float]] = None,
                           benchmark_regions: Optional[str] = None,
                           do_scaling: bool = False,
                           printer=print) -> float:
    if g_proportions is None or model_type != "snv":
        g_proportions = [1] * len(pred_files)
    if len(m_proportions) != len(pred_files):
        raise ValueError("length of proportions does not equal to length "
                         "of pred_files!")
    regions = _load_regions(benchmark_regions) if benchmark_regions else None

    scale_factor = None
    for i, pred_file in enumerate(pred_files):
        # one sum over all sites, as the reference sums its whole column
        score = _mutated_mass(pred_file, n_class, regions)
        prob_sum = float(np.sum(score))
        n_sites = len(score)
        if prob_sum == 0.0:
            raise ValueError(
                f"no prediction mass selected from {pred_file} "
                f"({n_sites} sites matched"
                + (f" benchmark regions {benchmark_regions} -- check "
                   f"that chromosome naming matches the prediction "
                   f"file (e.g. 'chr1' vs '1')" if regions is not None
                   else "") + ")")
        scale_factor = (genomewide_mu * n_sites * m_proportions[i]
                        / g_proportions[i]) / prob_sum
        printer(f"\nType {i + 1}:\npred_file: {pred_file}")
        printer("genomewide_mu:", genomewide_mu)
        printer("n_sites:", n_sites)
        printer("g_proportion:", g_proportions[i])
        printer("m_proportion:", m_proportions[i])
        printer("prob_sum: %.3e" % prob_sum)
        printer("scaling factor: %.3e" % scale_factor)
        if do_scaling:
            apply_scaling(pred_file, scale_factor, n_class,
                          pred_file + ".scaled.tsv.gz")
    return scale_factor
