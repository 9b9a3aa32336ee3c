"""Validation-time evaluation: k-mer and regional obs/pred correlations
(counterpart of ``mural_tpu/evaluation/evaluator.py``; ref
MuRaL/evaluation/evaluation.py:48-204, 489-588).

Frames are ``Dict[str, np.ndarray]`` of equal-length columns, as
``SiteDataset.local_frame()`` and ``position_frame()`` return them:

- ``freq_kmer_comp_multi``: per-class Pearson correlation of observed vs
  predicted mutation frequency across k-mer contexts (a radix-4 key and
  ``np.bincount`` in place of a groupby over the us/ds columns);
- ``corr_calc_sub``: windowed regional correlation with the reference's
  *sequential* window-change semantics (a new window starts whenever
  chrom or start//window changes in row order);
- ``Evaluator.evaluate_regional_score``: sum of (1-corr)^2 over ~10k-site
  bins for the two smallest k-mer sizes, plus per-bin average-rate
  correlations.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from mural_tpu_torch.utils.tsv import Frame, write_tsv


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    """pandas .corr-compatible Pearson (NaN for degenerate inputs)."""
    mask = np.isfinite(a) & np.isfinite(b)
    a, b = a[mask], b[mask]
    if len(a) < 2:
        return float("nan")
    sa, sb = a.std(), b.std()
    if sa == 0 or sb == 0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def _kmer_columns(k: int) -> List[str]:
    d = k // 2
    return ([f"us{i}" for i in range(d, 0, -1)]
            + [f"ds{i+1}" for i in range(d)])


def _kmer_keys(frame: Frame, k: int) -> np.ndarray:
    """Radix-4 key of each row's k-mer digits (clipped to 0..3)."""
    key = np.zeros(len(frame["mut_type"]), dtype=np.int64)
    for c in _kmer_columns(k):
        key = key * 4 + np.clip(np.asarray(frame[c]).astype(np.int64), 0, 3)
    return key


def _rows(frame: Frame, rows) -> Frame:
    return {name: col[rows] for name, col in frame.items()}


def kmer_comp_rand(frame: Frame, k: int, n_rows: int,
                   sampling_times: int = 10, rng=None,
                   printer=print) -> float:
    """Self-consistency diagnostic: Pearson correlation of observed
    k-mer mutation frequencies between two random subsamples of the
    same dataset, averaged over ``sampling_times`` draws (ref
    f3mer/f5mer/f7mer_comp_rand, evaluation.py:69-122, generalised over
    k).  High values mean ``n_rows`` sites suffice to estimate k-mer
    rates stably."""
    if rng is None:
        rng = np.random.default_rng()
    key = _kmer_keys(frame, k)
    mut = np.asarray(frame["mut_type"]).astype(np.float64)
    n_keys = 4 ** len(_kmer_columns(k))

    def sample_freq():
        idx = rng.choice(len(key), size=n_rows, replace=False)
        cnt = np.bincount(key[idx], minlength=n_keys)
        s = np.bincount(key[idx], weights=mut[idx], minlength=n_keys)
        present = cnt > 0
        return s[present] / cnt[present], present

    mean_corr = 0.0
    for _ in range(sampling_times):
        f1, p1 = sample_freq()
        f2, p2 = sample_freq()
        # align on k-mers present in both samples
        common = p1 & p2
        a = np.zeros(n_keys)
        b = np.zeros(n_keys)
        a[p1] = f1
        b[p2] = f2
        corr = _pearson(a[common], b[common])
        printer(f"corr of {k}mer freq1 and freq2:", corr)
        mean_corr += corr
    mean_corr /= sampling_times
    printer("mean corr:", mean_corr)
    return mean_corr


def freq_kmer_comp_multi(data_and_prob: Frame, k: int,
                         n_class: int) -> List[float]:
    """Observed vs predicted per-class rates across k-mer contexts.

    ``data_and_prob``: us*/ds* digit columns (0..3), ``mut_type`` and
    probN columns (ref evaluation.py:48-67).
    """
    key = _kmer_keys(data_and_prob, k)
    n_keys = 4 ** len(_kmer_columns(k))
    counts = np.bincount(key, minlength=n_keys)
    present = counts > 0
    cnt = counts[present].astype(np.float64)

    mut = np.asarray(data_and_prob["mut_type"]).astype(np.int64)
    corr_list = []
    for i in range(n_class):
        obs_sum = np.bincount(key, weights=(mut == i).astype(np.float64),
                              minlength=n_keys)[present]
        pred = np.asarray(data_and_prob[f"prob{i}"]).astype(np.float64)
        pred_sum = np.bincount(key, weights=pred, minlength=n_keys)[present]
        corr_list.append(_pearson(obs_sum / cnt, pred_sum / cnt))
    return corr_list


def corr_calc_sub(data: Frame, window: int, prob_names: Sequence[str]
                  ) -> List[float]:
    """Regional obs/pred correlation (ref evaluation.py:124-193).

    ``data`` must be sorted by chrom/start; windows are formed by
    *sequential* runs of identical (chrom, start//window) in row order,
    exactly as the reference's streaming loop.
    """
    n_class = len(prob_names)
    chrom = np.asarray(data["chrom"])
    wstart = (np.asarray(data["start"]).astype(np.int64) // window) * window
    mut = np.asarray(data["mut_type"]).astype(np.int64)
    probs = np.stack([np.asarray(data[p]).astype(np.float64)
                      for p in prob_names], axis=1)

    # sequential window boundaries
    change = np.ones(len(mut), dtype=bool)
    if len(mut) > 1:
        change[1:] = (chrom[1:] != chrom[:-1]) | (wstart[1:] != wstart[:-1])
    win_id = np.cumsum(change) - 1
    n_win = win_id[-1] + 1 if len(mut) else 0

    counts = np.bincount(win_id, minlength=n_win).astype(np.float64)
    corr_list = []
    for i in range(n_class):
        avg_obs = np.bincount(win_id, weights=(mut == i).astype(np.float64),
                              minlength=n_win) / counts
        avg_pred = np.bincount(win_id, weights=probs[:, i],
                               minlength=n_win) / counts
        degenerate = np.mean((avg_obs == 0) | (avg_obs == 1))
        if degenerate > 0.5:
            print(f"Warning: too many zeros/ones (>50%) in the obs windows "
                  f"of size {window} subtype {i}")
        if n_win >= 3:
            corr_list.append(_pearson(avg_obs, avg_pred))
        else:
            corr_list.append(0)
            print(f"Warning: too few windows for calculating correlation "
                  f"{window} subtype {i}")
    return corr_list


def calc_avg_prob(frame: Frame, n_class: int) -> List[float]:
    """Per-class observed fraction + mean predicted prob (ref :195-204)."""
    mut = np.asarray(frame["mut_type"]).astype(np.int64)
    out = [float(np.mean(mut == i)) for i in range(n_class)]
    out += [float(np.asarray(frame[f"prob{i}"]).mean())
            for i in range(n_class)]
    return out


def sort_by_position(frame: Frame) -> Frame:
    """Rows stably sorted by (chrom name, start)."""
    _, chrom_rank = np.unique(np.asarray(frame["chrom"]),
                              return_inverse=True)
    order = np.lexsort((np.asarray(frame["start"]), chrom_rank.ravel()))
    return _rows(frame, order)


class Evaluator:
    """Unified before/after-calibration reporting (ref evaluation.py:
    489-588).  ``data_local``: frame with us/ds (+mid) columns and
    ``mut_type``; ``y_prob``: (n, n_class) probabilities."""

    _KMER_ID = {
        "no_calibra": "mer correlation - all: ",
        "FullDiri": "mer correlation(after fdiri_cal)",
        "Poisson": "mer correlation(after Poisson_cal)",
    }
    _REGIONAL_ID = {
        "no_calibra": "regional corr (validation):",
        "FullDiri": "regional corr (validation, after fdiri_cal):",
        "Poisson": "regional corr (validation, after Poisson_cal):",
    }
    _CORRLIST_ID = {
        "no_calibra": "corr_list: ",
        "FullDiri": "corr_list(after fdiri_cal)",
        "Poisson": "corr_list(after Poisson_cal)",
    }
    _SCORE_ID = {
        "no_calibra": "regional score: ",
        "FullDiri": "regional score(after fdiri_cal)",
        "Poisson": "regional score(after Poisson_cal)",
    }

    def __init__(self, data_local: Frame, y_prob, n_class: int,
                 calibra: str = "no_calibra", printer=print):
        self.n_class = n_class
        self.prob_names = [f"prob{i}" for i in range(n_class)]
        self.printer = printer
        self.calibra = calibra
        probs = np.asarray(y_prob)
        self.data_and_prob = dict(data_local)
        for i, name in enumerate(self.prob_names):
            self.data_and_prob[name] = probs[:, i]
        self.metrics = {}

    def evaluate_kmer(self, kmer_list=(3, 5, 7)) -> dict:
        out = {}
        for k in kmer_list:
            missing = [c for c in _kmer_columns(k)
                       if c not in self.data_and_prob]
            if missing:
                # the reference crashes here when local_radius < k//2;
                # the k-mer size is skipped with a warning instead
                self.printer(f"Warning: skipping {k}-mer correlation "
                             f"(local_radius too small; missing columns "
                             f"{missing})")
                continue
            corr = freq_kmer_comp_multi(self.data_and_prob, k, self.n_class)
            out[k] = corr
            self.printer(f"{k}{self._KMER_ID[self.calibra]}", corr)
        self.metrics["kmer_corr"] = out
        return out

    def evaluate_regional_corr(self, chr_pos: Frame,
                               win_size_list=(100000, 500000),
                               save_valid_preds: bool = False,
                               save_path: Optional[str] = None) -> dict:
        frame = {name: np.asarray(chr_pos[name])
                 for name in ("chrom", "start", "end", "strand")}
        for name in ["mut_type"] + self.prob_names:
            frame[name] = self.data_and_prob[name]
        frame = sort_by_position(frame)
        out = {}
        for win in win_size_list:
            corr = corr_calc_sub(frame, win, self.prob_names)
            out[win] = corr
            self.printer(self._REGIONAL_ID[self.calibra],
                         f"{win}bp", corr)
        if save_valid_preds and save_path:
            write_tsv(save_path + ".valid_preds.tsv.gz", frame)
        self.metrics["regional_corr"] = out
        return out

    def evaluate_regional_score(self, valid_size: int,
                                kmer_list=(3, 5)) -> float:
        kmer_list = [k for k in kmer_list
                     if all(c in self.data_and_prob
                            for c in _kmer_columns(k))]
        if not kmer_list:
            self.printer("Warning: no k-mer columns available for the "
                         "regional score; reporting score 0")
            self.metrics["score"] = 0.0
            return 0.0
        while len(kmer_list) < 2:
            kmer_list.append(kmer_list[-1])
        if valid_size > 10000 * 10:
            region_size = 10000
        else:
            region_size = max(valid_size // 10, 1)
        n_regions = valid_size // region_size
        self.printer("n_regions:", n_regions)

        score = 0.0
        region_avg = []
        for i in range(n_regions):
            part = _rows(self.data_and_prob,
                         slice(region_size * i, region_size * (i + 1)))
            c1 = freq_kmer_comp_multi(part, kmer_list[0], self.n_class)
            c2 = freq_kmer_comp_multi(part, kmer_list[1], self.n_class)
            # np.sum, not nansum: a degenerate (constant-prediction)
            # model yields NaN correlations and must surface as a NaN
            # score, not a perfect 0 (reference semantics)
            score += (np.sum([(1 - c) ** 2 for c in c1])
                      + np.sum([(1 - c) ** 2 for c in c2]))
            region_avg.append(calc_avg_prob(part, self.n_class))

        region_avg = np.asarray(region_avg) if region_avg else \
            np.zeros((0, 2 * self.n_class))
        corr_list = [
            _pearson(region_avg[:, i], region_avg[:, i + self.n_class])
            for i in range(self.n_class)]
        self.printer(self._CORRLIST_ID[self.calibra], corr_list)
        self.printer(self._SCORE_ID[self.calibra], score, n_regions)
        self.metrics["score"] = float(score)
        self.metrics["region_avg_corr"] = corr_list
        return float(score)
