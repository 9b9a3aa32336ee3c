"""The port's validation evaluation (mural_tpu_torch.evaluation.evaluator)
against the JAX package's (mural_tpu.evaluation.evaluator) on the same
seeded numpy frames: column dicts for the port, ``pd.DataFrame`` of the
same columns for the JAX package.  Both sides do the same float64
arithmetic in the same order, so results are compared exactly (NaN
equal to NaN), and every printed line letter for letter."""
import gzip

import numpy as np
import pandas as pd
import pytest

from mural_tpu.evaluation import evaluator as jev
from mural_tpu_torch.evaluation import evaluator as tev

N_CLASS = 4


def _frames(n, seed, radius=3, chroms=("chr2", "chr10", "chr1")):
    """(local frame, probabilities, position frame) of ``n`` sites: order-1
    digits us<r>..us1, mid, ds1..ds<r>; labels 0..3; Dirichlet
    probabilities; sites on three chromosomes, unsorted, with distinct
    (chrom, start)."""
    rng = np.random.default_rng(seed)
    local = {f"us{i}": rng.integers(0, 4, n).astype(np.int8)
             for i in range(radius, 0, -1)}
    local["mid"] = np.zeros(n, np.int8)
    local.update({f"ds{i}": rng.integers(0, 4, n).astype(np.int8)
                  for i in range(1, radius + 1)})
    local["mut_type"] = rng.integers(0, N_CLASS, n).astype(np.int32)
    # a k-mer signal so that the correlations are far from 0
    bias = 0.02 * local["us1"] + 0.01 * local["ds1"]
    alpha = np.stack([np.full(n, 50.0)] + [1 + 20 * bias] * 3, axis=1)
    probs = np.stack([rng.dirichlet(a) for a in alpha]).astype(np.float32)
    chrom = np.asarray(chroms, dtype=object)[rng.integers(0, len(chroms),
                                                          n)]
    start = rng.permutation(n * 50)[:n].astype(np.int64)
    pos = {"chrom": chrom, "start": start, "end": start + 1,
           "strand": np.where(rng.random(n) < 0.5, "-", "+")}
    return local, probs, pos


def _with_probs(local, probs):
    out = dict(local)
    for i in range(N_CLASS):
        out[f"prob{i}"] = probs[:, i]
    return out


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a, float), np.asarray(b, float))


def _printer(lines):
    return lambda *a: lines.append(" ".join(map(str, a)))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_freq_kmer_comp_multi(k):
    local, probs, _ = _frames(3000, k)
    frame = _with_probs(local, probs)
    ours = tev.freq_kmer_comp_multi(frame, k, N_CLASS)
    theirs = jev.freq_kmer_comp_multi(pd.DataFrame(frame), k, N_CLASS)
    _assert_same(ours, theirs)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("window", [50, 5_000, 40_000, 10_000_000])
def test_corr_calc_sub_sequential_windows(window, capsys):
    """Sorted by (chrom, start): windows cross chromosome boundaries, and
    the largest window leaves fewer than 3 windows (0 and a warning)."""
    chroms = ("chr2", "chr1") if window == 10_000_000 else ("chr2", "chr10",
                                                              "chr1")
    local, probs, pos = _frames(2000, 7, chroms=chroms)
    frame = tev.sort_by_position(dict(pos, mut_type=local["mut_type"],
                                      **_with_probs({}, probs)))
    names = [f"prob{i}" for i in range(N_CLASS)]
    ours = tev.corr_calc_sub(frame, window, names)
    ours_out = capsys.readouterr().out
    jdf = pd.DataFrame(frame)
    theirs = jev.corr_calc_sub(jdf, window, names)
    assert capsys.readouterr().out == ours_out
    _assert_same(ours, theirs)
    if window == 10_000_000:
        assert ours == [0] * N_CLASS and "too few windows" in ours_out


def test_calc_avg_prob_and_kmer_comp_rand():
    local, probs, _ = _frames(4000, 3)
    frame = _with_probs(local, probs)
    jdf = pd.DataFrame(frame)
    _assert_same(tev.calc_avg_prob(frame, N_CLASS),
                 jev.calc_avg_prob(jdf, N_CLASS))
    for k in (3, 5):
        t_lines, j_lines = [], []
        ours = tev.kmer_comp_rand(frame, k, 1500, sampling_times=4,
                                  rng=np.random.default_rng(9),
                                  printer=_printer(t_lines))
        theirs = jev.kmer_comp_rand(jdf, k, 1500, sampling_times=4,
                                    rng=np.random.default_rng(9),
                                    printer=_printer(j_lines))
        assert ours == theirs and t_lines == j_lines and len(t_lines) == 5


@pytest.mark.parametrize("n,calibra", [(1_800, "no_calibra"),
                                       (1_800, "FullDiri"),
                                       (1_800, "Poisson"),
                                       (123_457, "no_calibra")])
def test_evaluator_matches_jax(n, calibra, tmp_path):
    """evaluate_kmer (k=9 is skipped: radius 3), evaluate_regional_score
    (valid_size above and below 100,000 sites), evaluate_regional_corr
    and its --save_valid_preds file (decompressed, byte-equal)."""
    local, probs, pos = _frames(n, n)
    t_lines, j_lines = [], []
    ev = tev.Evaluator(local, probs, N_CLASS, calibra=calibra,
                       printer=_printer(t_lines))
    jv = jev.Evaluator(pd.DataFrame(local), probs, N_CLASS,
                       calibra=calibra, printer=_printer(j_lines))
    for e in (ev, jv):
        e.evaluate_kmer([3, 5, 7, 9])
        e.evaluate_regional_score(n, [3, 5])
    ev.evaluate_regional_corr(pos, save_valid_preds=True,
                              save_path=str(tmp_path / "port"))
    jv.evaluate_regional_corr(pd.DataFrame(pos), save_valid_preds=True,
                              save_path=str(tmp_path / "jax"))
    assert t_lines == j_lines
    assert any("skipping 9-mer" in line for line in t_lines)
    assert ev.metrics["score"] == jv.metrics["score"]
    assert np.isfinite(ev.metrics["score"])
    for key in ("kmer_corr", "regional_corr"):
        assert ev.metrics[key].keys() == jv.metrics[key].keys()
        for k in ev.metrics[key]:
            _assert_same(ev.metrics[key][k], jv.metrics[key][k])
    _assert_same(ev.metrics["region_avg_corr"], jv.metrics["region_avg_corr"])
    files = []
    for name in ("port", "jax"):
        with gzip.open(tmp_path / f"{name}.valid_preds.tsv.gz", "rb") as fh:
            files.append(fh.read())
    assert files[0] == files[1]
    assert files[0].split(b"\n", 1)[0] == \
        b"chrom\tstart\tend\tstrand\tmut_type\tprob0\tprob1\tprob2\tprob3"


def test_constant_predictions_give_nan_score():
    """np.sum, not nansum: constant predictions give NaN correlations and
    a NaN score in both packages, never a perfect 0."""
    local, _, _ = _frames(2000, 1)
    constant = np.full((2000, N_CLASS), 0.25)
    ours = tev.Evaluator(local, constant, N_CLASS, printer=lambda *a: None)
    theirs = jev.Evaluator(pd.DataFrame(local), constant, N_CLASS,
                           printer=lambda *a: None)
    assert np.isnan(ours.evaluate_regional_score(2000, [3, 5]))
    assert np.isnan(theirs.evaluate_regional_score(2000, [3, 5]))


def test_no_kmer_columns_score_zero():
    local = {"mid": np.zeros(4, np.int8), "mut_type": np.arange(4)}
    probs = np.full((4, 4), 0.25)
    t_lines, j_lines = [], []
    assert tev.Evaluator(local, probs, 4, printer=_printer(t_lines)
                         ).evaluate_regional_score(4, [3, 5]) == 0.0
    assert jev.Evaluator(pd.DataFrame(local), probs, 4,
                         printer=_printer(j_lines)
                         ).evaluate_regional_score(4, [3, 5]) == 0.0
    assert t_lines == j_lines
