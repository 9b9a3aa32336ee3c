"""The port's extra calibrators (``mural_tpu_torch.calibrate.extra``:
MatrixScaling, DiagDirichlet, FixedDiagDirichlet and the
DirichletCalibrator facade) against ``mural_tpu.calibrate.extra`` on the
same data: ``weights_`` and ``predict_proba`` within 1e-6, the facade's
``matrix_type`` error, and a mural_tpu pickle of each loading onto the
port's classes through ``load_calibrator``."""
import pickle

import numpy as np
import pytest

from mural_tpu.calibrate import extra as jx
from mural_tpu_torch.calibrate import extra as tx
from mural_tpu_torch.train.checkpoint import load_calibrator

TOL = 1e-6


def _data(seed, n=2000, k=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    logits = rng.normal(size=(n, k)) + 1.2 * np.eye(k)[y]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return logits, probs, y


def _same(ours, theirs, X):
    np.testing.assert_allclose(ours.weights_, theirs.weights_, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ours.predict_proba(X[:200]),
                               theirs.predict_proba(X[:200]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ours.predict_proba(X).sum(1), 1, atol=1e-12)


@pytest.mark.parametrize("name,kw", [
    ("DiagDirichlet", {}), ("DiagDirichlet", {"reg_lambda": 1e-3}),
    ("FixedDiagDirichlet", {}), ("MatrixScaling", {}),
    ("MatrixScaling", {"reg_lambda": 1e-3, "reg_mu": 1e-3})])
def test_calibrators_match_jax(name, kw):
    logits, probs, y = _data(1)
    X = logits if name == "MatrixScaling" else probs
    ours = getattr(tx, name)(**kw).fit(X, y)
    theirs = getattr(jx, name)(**kw).fit(X, y)
    _same(ours, theirs, X)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0, atol=TOL)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("matrix_type", ["full", "diagonal",
                                         "fixed_diagonal"])
@pytest.mark.parametrize("comp_l2", [False, True])
def test_facade_matches_jax(matrix_type, comp_l2):
    _, probs, y = _data(2, k=5)
    kw = dict(matrix_type=matrix_type, l2=1e-3, comp_l2=comp_l2)
    ours = tx.DirichletCalibrator(**kw).fit(probs, y)
    theirs = jx.DirichletCalibrator(**kw).fit(probs, y)
    _same(ours, theirs, probs)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0, atol=TOL)


def test_facade_matrix_type_error():
    for cls in (tx.DirichletCalibrator, jx.DirichletCalibrator):
        with pytest.raises(ValueError, match="invalid matrix_type bogus"):
            cls(matrix_type="bogus")


@pytest.mark.parametrize("name", ["DiagDirichlet", "FixedDiagDirichlet",
                                  "MatrixScaling", "DirichletCalibrator"])
def test_mural_tpu_pickles_load(tmp_path, name):
    _, probs, y = _data(3)
    theirs = getattr(jx, name)().fit(probs, y)
    path = tmp_path / "cal.pkl"
    path.write_bytes(pickle.dumps(theirs))
    ours = load_calibrator(str(path))
    assert type(ours).__module__ == "mural_tpu_torch.calibrate.extra"
    assert type(ours).__name__ == name
    np.testing.assert_array_equal(ours.predict_proba(probs[:100]),
                                  theirs.predict_proba(probs[:100]))
