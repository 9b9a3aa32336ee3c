"""calibrate_prob: fit a calibrator on validation predictions and log
quality metrics before and after (counterpart of
``mural_tpu/calibrate/fit.py``; ref MuRaL/evaluation/evaluation.py:297-365).
"""

from __future__ import annotations

import numpy as np

from mural_tpu_torch.calibrate.dirichlet import (FullDirichletCalibrator,
                                                 TemperatureScaling,
                                                 VectorScaling)
from mural_tpu_torch.calibrate.metrics import (brier_score, classwise_ece,
                                               ece, nll_from_probs)


def calibrate_prob(y_prob: np.ndarray, y: np.ndarray,
                   calibr_name: str = "FullDiri", printer=print):
    """Returns (fitted calibrator, post-calibration mean NLL)."""
    if calibr_name == "VectS":
        calibr = VectorScaling(logit_constant=0.0)
    elif calibr_name == "TempS":
        calibr = TemperatureScaling(logit_constant=0.0)
    elif calibr_name == "FullDiri":
        calibr = FullDirichletCalibrator()
    elif calibr_name == "FullDiriODIR":
        l2 = 1e-2
        calibr = FullDirichletCalibrator(reg_lambda=l2, reg_mu=l2)
    elif calibr_name == "FullDiri1":
        calibr = FullDirichletCalibrator(reg_norm=True)
    elif calibr_name == "FullDiri2":
        calibr = FullDirichletCalibrator(ref_row=False)
    else:
        raise ValueError(f"unknown calibrator {calibr_name}")

    y = np.asarray(y).astype(np.int64)
    calibr.fit(y_prob, y)
    prob_cal = calibr.predict_proba(y_prob)

    printer("calibr.coef_: ", calibr.coef_)
    printer("calibr.weights_:", calibr.weights_)
    printer("prob_cal.min:", prob_cal.min(axis=0))
    printer("prob_cal.max:", prob_cal.max(axis=0))
    printer("CV:", y_prob.std(axis=0) / y_prob.mean(axis=0))
    printer("CV (after calibration):",
            prob_cal.std(axis=0) / prob_cal.mean(axis=0))

    nll0 = nll_from_probs(y_prob, y)
    nll = nll_from_probs(prob_cal, y)
    ece0, ece1 = ece(y_prob, y, 50), ece(prob_cal, y, 50)
    c0, c1 = classwise_ece(y_prob, y, 50), classwise_ece(prob_cal, y, 50)
    b0, b1 = brier_score(y_prob, y), brier_score(prob_cal, y)
    printer(f"Before {calibr_name} scaling - NLL: {nll0:.8f}, "
            f"ECE: {ece0:.8f}, CwECE: {c0:.8f}, Brier: {b0:.8f}")
    printer(f"After {calibr_name} scaling - NLL: {nll:.8f}, "
            f"ECE: {ece1:.8f}, CwECE: {c1:.8f}, Brier: {b1:.8f}")

    return calibr, nll
