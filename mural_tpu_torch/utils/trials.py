"""Trial directory management and best-model selection (counterpart of
``mural_tpu/utils/trials.py``).

Mirrors the reference's standalone trial runner bookkeeping
(MuRaL/utils/train_utils.py): trial ids ``Train_<5char>_<00000>``,
``results/<experiment>/<trial>/checkpoint_<epoch>/`` layout, per-trial
``progress.csv`` built from per-checkpoint ``epoch_<n>_metrics.txt``
files, and best-checkpoint selection by minimum loss.
"""

from __future__ import annotations

import os
import random
import re
import string
from typing import Dict, List, Optional, Tuple

METRIC_KEYS = ["loss", "fdiri_loss", "after_min_loss", "score",
               "total_params"]


def generate_trial_id(index: int, rng: Optional[random.Random] = None) -> str:
    rng = rng or random
    tag = "".join(rng.choices(string.ascii_lowercase + string.digits, k=5))
    return f"Train_{tag}_{index:05d}"


def parse_metrics_file(path: str) -> Dict[str, float]:
    out = {}
    with open(path) as fh:
        for line in fh:
            if ":" in line:
                k, v = line.split(":", 1)
                try:
                    out[k.strip()] = float(v.strip())
                except ValueError:
                    out[k.strip()] = v.strip()
    return out


def write_progress_csv(trial_dir: str) -> Optional[str]:
    """Scan checkpoint_*/epoch_*_metrics.txt into progress.csv
    (ref train_utils.py:125-143)."""
    rows: List[Tuple[int, Dict]] = []
    for name in sorted(os.listdir(trial_dir)):
        m = re.match(r"checkpoint_(\d+)$", name)
        if not m:
            continue
        epoch = int(m.group(1))
        mpath = os.path.join(trial_dir, name,
                             f"epoch_{epoch}_metrics.txt")
        if os.path.exists(mpath):
            rows.append((epoch, parse_metrics_file(mpath)))
    if not rows:
        return None
    rows.sort()
    out = os.path.join(trial_dir, "progress.csv")
    with open(out, "w") as fh:
        fh.write("epoch," + ",".join(METRIC_KEYS) + "\n")
        for epoch, met in rows:
            fh.write(str(epoch) + "," + ",".join(
                str(met.get(k, "")) for k in METRIC_KEYS) + "\n")
    return out


def get_best_model_from_trial(trial_dir: str,
                              metric: str = "loss"
                              ) -> Optional[Tuple[str, float]]:
    """Best checkpoint path + loss within one trial directory."""
    best = None
    for name in os.listdir(trial_dir):
        m = re.match(r"checkpoint_(\d+)$", name)
        if not m:
            continue
        epoch = int(m.group(1))
        mpath = os.path.join(trial_dir, name, f"epoch_{epoch}_metrics.txt")
        if not os.path.exists(mpath):
            continue
        met = parse_metrics_file(mpath)
        if metric in met and (best is None or met[metric] < best[1]):
            best = (os.path.join(trial_dir, name, "model"), met[metric])
    return best


def scan_experiment_best(exp_dir: str, metric: str = "loss"
                         ) -> List[Tuple[str, float]]:
    """All trials' best checkpoints sorted by the metric
    (ref scripts/get_best_model.py:5-68)."""
    results = []
    for trial in sorted(os.listdir(exp_dir)):
        tdir = os.path.join(exp_dir, trial)
        if not os.path.isdir(tdir) or not trial.startswith("Train_"):
            continue
        best = get_best_model_from_trial(tdir, metric)
        if best:
            results.append(best)
    results.sort(key=lambda x: x[1])
    return results
