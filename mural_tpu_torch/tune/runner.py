"""Experiment runner, standalone mode (counterpart of
``mural_tpu/tune/runner.py``; ref ``run_standalong_training``,
MuRaL/utils/train_utils.py:47-82).

Trials run one after another on one device.  Each trial gets the id
``Train_<5char>_<idx>`` from ``random.Random(seed)``, the directory
``results/<experiment>/<trial>/``, its config pickled beside it and its
own init/shuffle seed ``rng_seed + idx``.  A trial that raises leaves
``error.txt``; a trial whose validation loss has not improved for
``AFTER_MIN_LOSS_STOP`` epochs stops.  The ASHA scheduler, concurrent
trials and reruns of failed trials are ROADMAP.md item 8.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import random
import traceback
from typing import Dict, List, Optional

from mural_tpu_torch.train.loop import TrainOptions, train_trial
from mural_tpu_torch.utils.trials import (generate_trial_id,
                                          scan_experiment_best,
                                          write_progress_csv)

AFTER_MIN_LOSS_STOP = 3


@dataclasses.dataclass
class ExperimentOptions:
    experiment_name: str
    results_dir: str = "./results"
    n_trials: int = 2
    epochs: int = 10
    grace_period: int = 5
    seed: Optional[int] = None


def _trial_worker(trial_id: str, config: Dict, opts: TrainOptions,
                  model_type: str):
    def report(metrics: Dict) -> bool:
        return metrics.get("after_min_loss", 0) < AFTER_MIN_LOSS_STOP

    try:
        return trial_id, train_trial(config, opts, model_type,
                                     report_fn=report), None
    except Exception as err:
        os.makedirs(opts.trial_dir, exist_ok=True)
        with open(os.path.join(opts.trial_dir, "error.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        return trial_id, None, err


def run_experiment(config: Dict, base_opts: TrainOptions, model_type: str,
                   exp: ExperimentOptions, printer=print) -> List:
    """Run ``n_trials`` trials of ``config``.  Returns the sorted
    best-model list [(checkpoint_path, loss), ...]."""
    exp_dir = os.path.join(exp.results_dir, exp.experiment_name)
    os.makedirs(exp_dir, exist_ok=True)
    id_rng = random.Random(exp.seed)
    for i in range(exp.n_trials):
        trial_id = generate_trial_id(i, id_rng)
        trial_dir = os.path.join(exp_dir, trial_id)
        os.makedirs(trial_dir, exist_ok=True)
        err_path = os.path.join(trial_dir, "error.txt")
        if os.path.exists(err_path):
            os.remove(err_path)
        # every trial gets its own init/shuffle seed
        opts = dataclasses.replace(
            base_opts, trial_dir=trial_dir,
            trial_training_log=os.path.join(trial_dir, "training.log"),
            epochs=exp.epochs, grace_period=exp.grace_period,
            rng_seed=base_opts.rng_seed + int(trial_id.rsplit("_", 1)[-1]))
        with open(os.path.join(trial_dir, "trial_config.pkl"), "wb") as fh:
            pickle.dump(config, fh)
        _, metrics, err = _trial_worker(trial_id, dict(config), opts,
                                        model_type)
        write_progress_csv(trial_dir)
        if err is not None:
            printer(f"Trial {trial_id} FAILED: {err}")
        else:
            printer(f"Trial {trial_id} finished: loss="
                    f"{metrics.get('loss'):.6g}")

    best = scan_experiment_best(exp_dir, metric="loss")
    if best:
        printer("Best checkpoints by validation loss:")
        for path, loss in best[:10]:
            printer(f"  {loss:.6g}  {path}")
        with open(os.path.join(exp_dir, "best_models.txt"), "w") as fh:
            for path, loss in best:
                fh.write(f"{loss}\t{path}\n")
    return best
