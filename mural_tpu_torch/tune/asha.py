"""Asynchronous Successive Halving (counterpart of
``mural_tpu/tune/asha.py``; replaces ``ray.tune.schedulers.ASHAScheduler``,
ref run_train_raytune.py:285-292).

Rungs sit at ``grace_period * reduction_factor**k`` below ``max_t``.  A
trial reporting at a rung goes on only if its metric is within the best
``1/reduction_factor`` of all results recorded at that rung so far:
promotion is asynchronous, nobody waits for stragglers.
"""

from __future__ import annotations

import threading
from typing import Dict, List


class ASHAScheduler:
    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 10, grace_period: int = 5,
                 reduction_factor: int = 2):
        self.metric = metric
        self.sign = 1.0 if mode == "min" else -1.0
        self.reduction_factor = reduction_factor
        self.rungs: List[int] = []
        r = grace_period
        while r < max_t:
            self.rungs.append(r)
            r *= reduction_factor
        self._results: Dict[int, List[float]] = {r: [] for r in self.rungs}
        self._lock = threading.Lock()

    def on_report(self, trial_id: str, training_iteration: int,
                  metrics: Dict) -> bool:
        """False when the trial should stop."""
        value = self.sign * float(metrics[self.metric])
        with self._lock:
            if training_iteration in self._results:
                results = self._results[training_iteration]
                results.append(value)
                k = max(len(results) // self.reduction_factor, 1)
                if value > sorted(results)[k - 1]:
                    return False
        return True
