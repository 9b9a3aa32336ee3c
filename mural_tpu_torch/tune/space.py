"""Hyperparameter search-space primitives (counterpart of
``mural_tpu/tune/space.py``; the reference's Ray Tune samplers,
scripts/run_train_raytune.py:246-282).

``tune.choice`` -> :class:`Choice`, ``tune.loguniform`` ->
:class:`LogUniform`, ``tune.sample_from`` -> :class:`SampleFrom`, which is
evaluated after every other dimension on the partial config.  The draws
come from a ``numpy.random.Generator`` in the JAX package's order, so one
seed samples the same configs in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence

import numpy as np


@dataclass
class Choice:
    options: Sequence

    def sample(self, rng: np.random.Generator):
        return self.options[int(rng.integers(0, len(self.options)))]


@dataclass
class LogUniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator):
        return float(np.exp(rng.uniform(np.log(self.low),
                                        np.log(self.high))))


@dataclass
class SampleFrom:
    fn: Callable[[Dict], Any]


def sample_config(space: Dict, rng: np.random.Generator) -> Dict:
    """One config: each Choice / LogUniform drawn in key order, plain
    values copied, then each SampleFrom called on the result."""
    config = {}
    deferred = {}
    for k, v in space.items():
        if isinstance(v, (Choice, LogUniform)):
            config[k] = v.sample(rng)
        elif isinstance(v, SampleFrom):
            deferred[k] = v
        else:
            config[k] = v
    for k, v in deferred.items():
        config[k] = v.fn(config)
    return config


def loguniform_or_choice(values: Sequence[float]):
    """``loguniform(values[0], values[1])`` for learning_rate and
    weight_decay in search mode (run_train_raytune.py:256,261); a single
    value stays that value."""
    if len(values) >= 2:
        return LogUniform(values[0], values[1])
    return values[0]
