"""The device list of a data-parallel run or of sharded inference
(counterpart of ``mural_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 1-D ``data`` mesh; here the
list is explicit: one CUDA device per training rank or inference
replica.  On the CPU the list holds ``n`` slots of the one CPU, which
is how the tests run two ranks or replicas.
"""

from __future__ import annotations

from typing import List, Optional

import torch


def make_devices(n: Optional[int] = None, device=None) -> List[torch.device]:
    """The first ``n`` CUDA devices (all of them when ``n`` is None), or
    ``n`` slots of the CPU when ``device`` is the CPU.  Raises the JAX
    package's ``ValueError`` when ``n`` exceeds the CUDA devices."""
    base = torch.device(device if device is not None else "cuda")
    if base.type != "cuda":
        return [base] * (n or 1)
    have = torch.cuda.device_count()
    n = n or have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def shard_rows(batch_size: int, n: int, i: int) -> slice:
    """Rows of shard ``i`` of ``n`` equal shards of a batch."""
    per = batch_size // n
    return slice(i * per, (i + 1) * per)
