"""Device selection (counterpart of ``mural_tpu/utils/device.py``).

Entry points run on the CUDA card unless the caller asks for the CPU.
Without a card and without that request they raise: a run never falls
back to the CPU silently.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(array: np.ndarray, device, dtype) -> torch.Tensor:
    """Module-level numpy constant ``array`` as a tensor on ``device``,
    copied there once per process: a copy from pageable host memory
    makes the host wait until the device has drained its stream."""
    key = (id(array), torch.device(device), dtype)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(array, dtype=dtype, device=device)
    return _CONSTANTS[key]


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host batch array -> tensor on ``device``; a CUDA upload goes
    through pinned memory without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def resolve_device(cpu_only: bool = False,
                   cuda_id: Optional[object] = None) -> torch.device:
    """``cpu_only`` -> CPU; else ``cuda`` or ``cuda:<cuda_id>``.

    Raises RuntimeError when no CUDA device exists (or ``cuda_id`` is out
    of range) and the CPU was not asked for."""
    if cpu_only:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --cpu_only (or "
            "device='cpu') to run on the CPU")
    if cuda_id is None or cuda_id == "":
        return torch.device("cuda")
    idx = int(cuda_id)
    n = torch.cuda.device_count()
    if not 0 <= idx < n:
        raise RuntimeError(f"--cuda_id {idx} out of range; {n} CUDA "
                           "device(s) available")
    return torch.device(f"cuda:{idx}")
