"""Device selection (counterpart of ``mural_tpu/utils/device.py``).

Entry points run on the CUDA card unless the caller asks for the CPU.
Without a card and without that request they raise: a run never falls
back to the CPU silently.
"""

from __future__ import annotations

from typing import Optional

import torch


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
