"""Parameter census (counterpart of ``mural_tpu/utils/params.py``; ref
``count_parameters``, evaluation.py:26-40): one row per parameter in a
plain-text table, the total at the bottom."""

from __future__ import annotations

import torch


def count_parameters(model: torch.nn.Module, printer=print) -> int:
    rows = [(name, p.numel()) for name, p in model.named_parameters()
            if p.requires_grad]
    total = sum(n for _, n in rows)
    width = max((len(n) for n, _ in rows), default=7)
    printer(f"+-{'-' * width}-+------------+")
    printer(f"| {'Modules'.ljust(width)} | Parameters |")
    printer(f"+-{'-' * width}-+------------+")
    for name, n in rows:
        printer(f"| {name.ljust(width)} | {n:>10} |")
    printer(f"+-{'-' * width}-+------------+")
    printer(f"Total Trainable Params: {total}")
    return total
