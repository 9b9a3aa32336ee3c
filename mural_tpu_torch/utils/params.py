"""Parameter census and plain-text tables (counterpart of
``mural_tpu/utils/params.py``; ref ``count_parameters``,
evaluation.py:26-40): one row per parameter in a plain-text table, the
total at the bottom; :func:`format_table` draws the trial runner's
progress table."""

from __future__ import annotations

import torch


def format_table(headers, rows) -> str:
    """A PrettyTable-style box of ``rows`` under ``headers``."""
    cols = [[str(h)] + [str(r[i]) for r in rows]
            for i, h in enumerate(headers)]
    widths = [max(len(v) for v in col) for col in cols]
    sep = "+-" + "-+-".join("-" * w for w in widths) + "-+"

    def line(vals):
        return ("| " + " | ".join(str(v).ljust(w)
                                  for v, w in zip(vals, widths)) + " |")
    out = [sep, line(headers), sep]
    out += [line(r) for r in rows]
    out.append(sep)
    return "\n".join(out)


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
