"""Tee printer (counterpart of ``mural_tpu/utils/printer.py``; ref
MuRaL/utils/printer_utils.py:3-27): in distributed mode plain print;
standalone mode tees to stdout and a per-trial log file."""

from __future__ import annotations

import sys


def get_printer(distributed: bool, log_path=None):
    if distributed or not log_path:
        return print

    def tee(*args, **kwargs):
        print(*args, **kwargs)
        with open(log_path, "a") as fh:
            kw = dict(kwargs)
            kw["file"] = fh
            print(*args, **kw)
        sys.stdout.flush()

    return tee
