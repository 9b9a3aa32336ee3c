"""The control of a genome-map cell: the plain reference put in the
program's place in a lower precision, read as a run reads the program.

For each seed the cell's inputs are made (on a genome of ``--bases``
bases) and ``check_sites`` focal sites are drawn as a run draws them;
the reference's probabilities in float64 are set beside the same
reference in float32 (TF32 off: another summation order) and in TF32
(the control), each written as ``%.4g``, and the largest gap beyond the
rounding is printed, one JSON line per seed and reading.

    python3 benchmark/tools/genome_gaps.py --workload snv_hs.genome \\
        --seeds 1 2 3 --bases 2000000
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(Path.cwd()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from runners import genome as drv  # noqa: E402
from harness import gen, spec  # noqa: E402
from reference import calib as rcal  # noqa: E402
from reference import data as rdata  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--bases", type=int, default=2_000_000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    device = torch.device(args.device)
    cell = spec.load_cell(Path.cwd(), args.workload)
    n_check = cell.traffic["check_sites"]
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as work:
            inputs = drv.Inputs(cell, seed, device, Path(work), args.bases)
            pos_all, neg_all = rdata.focal_sites(inputs.codes,
                                                 cell.config["focal_base"])
            rng = np.random.default_rng(gen.stream(seed, "check"))
            rows = np.sort(rng.choice(len(pos_all), n_check, replace=False))
            pos, neg = pos_all[rows], neg_all[rows]
            exact = drv.reference_probs(inputs, pos, neg, device)
            for name, kw in (("ref_float32", {"dtype": torch.float32}),
                             ("control_tf32", {"dtype": torch.float32,
                                               "tf32": True})):
                got = drv.reference_probs(inputs, pos, neg, device, **kw)
                print(json.dumps({
                    "seed": seed, "reading": name,
                    "prob_gap": rcal.excess_gap(
                        rcal.as_written(got), exact,
                        cell.config["poisson"])}), flush=True)


if __name__ == "__main__":
    main()
