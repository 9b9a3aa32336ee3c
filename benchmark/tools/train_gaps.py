"""Break a train cell's comparison down by leaf and by step, over seeds.

For each seed: the program's steps 1-3 (as a run of the cell takes
them) and, in its place, the plain reference in float32 (another
summation order), in TF32 (the control) and with half of each batch
left out (a fault).  Each is read as the cell reads the program, against
the reference in float64 that follows it step by step: the loss of each
step, each leaf's first gradient as the optimizer saw it, each leaf's
change after step 3, beside the worst leaf's gaps (not compared).

    python3 benchmark/tools/train_gaps.py --workload snv_hs.train \\
        --seeds 2038974497 11 12 --sites 40000 [--device cpu] [--leaves]

With ``--group SECONDS`` it reads the group that a run reads after its
window instead: the program trains for SECONDS as a run's window does
(on the cell's full training set), then one group of K steps goes down
the timed path, and the same four readings follow that group from the
program's state before it.

One JSON line per seed and reading goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(Path.cwd()))

import torch  # noqa: E402

from runners import train as drv  # noqa: E402
from harness import checks as ck  # noqa: E402
from harness import spec  # noqa: E402


def leaf_table(prog, ref, keep=None):
    return ck.leaf_gaps({k: v.double() for k, v in prog.items()},
                        {k: v.double() for k, v in ref.items()}, keep)


def worst_leaves(setup, run, ref):
    """The worst leaf's gaps of the first gradient and of the change after
    step 3, and step 1's loss gap: not compared (a ReLU input rounding
    across zero re-routes one position's gradient; PERF.md)."""
    r_losses, r_grad, r_after, _ = ref
    first = {k: v.double() for k, v in r_grad.items()}
    init = {k: setup.init[k].double() for k in r_after}
    grad_gap, grad_leaf = ck.worst_leaf_gap(
        {k: v.double() for k, v in run["grad"].items()}, first)
    change_gap, change_leaf = ck.worst_leaf_gap(
        {k: run["after"][k].double() - init[k] for k in r_after},
        {k: r_after[k].double() - init[k] for k in r_after},
        keep=ck.moved_leaves(first))
    return {"loss1_gap": ck.rel_gap(run["losses"][0], r_losses[0]),
            "grad_gap": grad_gap, "grad_leaf": grad_leaf,
            "change_gap": change_gap, "change_leaf": change_leaf}


def group_gaps(cell, seed, device, seconds):
    """The program, then the float32 reference, the TF32 control and the
    half-batch fault in its place, through the group that a run reads
    after a window of ``seconds``, each against the float64 reference."""
    t0 = time.time()
    setup = drv.Setup(cell, seed, device)
    drv.program_first_steps(setup)
    s = drv.warm_up(setup, drv.CHECK_STEPS)
    chunk = setup.k * cell.traffic["window_chunk_groups"]
    t1 = time.perf_counter()
    while time.perf_counter() - t1 < seconds:
        setup.run(s, s + chunk)
        s += chunk
    group = drv.program_group(setup, s)
    setup.groups = None
    t2 = time.time()
    ref = drv.reference_group(setup, group)
    t_ref = time.time() - t2
    runs = {"program": group}
    for name, kw in (("ref_float32", {"tf32": False}),
                     ("control_tf32", {"tf32": True}),
                     ("fault_half_batch", {"tf32": False,
                                           "fault": "half_batch"})):
        runs[name] = drv.control_group(setup, group, **kw)
    for name, got in runs.items():
        print(json.dumps({
            "seed": seed, "reading": name, "step": group["first"],
            **drv.group_readings(got, ref),
            "loss_gap_by_step": [ck.rel_gap(a, b) for a, b in
                                 zip(got["losses"], ref[0])]}), flush=True)
    print(f"seed {seed}: {time.time() - t0:.1f} s, float64 group "
          f"{t_ref:.1f} s", file=sys.stderr)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sites", type=int, default=40000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--leaves", action="store_true",
                   help="print every leaf's gaps, not the worst only")
    p.add_argument("--group", type=float, default=None, metavar="SECONDS",
                   help="read the group after SECONDS of training")
    args = p.parse_args()
    device = torch.device(args.device)
    # train_trial's precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load_cell(Path.cwd(), args.workload)
    if args.group is not None:
        for seed in args.seeds:
            group_gaps(cell, seed, device, args.group)
        return
    cfg = cell.config
    scale = args.sites / cfg["train_sites"]
    cfg["train_genome_bases"] = max(int(cfg["train_genome_bases"] * scale),
                                    20 * (2 * cfg["distal_radius"] + 1))
    cfg["train_sites"] = args.sites
    for seed in args.seeds:
        t0 = time.time()
        setup = drv.Setup(cell, seed, device)
        runs = {"program": drv.program_first_steps(setup)}
        for name, kw in (("ref_float32", {"tf32": False}),
                         ("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"tf32": False,
                                               "fault": "half_batch"})):
            runs[name] = drv.control_first_steps(setup, **kw)
        for name, got in runs.items():
            ref = drv.reference_steps(setup, got)
            row = {"seed": seed, "reading": name,
                   **drv.readings(setup, got, ref),
                   **worst_leaves(setup, got, ref),
                   "loss_gap_by_step": [ck.rel_gap(a, b) for a, b in
                                        zip(got["losses"], ref[0])]}
            if args.leaves:
                row["grad_by_leaf"] = leaf_table(got["grad"], ref[1])
                init = {k: setup.init[k] for k in ref[2]}
                row["change_by_leaf"] = leaf_table(
                    {k: got["after"][k].double() - init[k].double()
                     for k in init},
                    {k: ref[2][k].double() - init[k].double() for k in init},
                    keep=ck.moved_leaves({k: v.double()
                                          for k, v in ref[1].items()}))
            print(json.dumps(row), flush=True)
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr)
        del setup


if __name__ == "__main__":
    main()
