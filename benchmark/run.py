"""Run one cell of the benchmark of ``mural_tpu_torch`` on the CUDA card
and print its result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
stretch of the window.  The numbers that decide ``correct`` are printed
beside their limits as the last lines of standard error and under
``checks`` in the result.  Without a CUDA card, without the program in
the checkout, or with JAX or the JAX package loaded, the run exits with
a non-zero code and prints no result.
"""

import os
import time


def _process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

# top-level module names that the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "mural_tpu")


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result_line(cell, outcome, trace: bool, device_name: str) -> dict:
    from harness import checks as ck
    from harness import spec
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = (outcome.setup_s if m["name"] == "setup_s"
                     else outcome.rates[m["name"]])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(outcome,
                                                              cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": ck.all_ok(outcome.checks) and outcome.failed == 0,
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if trace:
        st = outcome.stretch
        device["busy_s"] = st.busy_seconds()
        device["window_s"] = st.seconds
        line["breakdown"] = {"device_ops": st.top_ops(),
                             "idle_gaps": st.idle_gaps()}
    line["checks"] = ck.as_json(outcome.checks)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    # the measured program is the checkout's own package
    sys.path.insert(1, str(root))
    import torch
    from harness import spec
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    cell = spec.load_cell(root, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        import mural_tpu_torch
        here = Path(mural_tpu_torch.__file__).resolve().is_relative_to(root)
    except ImportError:
        here = False
    if not here:
        print("the measured program, mural_tpu_torch, is not in this "
              "checkout", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    runner = spec.load_module("runners", cell.traffic["runner"])
    outcome = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_PROCESS)
    if args.trace and outcome.stretch is None:
        print("torch.profiler recorded no device event in any traced "
              "stretch", file=sys.stderr)
        return 5
    line = result_line(cell, outcome, bool(args.trace),
                       torch.cuda.get_device_name(device))
    bad = forbidden_loaded()
    if bad:
        print(f"the measured process loaded {bad}", file=sys.stderr)
        return 4
    print(f"card: {power_limit()}; setup {outcome.setup_s:.3f} s, window "
          f"{outcome.window_s:.3f} s; {json.dumps(outcome.facts)}",
          file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
