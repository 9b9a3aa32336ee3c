"""The result line: its keys, ``correct`` from the checks, the traced
run's device times and breakdown, and ``checks`` last."""

from pathlib import Path

import pytest

import run
from harness import checks as ck
from harness import spec
from harness.outcome import Outcome
from harness.trace import Stretch

ROOT = Path(__file__).resolve().parents[2]


def _outcome(value=1e-7, stretch=None):
    return Outcome(setup_s=12.5, window_s=30.0,
                   rates={"train_windows_per_s": 3900.0}, attempted=900,
                   failed=0, checks=[ck.Check("loss1_gap", value, 1e-5)],
                   memory_peak_bytes=123, stretch=stretch,
                   facts={"kind": "train", "batch": 128, "rate": 3900.0})


def test_untraced_line():
    cell = spec.load_cell(ROOT, "indel_hs.train")
    line = run.result_line(cell, _outcome(), False, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_windows_per_s", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert line["checks"] == {"loss1_gap": {"value": 1e-7, "limit": 1e-5}}


def test_a_failed_check_makes_the_run_incorrect():
    cell = spec.load_cell(ROOT, "indel_hs.train")
    line = run.result_line(cell, _outcome(value=1e-3), False, "card")
    assert line["correct"] is False


def test_traced_line():
    st = Stretch(events=[("cudnn_bn_fwd", 0.0, 500.0),
                         ("gemm", 400.0, 300.0), ("gemm", 1500.0, 100.0)],
                 host=[("aten::copy_", 700.0, 900.0)], start_us=0.0,
                 seconds=0.002, units=4)
    cell = spec.load_cell(ROOT, "indel_hs.train")
    line = run.result_line(cell, _outcome(stretch=st), True, "card")
    assert list(line)[-1] == "checks"
    assert line["device"]["busy_s"] == 0.0008
    assert line["device"]["window_s"] == 0.002
    m = line["metrics"]
    assert m["device_idle_pct.train"]["value"] == 100 * (1 - 0.8 / 2)
    assert m["step_device_ms.train"]["value"] == 0.9 / 4
    assert "k2k3_roofline_pct" not in m          # not listed for INDEL
    ops = dict(line["breakdown"]["device_ops"])
    assert ops == {"cudnn_bn_fwd": pytest.approx(0.0005),
                   "gemm": pytest.approx(0.0004)}
    gaps = line["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::copy_", pytest.approx(0.0008)]
    assert gaps[1][1] == pytest.approx(0.0004)


def _run_py(cwd):
    import subprocess
    import sys
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "snv_hs.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Without a CUDA card (as here), or in a directory holding only
    BENCHMARK.json and the benchmark's files, a run exits with a non-zero
    code and prints no result."""
    import shutil
    res = _run_py(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_py(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
