"""A configuration, traffic mix, limits file or per-layer metric added as
a file of its own is found by name, with no file that is there edited."""

import json
import shutil

from harness import spec
from harness.outcome import Outcome


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    root = tmp_path
    cfg = json.loads((bench / "configs" / "snv_hs.json").read_text())
    cfg["distal_radius"] = 500
    (bench / "configs" / "snv_short.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "genome_map.json").read_text())
    traffic["batch_size"] = 1024
    (bench / "traffic" / "genome_small.json").write_text(json.dumps(traffic))
    (bench / "limits" / "snv_short.genome.json").write_text(
        json.dumps({"prob_gap": 1e-4}))
    (bench / "metrics" / "rows_pct.predict.py").write_text(
        "def read(outcome, cell):\n    return 42.0\n")
    bench_json = {
        "configs": [{"name": "snv_short", "file":
                     "benchmark/configs/snv_short.json"}],
        "workloads": [{"name": "snv_short.genome", "config": "snv_short",
                       "traffic": "genome_small", "chips": 1}],
        "end_to_end": [{"name": "predict_sites_per_s", "unit": "sites/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "rows_pct.predict", "unit": "%",
                       "moves": "predict_sites_per_s"}]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    monkeypatch.setattr(spec, "HERE", bench)
    cell = spec.load_cell(root, "snv_short.genome")
    assert cell.config["distal_radius"] == 500
    assert cell.traffic["batch_size"] == 1024
    assert cell.limits == {"prob_gap": 1e-4}
    assert [m["name"] for m in cell.per_layer] == ["rows_pct.predict"]
    reader = spec.load_module("metrics", "rows_pct.predict")
    assert reader.read(Outcome(0, 0, {}, 0, 0, [], 0), cell) == 42.0
    assert spec.load_module("runners", cell.traffic["runner"]).run
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_metrics_without_workloads_follow_what_they_move():
    bench = {"workloads": [], "end_to_end": [], "per_layer": []}
    m = {"name": "x", "moves": "train_windows_per_s"}
    assert spec._reported(m, "a.train", {"train_windows_per_s"})
    assert not spec._reported(m, "a.genome", {"predict_sites_per_s"})
    assert spec._reported({"name": "y", "workloads": ["a.genome"]},
                          "a.genome")
    assert bench
