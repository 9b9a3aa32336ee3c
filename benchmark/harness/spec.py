"""A cell as ``BENCHMARK.json`` and the files it names describe it.

Each configuration, traffic mix and per-layer metric lives in a file of
its own, found by name, so that a new one is added without editing any
file here:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes,
  with ``reference`` naming its plain model in ``reference/``;
- ``traffic/<traffic>.json``: the mix's parameters, with ``runner``
  naming the module of ``runners/`` that runs it;
- ``metrics/<metric>.py``: the reader of a per-layer metric;
- ``limits/<cell>.json``: the limit of each number that decides the
  cell's ``correct``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]          # the benchmark folder


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict]    # the end-to-end metrics this cell reports
    per_layer: List[Dict]     # the per-layer metrics this cell reports
    limits: Dict[str, float]  # the limit of each number compared


def _reported(metric: Dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that
    reports the metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=e2e, per_layer=per_layer,
                limits=json.loads((HERE / "limits" / f"{name}.json")
                                  .read_text()))


def load_module(kind: str, name: str):
    """``<benchmark>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
