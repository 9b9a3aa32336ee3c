"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names, and nothing reads the JAX package's
benchmark files."""

import ast
import subprocess
import sys
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parents[1]
SOURCES = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "mural_tpu_torch" not in set(_imports(path)), path


def test_no_source_names_the_jax_benchmark_files():
    for path in SOURCES:
        text = path.read_text()
        for name in ("bench.py", "BENCH_", "MULTICHIP_"):
            assert name not in text, (path, name)


def test_forbidden_names_compare_whole():
    before = dict(sys.modules)
    try:
        sys.modules.pop("mural_tpu", None)
        assert "mural_tpu" not in run.forbidden_loaded()
        sys.modules["mural_tpu_torch_fake.x"] = sys
        assert run.forbidden_loaded() == [] or \
            "mural_tpu" not in run.forbidden_loaded()
        sys.modules["mural_tpu.models"] = sys
        assert "mural_tpu" in run.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_a_cell_run_loads_no_jax(tmp_path):
    """A tiny train cell driven on the CPU in a fresh interpreter leaves
    neither JAX nor the JAX package in ``sys.modules``."""
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}, {str(BENCH.parent)!r}]
import tiny, run
from harness import spec
c = tiny.cell("snv_hs.train")
out = spec.load_module("runners", "train").run(
    c, 5, 0.5, False, torch.device("cpu"), time.time())
print("LOADED", run.forbidden_loaded())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
