"""The port (mural_tpu_torch) and chip_smoke.py load neither JAX nor any
module of the JAX package, nor pandas or h5py (the GPU machine has
neither), including while they unpickle calibrators that mural_tpu
wrote (a FullDirichlet and a DiagDirichlet).  Runs in a subprocess:
this test process already holds jax."""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np

from mural_tpu.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu.calibrate.extra import DiagDirichlet
from mural_tpu.calibrate.multinomial import MultinomialRegression

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_SLICE = [f"mural_tpu_torch.{m}" for m in (
    "ops._build", "ops.fused_train_stem", "train.steps", "train.optim",
    "train.early_stopping", "train.loop", "calibrate.fit",
    "calibrate.metrics", "tune.runner", "utils.trials", "utils.params",
    "utils.printer")]
EVAL_SLICE = [f"mural_tpu_torch.{m}" for m in (
    "evaluation", "evaluation.evaluator", "evaluation.corr_files",
    "predict.scaling", "utils.tsv")]
INDEL_SLICE = [f"mural_tpu_torch.{m}" for m in ("models.indel",
                                                "cli.mural_indel")]
# the SNV family and track features: new and changed modules
TRACKS_SLICE = [f"mural_tpu_torch.{m}" for m in (
    "genome.tracks", "data.dataset", "data.batcher", "models.snv",
    "models.registry", "models.indel", "utils.convert", "train.steps",
    "train.loop", "predict.pipeline", "cli.main", "cli.commands")]
# transfer, convert and the trial search
SEARCH_SLICE = [f"mural_tpu_torch.{m}" for m in (
    "tune.space", "tune.asha", "tune.runner", "utils.zoo", "utils.params",
    "train.loop", "train.checkpoint", "cli.main", "cli.commands")]
# genome-wide predict, the output farm and the native host loops
GENOME_SLICE = [f"mural_tpu_torch.{m}" for m in (
    "native", "ops.device_gather", "predict.post_farm",
    "predict.genome_wide", "cli.main", "cli.commands")]
# the site-table cache, the extra calibrators and the losses
CACHE_SLICE = [f"mural_tpu_torch.{m}" for m in (
    "data.h5lite", "data.cache", "calibrate.extra", "train.losses",
    "train.checkpoint", "train.loop", "predict.pipeline", "cli.main",
    "cli.commands")]


def test_port_imports_no_jax_and_no_mural_tpu(tmp_path):
    rng = np.random.default_rng(0)
    cal = FullDirichletCalibrator()
    cal.calibrator_ = MultinomialRegression(method="Full")
    cal.calibrator_.weights_ = rng.normal(size=(4, 5))
    probs = rng.dirichlet(np.ones(4), size=6)
    with open(tmp_path / "cal.pkl", "wb") as fh:
        pickle.dump(cal, fh)
    np.save(tmp_path / "probs.npy", probs)
    y = rng.integers(0, 4, 300)
    fit_probs = rng.dirichlet(np.ones(4), size=300) + np.eye(4)[y]
    diag = DiagDirichlet().fit(fit_probs / fit_probs.sum(1, keepdims=True),
                               y)
    with open(tmp_path / "diag.pkl", "wb") as fh:
        pickle.dump(diag, fh)

    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import numpy as np
        import mural_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            mural_tpu_torch.__path__, "mural_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        from mural_tpu_torch.train.checkpoint import load_calibrator
        cal = load_calibrator({str(tmp_path / 'cal.pkl')!r})
        out = cal.predict_proba(np.load({str(tmp_path / 'probs.npy')!r}))
        np.save({str(tmp_path / 'out.npy')!r}, out)
        diag = load_calibrator({str(tmp_path / 'diag.pkl')!r})
        np.save({str(tmp_path / 'diag.npy')!r}, diag.predict_proba(
            np.load({str(tmp_path / 'probs.npy')!r})))
        print("DIAG", type(diag).__module__, type(diag).__name__)
        from mural_tpu_torch import native
        native.load()
        banned = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "optax", "mural_tpu",
                                               "pandas", "h5py"))
        print("MODULES", len(names), type(cal).__module__)
        print("NAMES", ",".join(names))
        print("BANNED", banned)
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                  else [])))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = dict(line.split(" ", 1) for line in res.stdout.splitlines()
                 if line.startswith(("MODULES", "BANNED", "NAMES", "DIAG")))
    n_modules, cal_module = lines["MODULES"].split()
    assert int(n_modules) >= 55
    # the training, evaluation, INDEL, track, search and genome-wide
    # slices' modules are among those imported
    assert set(TRAIN_SLICE + EVAL_SLICE + INDEL_SLICE + TRACKS_SLICE
               + SEARCH_SLICE + GENOME_SLICE + CACHE_SLICE) <= set(
                   lines["NAMES"].split(","))
    assert cal_module == "mural_tpu_torch.calibrate.dirichlet"
    # no mural_tpu.native either (the port keeps its own copy, loaded
    # above); the first field of the name, so mural_tpu_torch passes
    assert lines["BANNED"] == "[]"
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"),
                               cal.predict_proba(probs), rtol=1e-12)
    # a mural_tpu DiagDirichlet loads onto the port's class
    assert lines["DIAG"] == "mural_tpu_torch.calibrate.extra DiagDirichlet"
    np.testing.assert_allclose(np.load(tmp_path / "diag.npy"),
                               diag.predict_proba(probs), rtol=1e-12)
