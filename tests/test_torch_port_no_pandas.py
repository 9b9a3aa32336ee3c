"""The port's evaluation, scaling, epoch-tail and site-table cache paths
run without pandas and h5py (the GPU machine has neither): a subprocess
that blocks both trains one CPU epoch with --save_valid_preds
--poisson_calib --with_h5 (writing the cache), predicts with --with_h5
on that checkpoint (reading it), then runs ``evaluate``,
``calc_scaling_factor --do_scaling`` and ``scale`` on the validation
predictions that epoch wrote."""
import os
import subprocess
import sys
import textwrap

import numpy as np

from test_torch_port_train_trial import _write_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_paths_run_with_pandas_blocked(tmp_path):
    fasta, bed = _write_data(tmp_path, np.random.default_rng(4),
                             n_per_strand=240)
    script = textwrap.dedent(f"""
        import sys
        sys.modules["pandas"] = None      # any import of it now fails
        sys.modules["h5py"] = None
        from mural_tpu_torch.cli.mural_snv import main
        assert main(["train", "--cpu_only", "--ref_genome", {fasta!r},
                     "--train_data", {bed!r}, "--experiment_name", "np",
                     "--n_trials", "1", "--epochs", "1", "--valid_ratio",
                     "0.5", "--split_seed", "0", "--save_valid_preds",
                     "--poisson_calib", "--segment_center", "4000",
                     "--local_radius", "3", "--local_order", "2",
                     "--CNN_out_channels", "8", "--local_hidden1_size",
                     "30", "--local_hidden2_size", "10", "--batch_size",
                     "32", "--with_h5", "--h5f_path", "h5"]) == 0
        import glob
        (vp,) = glob.glob("results/np/Train_*/checkpoint_0/"
                          "model.valid_preds.tsv.gz")
        model = vp.replace(".valid_preds.tsv.gz", "")
        assert main(["predict", "--cpu_only", "--ref_genome", {fasta!r},
                     "--test_data", {bed!r}, "--model_path", model,
                     "--model_config_path", model + ".config.pkl",
                     "--calibrator_path", model + ".fdiri_cal.pkl",
                     "--pred_file", "pred.tsv.gz", "--with_h5",
                     "--h5f_path", "h5"]) == 0
        assert main(["evaluate", "--pred_file", vp, "--ref_genome",
                     {fasta!r}, "--out_prefix", "ev", "--window_size",
                     "5000"]) == 0
        assert main(["calc_scaling_factor", "--pred_files", vp,
                     "--genomewide_mu", "1e-8", "--m_proportions", "1",
                     "--g_proportions", "1", "--do_scaling"]) == 0
        assert main(["scale", "--pred_file", vp, "--scale_factor", "1e-6",
                     "--out_file", "scaled.tsv.gz"]) == 0
        print("SCORE", open(glob.glob("results/np/Train_*/checkpoint_0/"
                                      "epoch_0_metrics.txt")[0]).read()
              .split("score: ")[1].split()[0])
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                  else [])))
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = res.stdout
    assert "3mer correlation(after Poisson_cal)" in out
    # predict found the cache that train wrote
    assert "using cached site encodings:" in out
    assert len(list((tmp_path / "h5").glob("sites.bed.*.sites.h5"))) == 1
    assert "scaling factor:" in out
    score = next(line for line in out.splitlines() if line.startswith(
        "SCORE "))
    assert np.isfinite(float(score.split()[1]))
    for name in ("ev.3-mer.mut_rates.tsv", "ev.3-mer.corr.txt",
                 "ev.5Kb.mut_rates.tsv", "ev.5Kb.corr.txt", "scaled.tsv.gz",
                 "pred.tsv.gz"):
        assert (tmp_path / name).stat().st_size > 0, name
    (trial,) = (tmp_path / "results" / "np").glob("Train_*")
    assert (trial / "checkpoint_0" /
            "model.valid_preds.tsv.gz.scaled.tsv.gz").exists()
