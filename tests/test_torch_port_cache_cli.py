"""``--with_h5`` through both packages' CLIs on the CPU: the port's
``mural_snv predict --with_h5``, on a site-table cache that mural_tpu's
CLI wrote and on one the port wrote (which mural_tpu's CLI then reads),
gives the JAX CLI's TSV rows; and the port's ``train --with_h5`` writes
the training BED's cache, which its ``transfer --with_h5`` then reads."""
import gzip
import os

import numpy as np
import pytest

from mural_tpu.cli.mural_snv import main as jax_cli
from mural_tpu_torch.cli.mural_snv import main as port_cli
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_predict import triple  # noqa: F401

# %.4g on both sides: one unit in the 4th digit, relative
TOL_PRINTED = 1.1e-3


def _read(path):
    with gzip.open(path, "rt") as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    return rows[0], [r[:5] for r in rows[1:]], np.asarray(
        [[float(v) for v in r[5:]] for r in rows[1:]])


def _predict(cli, triple, h5_dir, out, capsys, *extra):
    argv = ["predict", "--ref_genome", triple["fasta"], "--test_data",
            triple["bed"], "--model_path", triple["model"],
            "--model_config_path", triple["config"], "--calibrator_path",
            triple["calibrator"], "--pred_batch_size", "32", "--pred_file",
            str(out), "--cpu_only", "--with_h5", "--h5f_path", str(h5_dir),
            *extra]
    assert cli(argv) == 0
    return capsys.readouterr().out.splitlines()


def _cache_line(lines, kind):
    return [line for line in lines if line.startswith(kind)]


@pytest.mark.parametrize("n_files", ["1", "4"])
def test_predict_with_h5_on_either_packages_cache(triple, tmp_path, capsys,
                                                  n_files):
    """The JAX CLI writes a cache that the port's predict reads, and the
    port's predict writes one that the JAX CLI reads; every TSV has the
    JAX CLI's rows."""
    want = tmp_path / "jax_plain.tsv.gz"
    assert jax_cli(["predict", "--ref_genome", triple["fasta"],
                    "--test_data", triple["bed"], "--model_path",
                    triple["model"], "--model_config_path",
                    triple["config"], "--calibrator_path",
                    triple["calibrator"], "--pred_batch_size", "32",
                    "--pred_file", str(want)]) == 0
    header, keys, probs = _read(want)
    runs = []
    for first, second, name in ((jax_cli, port_cli, "jax_written"),
                                (port_cli, jax_cli, "port_written")):
        h5 = tmp_path / name
        cold = _predict(first, triple, h5, tmp_path / f"{name}_a.tsv.gz",
                        capsys, "--n_h5_files", n_files)
        assert len(_cache_line(cold, "wrote site-encoding cache "
                               f"({n_files} file(s)):")) == 1
        warm = _predict(second, triple, h5, tmp_path / f"{name}_b.tsv.gz",
                        capsys)
        assert len(_cache_line(warm, "using cached site encodings:")) == 1
        runs += [tmp_path / f"{name}_a.tsv.gz", tmp_path / f"{name}_b.tsv.gz"]
        assert len(os.listdir(h5)) == (1 if n_files == "1" else 5)
    for path in runs:
        got_header, got_keys, got_probs = _read(path)
        assert got_header == header and got_keys == keys
        assert len(keys) == triple["n_sites"]
        assert np.all(np.abs(got_probs - probs)
                      <= TOL_PRINTED * np.abs(probs))


def test_train_then_transfer_with_h5(triple, tmp_path, monkeypatch):
    """``train --with_h5`` writes the training BED's cache; ``transfer
    --with_h5`` from its checkpoint, with the same encoding, reads it."""
    monkeypatch.chdir(tmp_path)
    common = ["--ref_genome", triple["fasta"], "--train_data",
              triple["bed"], "--n_trials", "1", "--epochs", "1",
              "--cpu_only", "--batch_size", "32", "--valid_ratio", "0.3",
              "--split_seed", "0", "--with_h5", "--h5f_path",
              str(tmp_path / "h5")]
    assert port_cli(["train", "--experiment_name", "t", "--local_radius",
                     "3", "--local_order", "2", "--CNN_out_channels", "8",
                     "--local_hidden1_size", "24", "--local_hidden2_size",
                     "12", "--segment_center", "5000", *common]) == 0
    (trial,) = (tmp_path / "results" / "t").glob("Train_*")
    log = (trial / "training.log").read_text()
    assert "wrote site-encoding cache (1 file(s)):" in log
    model = str(trial / "checkpoint_0" / "model")
    assert port_cli(["transfer", "--experiment_name", "tl",
                     "--model_path", model, "--model_config_path",
                     model + ".config.pkl", *common]) == 0
    (tl,) = (tmp_path / "results" / "tl").glob("Train_*")
    log = (tl / "training.log").read_text()
    assert "using cached site encodings:" in log
    assert "Epoch 0 used time" in log and not (tl / "error.txt").exists()
    assert (tl / "checkpoint_0" / "model").exists()
