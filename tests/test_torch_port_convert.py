"""Reference-layout checkpoints and ``convert`` in the port, on the CPU.

A reference MuRaL state_dict (written here with ``torch.save``: the
ResBlocks' duplicate ``*.layer.N.*`` keys, the BN ``num_batches_tracked``
counters and, for an SNV model without continuous features, a zero-size
``first_bn_layer``) loads into the port and into mural_tpu
(``mural_tpu.utils.torch_import``) with the same eval forwards.
``mural_snv convert`` and ``mural_indel convert`` turn that reference
triple, and a mural_tpu msgpack triple, into the port's own: a state
dict that reloads key for key with bit-identical tensors, a calibrator
that unpickles with neither mural_tpu nor dirichletcal importable, and
predictions byte-equal to the source triple's."""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mural_tpu.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu.data.dataset import prepare_dataset as j_prepare_dataset
from mural_tpu.models.layers import one_hot_from_codes as j_one_hot
from mural_tpu.predict.pipeline import \
    build_model_from_config as j_build_model_from_config
from mural_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mural_tpu.train.loop import _init_variables
from mural_tpu.utils.torch_import import load_torch_checkpoint
from mural_tpu_torch.cli.mural_indel import main as indel_cli
from mural_tpu_torch.cli.mural_snv import main as snv_cli
from mural_tpu_torch.predict import PredictOptions, run_predict
from mural_tpu_torch.train.checkpoint import load_checkpoint
from mural_tpu_torch.utils.zoo import (infer_model_type, input_geometry,
                                       iter_reference_zoo,
                                       load_zoo_checkpoint)
from test_torch_port_indel_cli import CONFIG as INDEL_CONFIG
from test_torch_port_indel_model import _nontrivial
from test_torch_port_indel_train import write_indel_data
from test_torch_port_predict import CONFIG as SNV_CONFIG
from test_torch_port_predict import _write_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# eval forwards, port against mural_tpu, as a fraction of the largest
# output (at least 1)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_layout(model: torch.nn.Module) -> dict:
    """``model``'s state_dict as the reference MuRaL writes it: each
    ResBlock's layers again under ``layer.{1,2,4,5}`` (its ``nn.Sequential``
    of ReLU, BN, conv, ReLU, BN, conv), the ``num_batches_tracked``
    counters, and an SNV local branch without continuous features with
    its ``first_bn_layer = BatchNorm1d(0)``."""
    sd = dict(model.state_dict())
    for name in list(sd):
        parts = name.split(".")
        if parts[0].startswith("RBs") and parts[2] in ("bn1", "conv1",
                                                      "bn2", "conv2"):
            idx = {"bn1": 1, "conv1": 2, "bn2": 4, "conv2": 5}[parts[2]]
            sd[".".join(parts[:2] + ["layer", str(idx)] + parts[3:])] = \
                sd[name]
    if "emb_layer.weight" in sd and not any(
            k.startswith("first_bn_layer") for k in sd):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"first_bn_layer.{leaf}"] = torch.zeros(0)
        sd["first_bn_layer.num_batches_tracked"] = torch.tensor(0)
    return sd


def _write_triples(base, model_type):
    """(data, reference-layout triple dir, mural_tpu msgpack triple dir,
    config, JAX model, JAX variables) for one small model."""
    rng = np.random.default_rng(21)
    if model_type == "snv":
        fasta, bed, _ = _write_inputs(base, rng)
        ds = j_prepare_dataset(bed, fasta, central_bp=5000, local_radius=3,
                               local_order=2, distal_radius=200)
        config = dict(SNV_CONFIG, emb_dims=[(17, 2)] * ds.cat.shape[1])
        n_class = 4
    else:
        fasta, bed = write_indel_data(base, rng, n_sites=240)
        ds = j_prepare_dataset(bed, fasta, central_bp=4000, local_radius=6,
                               local_order=1, distal_radius=100,
                               model_type="indel")
        config = dict(INDEL_CONFIG, emb_dims=[(4, 1)] * ds.cat.shape[1])
        n_class = 8
    jmodel = j_build_model_from_config(config, 0, model_type)
    v = _init_variables(jmodel, ds, 0)
    v = {c: _nontrivial(jax.tree.map(np.asarray, v[c]), rng)
         for c in ("params", "batch_stats")}
    logits = rng.normal(size=(400, n_class))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    cal = FullDirichletCalibrator().fit(probs,
                                        rng.integers(0, n_class, 400))
    msgpack_dir = base / "mural_tpu_triple"
    j_save_checkpoint(str(msgpack_dir / "model"), v["params"],
                      v["batch_stats"], config, calibrator=cal)
    ref_dir = base / "reference_triple"
    ref_dir.mkdir()
    model, _, _ = load_zoo_checkpoint(str(msgpack_dir), model_type)
    torch.save(reference_layout(model), ref_dir / "model")
    for name in ("model.config.pkl", "model.fdiri_cal.pkl"):
        (ref_dir / name).write_bytes((msgpack_dir / name).read_bytes())
    return dict(fasta=fasta, bed=bed, ref=ref_dir, msgpack=msgpack_dir,
                config=config, jmodel=jmodel, v=v, model_type=model_type)


@pytest.fixture(scope="module", params=["snv", "indel"])
def triples(request, tmp_path_factory):
    return _write_triples(tmp_path_factory.mktemp(
        f"port_convert_{request.param}"), request.param)


def _batch(config, model_type, rng, batch=6):
    n_cat, w = input_geometry(config, model_type)
    codes = rng.integers(0, 4, size=(batch, w)).astype(np.uint8)
    codes[rng.random((batch, w)) < 0.02] = 14
    cat = rng.integers(0, 4 ** config["local_order"] + 1,
                       size=(batch, n_cat)).astype(np.int32)
    return cat, np.array(j_one_hot(jnp.asarray(codes)))


def test_reference_layout_loads_like_mural_tpu(triples):
    """The reference-layout state_dict (duplicate ResBlock keys, BN
    counters, an SNV ``first_bn_layer`` of size 0) loads into the port,
    whose eval forward is within 1e-5 of mural_tpu's on the same file."""
    t = triples
    sd = torch.load(t["ref"] / "model", weights_only=True)
    if t["model_type"] == "snv":
        assert any(".layer." in k for k in sd)
        assert sd["first_bn_layer.weight"].shape == (0,)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    model, config, model_type = load_zoo_checkpoint(str(t["ref"]))
    assert model_type == t["model_type"] == infer_model_type(config)
    template = {"params": t["v"]["params"],
                "batch_stats": t["v"]["batch_stats"]}
    j_vars = load_torch_checkpoint(str(t["ref"] / "model"), template)
    cat, onehot = _batch(config, model_type, np.random.default_rng(5))
    snv = model_type == "snv"
    want = np.asarray(t["jmodel"].apply(
        j_vars, jnp.asarray(cat) if snv else None, None,
        jnp.asarray(onehot), False))
    with torch.no_grad():
        got = model(torch.from_numpy(cat).long() if snv else None,
                    torch.from_numpy(onehot)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("source", ["ref", "msgpack"])
def test_convert_writes_the_port_triple(triples, source, tmp_path):
    """``convert --cpu_only`` from a reference-layout triple and from a
    mural_tpu msgpack triple: the state_dict holds every entry of the
    model but the BN counters, each tensor bit-identical to the source's
    as the port loads it; the config is the source's; the calibrator
    holds no mural_tpu or dirichletcal name, unpickles with neither
    importable and maps probabilities to rows summing to 1; predict on
    the converted triple writes the source triple's TSV byte for byte."""
    t = triples
    src, out = t[source], tmp_path / "converted"
    cli = snv_cli if t["model_type"] == "snv" else indel_cli
    assert cli(["convert", "--cpu_only", "--checkpoint_dir", str(src),
                "--out_dir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["model", "model.config.pkl",
                                       "model.fdiri_cal.pkl"]
    source_model, config, _ = load_zoo_checkpoint(str(src))
    sd = torch.load(out / "model", weights_only=True)
    want = {k: v for k, v in source_model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    fresh, _, _ = load_zoo_checkpoint(str(out))
    load_checkpoint(str(out / "model"), fresh)
    with open(out / "model.config.pkl", "rb") as fh:
        assert pickle.load(fh) == config

    blob = (out / "model.fdiri_cal.pkl").read_bytes()
    assert b"dirichletcal" not in blob
    assert blob.count(b"mural_tpu") == blob.count(b"mural_tpu_torch") > 0
    probs = np.random.default_rng(2).dirichlet(
        np.ones(config["n_class"]), size=9)
    np.save(tmp_path / "probs.npy", probs)
    script = textwrap.dedent(f"""
        import pickle, sys
        import numpy as np
        for name in ("mural_tpu", "dirichletcal", "jax"):
            sys.modules[name] = None
        with open({str(out / 'model.fdiri_cal.pkl')!r}, "rb") as fh:
            cal = pickle.load(fh)
        out = cal.predict_proba(np.load({str(tmp_path / 'probs.npy')!r}))
        print(type(cal).__module__, float(np.abs(out.sum(1) - 1).max()))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    module, err = res.stdout.split()
    assert module == "mural_tpu_torch.calibrate.dirichlet"
    assert float(err) <= 1e-6

    tsvs = []
    for triple in (src, out):
        pred = str(tmp_path / f"pred_{triple.name}.tsv")
        run_predict(PredictOptions(
            test_data=t["bed"], ref_genome=t["fasta"],
            model_path=str(triple / "model"),
            model_config_path=str(triple / "model.config.pkl"),
            calibrator_path=str(triple / "model.fdiri_cal.pkl"),
            pred_file=pred, pred_batch_size=32, device="cpu"),
            t["model_type"], printer=lambda *a: None)
        tsvs.append(open(pred, "rb").read())
    assert tsvs[0] == tsvs[1] and len(tsvs[0].splitlines()) > 100


def test_convert_checks_a_broken_checkpoint(triples, tmp_path):
    """A checkpoint whose weights give non-finite outputs is refused, as
    in the JAX package."""
    t = triples
    bad = tmp_path / "bad"
    bad.mkdir()
    sd = torch.load(t["ref"] / "model", weights_only=True)
    name = next(k for k in sd if k.endswith("running_var")
                and sd[k].numel())
    sd[name] = torch.full_like(sd[name], float("nan"))
    torch.save(sd, bad / "model")
    (bad / "model.config.pkl").write_bytes(
        (t["ref"] / "model.config.pkl").read_bytes())
    cli = snv_cli if t["model_type"] == "snv" else indel_cli
    with pytest.raises(ValueError, match="non-finite outputs"):
        cli(["convert", "--cpu_only", "--checkpoint_dir", str(bad),
             "--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_iter_reference_zoo(tmp_path):
    """The zoo walk finds every ``<species>/<family>/<submodel>`` holding
    a ``model`` file, in sorted order, as the JAX package's does."""
    from mural_tpu.utils.zoo import iter_reference_zoo as j_iter
    for species, family, sub in (("Homo_sapiens", "SNV", "AG"),
                                 ("Homo_sapiens", "INDEL", "ins"),
                                 ("Aa", "SNV", "x"), ("Aa", "SNV", "empty")):
        d = tmp_path / species / family / sub
        d.mkdir(parents=True)
        if sub != "empty":
            (d / "model").write_bytes(b"")
    got = list(iter_reference_zoo(str(tmp_path)))
    assert got == list(j_iter(str(tmp_path))) and len(got) == 3
    assert list(iter_reference_zoo(str(tmp_path / "absent"))) == []
