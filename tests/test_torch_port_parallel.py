"""The port's device list, process-group helpers and inference on
replicas (``mural_tpu_torch/parallel/``) against the JAX package's mesh
counterparts on the CPU (conftest gives JAX 8 virtual devices): the
device list and its error, ``initialize`` / ``is_primary`` in one
process, ``sharded_predict`` on 2 and 8 CPU replicas against JAX's on
the 8-device mesh, ``predict --fused_inference --n_devices 2`` and
``predict_genome --n_devices 2`` against the JAX package's runs (as
``tests/test_parallel_extra.py`` runs them), and the device guard of
the kernels' launches."""
import gzip

import jax
import numpy as np
import pytest
import torch

from mural_tpu.data.dataset import prepare_dataset as j_prepare_dataset
from mural_tpu.parallel.mesh import make_mesh
from mural_tpu.parallel.sharded_predict import \
    sharded_predict as j_sharded_predict
from mural_tpu.predict import PredictOptions as JOptions
from mural_tpu.predict import run_predict as j_run_predict
from mural_tpu.predict.genome_wide import GenomePredictOptions as JGOptions
from mural_tpu.predict.genome_wide import run_genome_predict as j_run_genome
from mural_tpu.predict.pipeline import build_model_from_config as j_build
from mural_tpu.train.checkpoint import load_checkpoint as j_load
from mural_tpu.train.loop import _init_variables
from mural_tpu_torch.data.dataset import prepare_dataset
from mural_tpu_torch.models.registry import build_model_from_config
from mural_tpu_torch.ops import _build
from mural_tpu_torch.parallel import distributed
from mural_tpu_torch.parallel.mesh import make_devices
from mural_tpu_torch.parallel.sharded_predict import sharded_predict
from mural_tpu_torch.predict import PredictOptions, run_predict
from mural_tpu_torch.predict.genome_wide import (GenomePredictOptions,
                                                 run_genome_predict)
from mural_tpu_torch.train.checkpoint import load_checkpoint, load_config
from test_torch_port_genome_wide import _assert_close, _read
from test_torch_port_genome_wide import _opts as _genome_opts
from test_torch_port_genome_wide import inputs  # noqa: F401
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_predict import _mean_loss, triple  # noqa: F401

LOGIT_TOL = 1e-5        # sharded logits, port against JAX
LOSS_REL = 1e-5


def test_make_devices(monkeypatch):
    """CPU slots; the first n CUDA devices; more than there are raises
    the JAX package's error, with its message."""
    assert make_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert make_devices(2, "cuda") == [torch.device("cuda:0"),
                                       torch.device("cuda:1")]
    assert len(make_devices(None, "cuda:3")) == 8
    with pytest.raises(ValueError) as want:
        make_mesh(len(jax.devices()) + 1)
    with pytest.raises(ValueError) as got:
        make_devices(9, "cuda")
    assert str(got.value) == str(want.value) == "requested 9 devices, have 8"


def test_distributed_initialize_noop():
    """One process: ``initialize`` joins no group and ``is_primary``
    holds; several processes need an address."""
    distributed.initialize()
    distributed.initialize(num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    assert distributed.rank_context() is None
    with pytest.raises(ValueError, match="need a coordinator address"):
        distributed.initialize(num_processes=2, process_id=0)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_predict_matches_jax(triple, n):  # noqa: F811
    """The port's replicas on ``n`` CPU slots against JAX's
    ``sharded_predict`` on the 8-device mesh, on one mural_tpu-written
    triple, B=60 (rounded up to a multiple of n): logits within 1e-5 of
    the largest, loss within 1e-5 relative."""
    config = load_config(triple["config"])
    kw = dict(central_bp=config["segment_center"],
              local_radius=config["local_radius"],
              local_order=config["local_order"],
              distal_radius=config["distal_radius"])
    jds = j_prepare_dataset(triple["bed"], triple["fasta"], **kw)
    jmodel = j_build(config, 0, "snv")
    v = j_load(triple["model"], _init_variables(jmodel, jds, 0))
    want, want_loss = j_sharded_predict(jmodel, v["params"],
                                        v["batch_stats"], jds, 60, 8)
    model = build_model_from_config(config, 0, "snv")
    load_checkpoint(triple["model"], model)
    ds = prepare_dataset(triple["bed"], triple["fasta"], **kw)
    got, loss = sharded_predict(model, ds, 60, make_devices(n, "cpu"),
                                n_class=4)
    assert got.shape == want.shape == (triple["n_sites"], 4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    assert loss == pytest.approx(want_loss, rel=LOSS_REL)


def test_predict_fused_n_devices_matches_jax(triple):  # noqa: F811
    """``predict --fused_inference --n_devices 2`` of both packages on
    the triple: the same rows, probabilities within ``%.4g``, the mean
    loss within 1e-5; and the port's rows equal its one-device run's."""
    common = dict(test_data=triple["bed"], ref_genome=triple["fasta"],
                  model_path=triple["model"],
                  model_config_path=triple["config"],
                  calibrator_path=triple["calibrator"], pred_batch_size=32,
                  fused_inference=True)
    base = triple["base"]
    lines = {"jax": [], "port": [], "one": []}
    j_run_predict(JOptions(pred_file=str(base / "jax_n2.tsv.gz"),
                           n_devices=2, **common), "snv",
                  printer=lambda *a: lines["jax"].append(" ".join(
                      map(str, a))))
    for name, n in (("port", 2), ("one", 1)):
        run_predict(PredictOptions(pred_file=str(base / f"{name}_n2.tsv.gz"),
                                   n_devices=n, device="cpu", **common),
                    "snv", printer=lambda *a, k=name: lines[k].append(
                        " ".join(map(str, a))))
    want = _read(base / "jax_n2.tsv.gz")
    got = _read(base / "port_n2.tsv.gz")
    assert len(got[1]) == triple["n_sites"]
    _assert_close(got, want)
    _assert_close(got, _read(base / "one_n2.tsv.gz"))
    j_loss = _mean_loss(lines["jax"])
    assert _mean_loss(lines["port"]) == pytest.approx(j_loss, rel=LOSS_REL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_predict_genome_n_devices_matches_jax(inputs, fused):  # noqa: F811
    """``predict_genome --n_devices 2`` of both packages: the same rows
    and probabilities within ``%.4g``; the port's replicas each get the
    chunk's codes and half of each batch's starts."""
    base = inputs["base"]
    kw = dict(focal_base="A", batch_size=255, fused_inference=fused,
              flush_batches=3, n_devices=2)
    out = {}
    for name, cls, fn, extra in (
            ("jax", JGOptions, j_run_genome, {}),
            ("port", GenomePredictOptions, run_genome_predict,
             {"device": "cpu"})):
        out[name] = str(base / f"{name}_gw_n2_{fused}.tsv.gz")
        fn(_genome_opts(cls, inputs, "snv", out[name], **kw, **extra),
           "snv", printer=lambda *a: None)
    got, want = _read(out["port"]), _read(out["jax"])
    assert len(got[1]) > 0
    _assert_close(got, want)
    with gzip.open(out["port"], "rt") as fh:
        assert fh.readline().startswith("chrom\tstart\tend\tstrand")


def test_kernel_launch_runs_on_the_tensors_device(monkeypatch):
    """A launch runs with its tensors' card current, whatever card the
    calling thread has current: ``launch`` enters ``torch.cuda.device``
    of the device it is given around the C launcher, and each kernel
    wrapper hands it its tensors' device."""
    import inspect

    from mural_tpu_torch.ops import fused_code_conv, fused_train_stem
    events = []

    class FakeGuard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    monkeypatch.setattr(torch.cuda, "device", FakeGuard)
    err = _build.launch(lambda *a: events.append(("launch", a)) or 0,
                        torch.device("cuda:1"), 7, 8)
    assert err == 0
    assert events == [("enter", torch.device("cuda:1")),
                      ("launch", (7, 8)), ("exit", torch.device("cuda:1"))]
    # every C launcher is called through launch() with a tensor's device
    for module, calls in ((fused_code_conv, ["code_conv1d_launch"]),
                          (fused_train_stem, ["code_conv_pool_fwd_launch",
                                              "code_conv_pool_bwd_launch"])):
        src = inspect.getsource(module)
        for name in calls:
            assert src.count(f"lib.{name}") == 1
            assert f"launch(lib.{name}, codes.device" in src or \
                f"launch(lib.{name}, g.device" in src
