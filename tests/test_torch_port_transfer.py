"""The port's transfer learning against the JAX package's on the CPU:
one epoch of ``train_trial`` from a mural_tpu-written SNVNet2 triple, the
re-initialised final FC layers (bit for bit), the freeze of every other
parameter (three Adam steps in float64, once with the gradient norm
above the clip), the INDEL and ``n_cont`` errors, and ``transfer``'s
config, options and parsers (with ``convert``'s) through both CLIs.
Every dropout is 0 where the port is held to a JAX training run."""
import copy
import dataclasses
import io
import os
import pickle
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
import mural_tpu_torch.tune.runner as runner
from mural_tpu.cli import main as j_main
from mural_tpu.data.dataset import prepare_dataset as j_prepare_dataset
from mural_tpu.predict.pipeline import \
    build_model_from_config as j_build_model_from_config
from mural_tpu.train import optim as j_optim
from mural_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mural_tpu.train.state import create_train_state
from mural_tpu.train.steps import make_train_step
from mural_tpu_torch.cli import main as t_main
from mural_tpu_torch.train import loop
from mural_tpu_torch.train.optim import LRSchedule, build_optimizer
from mural_tpu_torch.train.steps import TrainState, model_input, train_step
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_indel_train import write_indel_data
from test_torch_port_snv_family import _inputs, _pair
from test_torch_port_train import CONFIG, _rel
from test_torch_port_train_trial import SCORE_TOL, _write_data

# trainable parameters after three float64 steps, port against JAX, as a
# fraction of the largest entry (torch's clip adds 1e-6 to the norm)
TOL_FREEZE64 = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (the suite runs
    one process per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def snv(tmp_path_factory):
    """Data and a pretrained SNVNet2 triple written by mural_tpu (weights
    from another seed than the transfer's trial)."""
    base = tmp_path_factory.mktemp("port_transfer")
    fasta, bed = _write_data(base, np.random.default_rng(3))
    ds = j_prepare_dataset(bed, fasta, central_bp=4000, local_radius=3,
                           local_order=2, distal_radius=200)
    config = dict(CONFIG, model_no=2, n_class=4, n_cont=0,
                  emb_dims=[(x, min(16, int(x ** 0.25)))
                            for x in ds.cat_dims])
    v = j_loop._init_variables(j_build_model_from_config(config, 0, "snv"),
                               ds, 7)
    path = str(base / "pretrained" / "model")
    j_save_checkpoint(path, v["params"], v["batch_stats"], config)
    return base, fasta, bed, path, config


def _transfer_config(saved, **kw):
    return dict(saved, transfer_learning=True, learning_rate=1e-4, **kw)


def test_transfer_epoch_matches_jax(snv):
    """One epoch of a transfer (``init_fc_with_pretrained``, the fused
    stem): loss within 1e-4 relative, fdiri_loss within 1e-3 and score
    within 1e-4 of the JAX package's, the same saved config."""
    base, fasta, bed, path, saved = snv
    config = _transfer_config(saved, train_all=True,
                              init_fc_with_pretrained=True)
    common = dict(train_data=bed, ref_genome=fasta, epochs=1,
                  valid_ratio=0.5, split_seed=0, rng_seed=1,
                  fused_stem="on", model_path=path)
    jdir, tdir = str(base / "jax_tl"), str(base / "port_tl")
    jm = j_loop.train_trial(config, j_loop.TrainOptions(
        trial_dir=jdir, resident="off", steps_per_dispatch=1, **common),
        "snv")
    tm = loop.train_trial(config, loop.TrainOptions(
        trial_dir=tdir, device="cpu", **common), "snv")
    assert _rel(tm["loss"], jm["loss"]) <= 1e-4
    assert _rel(tm["fdiri_loss"], jm["fdiri_loss"]) <= 1e-3
    assert _rel(tm["score"], jm["score"]) <= SCORE_TOL
    assert tm["total_params"] == jm["total_params"]
    configs = []
    for trial_dir in (tdir, jdir):
        with open(os.path.join(trial_dir, "checkpoint_0",
                               "model.config.pkl"), "rb") as fh:
            configs.append(pickle.load(fh))
    assert configs[0] == configs[1]
    assert configs[0]["emb_dims"] == saved["emb_dims"]


@pytest.mark.parametrize("model_no,n_cont", [(0, 0), (1, 0), (2, 0),
                                             (3, 2)])
@pytest.mark.parametrize("seed", [0, 41])
def test_reinit_final_fcs_bit_identical(model_no, n_cont, seed):
    """The port's re-initialised final FC layers equal the JAX package's
    ``_reinit_final_fcs`` bit for bit (draw order, shapes, transposes,
    zero biases); every other entry is untouched.  SNVNet0 has none."""
    _, v, model, _ = _pair(model_no, n_cont, 4)
    want = state_dict_from_jax(
        {"params": j_loop._reinit_final_fcs(v["params"], seed),
         "batch_stats": v["batch_stats"]}, model)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    loop.reinit_final_fcs(model, seed)
    got = model.state_dict()
    changed = sorted(k for k in got if not torch.equal(got[k], before[k]))
    for name, value in got.items():
        assert torch.equal(value, want[name]), name
    fcs = {2: ["local_fc.0", "distal_fc1.2", "distal_fc2.2"],
           3: ["local_fc.0", "distal_fc1.2", "distal_fc2.2"],
           1: ["distal_fc1.2", "distal_fc2.2"], 0: []}[model_no]
    assert changed == sorted(f"{fc}.{leaf}" for fc in fcs
                             for leaf in ("bias", "weight"))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("batch", [16, 64])
def test_freeze_matches_jax(batch):
    """``train_all=False``: three Adam steps in float64 leave every frozen
    parameter bit-identical to the pretrained one in both packages, the
    trainable final FCs within 1e-6 of JAX's and the BN statistics moved
    as JAX's.  The gradient norm of every step exceeds the clip of 10
    (the loss is a sum over the batch), so the steps agree only because
    the frozen gradients count in the norm: the check fails when they are
    left out."""
    jmodel, v, model, _ = _pair(2, 0, 4, config=_no_dropout(), seed=4,
                                nontrivial=False)
    model = model.double()
    params = j_loop._reinit_final_fcs(v["params"], 3)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(3):
        cat, codes, _, _ = _inputs(rng, 0, 4, batch=batch)
        batches.append((rng.integers(0, 4, size=batch).astype(np.int32),
                        cat, codes))
    schedule = ("StepLR", 5e-3, 0.9, batch, 3 * batch * 2, 1e-4, 1e-6)
    with jax.enable_x64(True):
        pretrained = {"params": _f64(params),
                      "batch_stats": _f64(v["batch_stats"])}
        jstate = create_train_state(
            jmodel, pretrained, "Adam", 1e-2,
            j_optim.LRSchedule.build(*schedule),
            trainable_mask=j_loop._transfer_mask(pretrained["params"],
                                                 "snv", False))
        jstep = make_train_step(jmodel, donate=False)
        for y, cat, codes in batches:
            jstate, _, _ = jstep(jstate, jnp.asarray(y), jnp.asarray(cat),
                                 None, jnp.asarray(codes),
                                 jnp.ones((batch,), jnp.float64),
                                 jax.random.key(0))
        want = state_dict_from_jax(jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}),
            model)
        start = state_dict_from_jax(jax.tree.map(np.asarray, pretrained),
                                    model)

    results = {}
    for clip_frozen in (True, False):
        net = _fresh(model, start)
        trainable = loop.transfer_trainable(net, "snv", False)
        if not clip_frozen:
            ids = {id(p) for p in trainable}
            for p in net.parameters():
                p.requires_grad_(id(p) in ids)
        state = TrainState(net, build_optimizer("Adam", trainable, 1e-2),
                           LRSchedule.build(*schedule))
        norms = []
        for y, cat, codes in batches:
            norms.append(_grad_norm(net, y, cat, codes))
            train_step(state, torch.from_numpy(y).long(),
                       torch.from_numpy(cat).long(),
                       model_input(torch.from_numpy(codes), False).double(),
                       torch.ones(batch, dtype=torch.float64))
        results[clip_frozen] = (net.state_dict(), norms)

    got, norms = results[True]
    names = {n for n, _ in model.named_parameters()}
    trainable_names = {n for n in names
                       if n.rsplit(".", 1)[0] in loop.FINAL_FCS}
    assert trainable_names == {f"{fc}.{leaf}" for fc in loop.FINAL_FCS
                               for leaf in ("weight", "bias")}
    for name in names - trainable_names:
        assert torch.equal(got[name], start[name]), name
        assert torch.equal(want[name], start[name]), name
    worst = max(_scaled_err(got[n], want[n]) for n in trainable_names)
    assert worst <= TOL_FREEZE64
    assert all(not torch.equal(got[n], start[n]) for n in trainable_names)
    for name in want:
        if "running" in name:
            assert _scaled_err(got[name], want[name]) <= TOL_FREEZE64, name
    assert min(norms) > 10, norms
    # the clip over the trainable gradients alone departs from JAX
    wrong = results[False][0]
    assert max(_scaled_err(wrong[n], want[n])
               for n in trainable_names) > 100 * TOL_FREEZE64


def _no_dropout():
    return dict(CONFIG, emb_dropout=0.0, local_dropout=0.0,
                distal_fc_dropout=0.0)


def _fresh(model, state_dict):
    """A copy of ``model`` holding ``state_dict``."""
    net = copy.deepcopy(model)
    net.load_state_dict(state_dict, strict=True)
    return net


def _grad_norm(net, y, cat, codes):
    """The global norm of every parameter's gradient on one batch, the
    batch statistics left as they were."""
    probe = copy.deepcopy(net).train()
    for p in probe.parameters():
        p.requires_grad_(True)
    out = probe(torch.from_numpy(cat).long(),
                model_input(torch.from_numpy(codes), False).double())
    logz = torch.logsumexp(out, 1)
    loss = (logz - out.gather(1, torch.from_numpy(y).long()[:, None])[:, 0]
            ).sum()
    grads = torch.autograd.grad(loss, list(probe.parameters()))
    return float(torch.sqrt(sum((g ** 2).sum() for g in grads)))


def _scaled_err(got, want):
    got, want = got.double(), want.double()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    return float((got - want).abs().max()) / scale if got.numel() else 0.0


@pytest.fixture(scope="module")
def indel(tmp_path_factory):
    """INDEL data and a mural_tpu-written U-Net checkpoint (small
    widths)."""
    from test_torch_port_indel_cli import CONFIG as INDEL_CONFIG
    base = tmp_path_factory.mktemp("port_transfer_indel")
    fasta, bed = write_indel_data(base, np.random.default_rng(7),
                                  n_sites=480)
    ds = j_prepare_dataset(bed, fasta, central_bp=4000, local_radius=6,
                           local_order=1, distal_radius=100,
                           model_type="indel")
    config = dict(INDEL_CONFIG, emb_dims=[(4, 1)] * ds.cat.shape[1])
    v = j_loop._init_variables(
        j_build_model_from_config(config, 0, "indel"), ds, 0)
    path = str(base / "pretrained" / "model")
    j_save_checkpoint(path, v["params"], v["batch_stats"], config)
    return base, fasta, bed, path, config


@pytest.mark.parametrize("train_all,init_fc,match", [
    (False, True, "--train_all is required for INDEL transfer learning"),
    (True, False, "--init_fc_with_pretrained is required for INDEL "
                  "transfer learning")])
def test_indel_transfer_errors_match_jax(indel, train_all, init_fc, match):
    base, fasta, bed, path, saved = indel
    config = _transfer_config(saved, batch_size=32, sampled_segments=2,
                              train_all=train_all,
                              init_fc_with_pretrained=init_fc)
    common = dict(train_data=bed, ref_genome=fasta, epochs=1, n_class=8,
                  model_no=0, valid_ratio=0.25, split_seed=0,
                  model_path=path)
    with pytest.raises(ValueError, match=match):
        j_loop.train_trial(config, j_loop.TrainOptions(
            trial_dir=str(base / "jax"), resident="off", **common), "indel")
    with pytest.raises(ValueError, match=match):
        loop.train_trial(config, loop.TrainOptions(
            trial_dir=str(base / "port"), device="cpu", **common), "indel")


def test_n_cont_mismatch_raises_jax_error(snv):
    """A checkpoint trained with two track features, transferred without
    ``--bw_paths``: the JAX package's ValueError, before any weight
    loads."""
    base, fasta, bed, path, saved = snv
    config = _transfer_config(dict(saved, n_cont=2))
    common = dict(train_data=bed, ref_genome=fasta, epochs=1,
                  valid_ratio=0.5, split_seed=0, model_path=path)
    match = "pretrained checkpoint used n_cont=2 track feature"
    with pytest.raises(ValueError, match=match):
        j_loop.train_trial(config, j_loop.TrainOptions(
            trial_dir=str(base / "jax_nc"), resident="off", **common),
            "snv")
    with pytest.raises(ValueError, match=match):
        loop.train_trial(config, loop.TrainOptions(
            trial_dir=str(base / "port_nc"), device="cpu", **common), "snv")


def _describe(value):
    """A sampler as (class name, fields); anything else as itself."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value).__name__, dataclasses.asdict(value)
    return value


def _cmd_transfer(model_type, argv, monkeypatch):
    """cmd_transfer of both packages with run_experiment stubbed; returns
    {package: (space, opts, model_type, exp, printed)}."""
    got = {}

    def stub(name):
        def run_experiment(space, opts, mt, exp, **kw):
            got[name] = [space, opts, mt, exp]
        return run_experiment

    monkeypatch.setattr("mural_tpu.tune.runner.run_experiment", stub("jax"))
    monkeypatch.setattr(runner, "run_experiment", stub("port"))
    for name, main, extra in (("jax", j_main, []),
                              ("port", t_main, ["--cpu_only"])):
        out = io.StringIO()
        with redirect_stdout(out):
            main.cmd_transfer(main.create_parser(model_type).parse_args(
                argv + extra), model_type)
        got[name].append(out.getvalue())
    return got


def _saved_config(tmp_path, model_type):
    cfg = dict(local_radius=5, local_order=3, distal_radius=50,
               CNN_kernel_size=3, CNN_out_channels=8, local_hidden1_size=32,
               local_hidden2_size=16, emb_dropout=0.1, local_dropout=0.1,
               distal_fc_dropout=0.25, segment_center=300000,
               sampled_segments=10, n_class=4, model_no=3,
               emb_dims=[(65, 2)] * 11, n_cont=0)
    if model_type == "indel":
        cfg.update(model_no=0, n_class=8, down_list=[1, 2, 2, 5, 5, 1],
                   use_reverse=True)
        del cfg["sampled_segments"]
    path = tmp_path / "model.config.pkl"
    with open(path, "wb") as fh:
        pickle.dump(cfg, fh)
    return str(path)


@pytest.mark.parametrize("model_type", ["snv", "indel"])
@pytest.mark.parametrize("extra", [
    [], ["--train_all", "--init_fc_with_pretrained", "--segment_center",
         "5000", "--sampled_segments", "4", "8", "--learning_rate", "1e-3"],
    ["--use_ray", "--n_trials", "4", "--batch_size", "64", "128",
     "--optim", "Adam", "AdamW", "--learning_rate", "1e-4", "1e-2",
     "--weight_decay", "1e-6", "1e-3", "--LR_gamma", "0.9", "0.95",
     "--grace_period", "1", "--n_parallel", "2", "--rerun_failed",
     "--trial_executor", "process", "--ASHA_metric", "fdiri_loss"]],
    ids=["defaults", "pinned", "use_ray"])
def test_cmd_transfer_matches_jax(tmp_path, monkeypatch, model_type, extra):
    """The config (or search space), options, experiment and printed
    warning of ``transfer`` equal the JAX package's: the architecture,
    ``model_no`` and ``n_class`` from the checkpoint, ``--train_all``
    forced with its warning, segment_center and sampled_segments kept
    unless given (sampled_segments 10 by default)."""
    argv = ["transfer", "--ref_genome", "g.fa", "--train_data", "t.bed",
            "--model_path", str(tmp_path / "model"), "--model_config_path",
            _saved_config(tmp_path, model_type), *extra]
    got = _cmd_transfer(model_type, argv, monkeypatch)
    (space, opts, mt, exp, out), (j_space, j_opts, j_mt, j_exp, j_out) = (
        got["port"], got["jax"])
    assert mt == j_mt == model_type
    assert list(space) == list(j_space)
    assert {k: _describe(v) for k, v in space.items()} == {
        k: _describe(v) for k, v in j_space.items()}
    assert space["transfer_learning"] is True and space["train_all"] is True
    assert ("Warning: --train_all is required" in out) == (
        "--train_all" not in extra)
    assert out == j_out
    fields = {f.name for f in dataclasses.fields(opts)} - {"device"}
    common = fields & {f.name for f in dataclasses.fields(j_opts)}
    assert {k: getattr(opts, k) for k in common} == {
        k: getattr(j_opts, k) for k in common}
    assert opts.device == torch.device("cpu")
    e_common = ({f.name for f in dataclasses.fields(exp)}
                & {f.name for f in dataclasses.fields(j_exp)})
    assert {k: getattr(exp, k) for k in e_common} == {
        k: getattr(j_exp, k) for k in e_common}
    assert opts.model_no == (3 if model_type == "snv" else 0)


@pytest.mark.parametrize("model_type", ["snv", "indel"])
@pytest.mark.parametrize("argv", [
    ["transfer", "--ref_genome", "g", "--train_data", "b", "--model_path",
     "m", "--model_config_path", "c"],
    ["convert", "--checkpoint_dir", "d", "--out_dir", "o"]],
    ids=lambda a: a[0])
def test_parsers_match_jax(model_type, argv):
    """transfer and convert take the JAX package's flags with its
    defaults; the port adds --cpu_only (and convert --cuda_id)."""
    ours = vars(t_main.create_parser(model_type).parse_args(argv))
    theirs = vars(j_main.create_parser(model_type).parse_args(argv))
    assert set(ours) - set(theirs) == (
        {"cpu_only"} if argv[0] == "transfer" else {"cpu_only", "cuda_id"})
    assert {k: ours[k] for k in theirs} == theirs
