"""The port's SNV family (SNVNet0, SNVNet1, SNVNet2 with continuous
features, SNVNet3) and the INDEL U-Net with distal track channels
against the JAX package's models on the CPU, with the same weights
carried over by the weight bridge
(mural_tpu_torch.utils.convert.state_dict_from_jax): eval forwards,
train-mode forwards and running statistics, three Adam steps, and the
fused stem (the plain versions of K2/K3 on the CPU) on SNVNet1 and
SNVNet3.  Every dropout is 0 in the train-mode tests: Flax and torch
draw their dropout masks from different generators.  The steps hold the
port against JAX run in float64: the JAX package's float32 train-mode
BN (single pass) drifts from its own float64 run by more than the
tolerance within three steps on SNVNet3 with track channels (2.5e-4 at
step 3, where the port's float32 run stays within 5e-8 of it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.models.indel as j_indel
from mural_tpu.models.init import materialize_variables
from mural_tpu.models.layers import one_hot_from_codes as j_one_hot
from mural_tpu.models.registry import build_model as j_build_model
from mural_tpu.predict.pipeline import \
    build_model_from_config as j_build_model_from_config
from mural_tpu.train import optim as j_optim
from mural_tpu.train.state import create_train_state
from mural_tpu.train.steps import make_train_step
from mural_tpu_torch.models.indel import UNetSmall
from mural_tpu_torch.models.registry import (build_model,
                                             build_model_from_config,
                                             check_model_no)
from mural_tpu_torch.models.snv import SNVNet2, SNVNet3
from mural_tpu_torch.train.optim import LRSchedule, build_optimizer
from mural_tpu_torch.train.steps import TrainState, model_input, train_step
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_train import CONFIG, _rel

# forward outputs, port against JAX, as a fraction of the largest entry
# (at least 1): float32 reassociation
TOL = 1e-5
# per-step loss and train-mode outputs and statistics
TOL_STEP = 1e-4
# per-step loss of the port in float64 against JAX in float64 (torch's
# clip_grad_norm_ adds 1e-6 to the norm, optax's clip does not)
TOL_STEP64 = 1e-6
N_CAT = 6
B = 16
W = 401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (the suite runs
    one process per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _common(n_cont, in_channels):
    return {"emb_dims": [(17, 2)] * N_CAT, "n_cont": n_cont, "n_class": 4,
            "distal_order": 1, "in_channels": in_channels}


def _nontrivial(tree, rng):
    return {k: _nontrivial(v, rng) if isinstance(v, dict) else
            (rng.uniform(0.5, 2.0, v.shape) if k in ("scale", "var") else
             rng.normal(0, 0.2, v.shape) if k in ("bias", "mean") else
             np.asarray(v)).astype(np.float32)
            for k, v in tree.items()}


def _inputs(rng, n_cont, in_channels, batch=B):
    cat = rng.integers(0, 17, size=(batch, N_CAT)).astype(np.int32)
    codes = rng.integers(0, 4, size=(batch, W)).astype(np.uint8)
    codes[rng.random((batch, W)) < 0.01] = 14
    cont = (rng.normal(1.0, 0.5, size=(batch, n_cont)).astype(np.float32)
            if n_cont else None)
    tracks = (rng.random((batch, W, in_channels - 4)).astype(np.float32)
              if in_channels > 4 else None)
    return cat, codes, cont, tracks


def _j_distal(codes, tracks):
    x = j_one_hot(jnp.asarray(codes))
    if tracks is not None:
        x = jnp.concatenate([x, jnp.asarray(tracks)], axis=-1)
    return x


def _t(a, long=False):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.long() if long else t


def _pair(model_no, n_cont, in_channels, config=CONFIG, seed=0,
          nontrivial=True):
    """A JAX model with seeded weights (random BN statistics unless
    ``nontrivial`` is off), the port's model holding the same ones
    (strict load), and a batch of inputs."""
    rng = np.random.default_rng(seed)
    common = _common(n_cont, in_channels)
    jmodel = j_build_model(model_no, config, common, "snv")
    cat, codes, cont, tracks = _inputs(rng, n_cont, in_channels)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.asarray(cat), _jnp(cont),
                              _j_distal(codes, tracks), False),
        jax.random.key(0))
    v = materialize_variables({"params": shapes["params"],
                               "batch_stats": shapes["batch_stats"]}, seed)
    v = jax.tree.map(np.asarray, v)
    if nontrivial:
        v = {c: _nontrivial(v[c], rng) for c in ("params", "batch_stats")}
    model = build_model(model_no, config, common, "snv")
    model.load_state_dict(state_dict_from_jax(v, model), strict=True)
    return jmodel, v, model, (cat, codes, cont, tracks)


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


FORWARD_CASES = [(0, 0, 4), (0, 2, 4), (1, 0, 4), (1, 2, 6), (2, 2, 4),
                 (2, 2, 6), (3, 0, 4), (3, 2, 4), (3, 2, 6)]


@pytest.mark.parametrize("model_no,n_cont,in_channels", FORWARD_CASES)
def test_eval_forward_matches_jax(model_no, n_cont, in_channels):
    jmodel, v, model, (cat, codes, cont, tracks) = _pair(
        model_no, n_cont, in_channels)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(cat), _jnp(cont),
                                  _j_distal(codes, tracks), False))
    model.eval()
    with torch.no_grad():
        out = model(_t(cat, True),
                    model_input(_t(codes), False, _t(tracks)), _t(cont))
    assert out.shape == (B, 4) and torch.isfinite(out).all()
    _close(out.numpy(), ref, TOL)


def test_reference_key_layout():
    """The reference's keys: SNVNet0 under ``model.`` with its
    ``output_layer``, the cont BN ``first_bn_layer`` and SNVNet3's
    ``local_fc2.0/.2`` only with continuous features, so SNVNet2
    state_dicts without them load with ``strict=True``."""
    keys = {no: set(build_model(no, CONFIG, _common(2, 6), "snv"
                                ).state_dict())
            for no in (0, 1, 2, 3)}
    assert {"model.emb_layer.weight", "model.first_bn_layer.running_var",
            "model.output_layer.weight"} <= keys[0]
    assert keys[0] == {"model." + k for k in build_model(
        2, CONFIG, _common(2, 6), "snv").state_dict()
        if not k.startswith(("local_fc", "conv", "RBs", "distal_fc"))} | {
        "model.output_layer.weight", "model.output_layer.bias"}
    assert "conv1.0.weight" in keys[1] and not any(
        k.startswith(("emb_layer", "lin_layers", "local_fc"))
        for k in keys[1])
    assert "first_bn_layer.weight" in keys[2]
    assert "local_fc2.0.running_mean" in keys[3] and \
        "local_fc2.2.weight" in keys[3]
    assert "first_bn_layer.weight" not in keys[3]
    no_cont = build_model(2, CONFIG, _common(0, 4), "snv")
    assert not any("first_bn" in k for k in no_cont.state_dict())
    assert not any("local_fc2" in k for k in build_model(
        3, CONFIG, _common(0, 4), "snv").state_dict())
    assert isinstance(no_cont, SNVNet2)
    sd = build_model(3, CONFIG, _common(2, 6), "snv").state_dict()
    assert sd["conv1.0.weight"].shape == (6,)
    assert sd["lin_layers.0.weight"].shape == (CONFIG["local_hidden1_size"],
                                               N_CAT * 5)
    assert build_model(2, CONFIG, _common(2, 4), "snv").state_dict()[
        "lin_layers.0.weight"].shape[1] == N_CAT * 5 + 2


@pytest.mark.parametrize("n_cont,without_bw_distal,seq_only,channels", [
    (0, False, False, 4), (2, False, False, 6), (2, True, False, 4),
    (2, False, True, 4)])
def test_in_channels_rule_matches_jax(n_cont, without_bw_distal, seq_only,
                                      channels):
    config = dict(CONFIG, model_no=3, n_class=4, emb_dims=[(17, 2)] * N_CAT,
                  without_bw_distal=without_bw_distal, seq_only=seq_only)
    model = build_model_from_config(config, n_cont, "snv")
    assert model.in_channels == channels
    assert isinstance(model, SNVNet3)
    jmodel = j_build_model_from_config(config, n_cont, "snv")
    assert jmodel.in_channels == channels


@pytest.mark.parametrize("model_no,model_type", [(4, "snv"), (-1, "snv"),
                                                 (1, "indel")])
def test_unknown_model_no_raises_jax_error(model_no, model_type):
    with pytest.raises(ValueError, match=f"model_no for {model_type} must "
                                         "be one of"):
        check_model_no(model_no, model_type)


def _no_dropout(config=CONFIG):
    return dict(config, emb_dropout=0.0, local_dropout=0.0,
                distal_fc_dropout=0.0)


def _jax_steps(jmodel, v, batches, schedule_args, wd=1e-2):
    """Per-step losses of JAX's ``make_train_step`` run in float64."""
    with jax.enable_x64(True):
        f64 = lambda a: None if a is None else jnp.asarray(a, jnp.float64)
        jstate = create_train_state(jmodel, jax.tree.map(f64, v), "Adam",
                                    wd,
                                    j_optim.LRSchedule.build(*schedule_args))
        jstep = make_train_step(jmodel, donate=False)
        losses = []
        for y, cat, codes, cont, tracks in batches:
            jstate, loss, _ = jstep(jstate, jnp.asarray(y),
                                    jnp.asarray(cat), f64(cont),
                                    jnp.asarray(codes),
                                    jnp.ones((len(y),), jnp.float64),
                                    jax.random.key(0), f64(tracks))
            losses.append(float(loss))
    return losses


def _port_steps(model, batches, schedule_args, fused, wd=1e-2,
                dtype=torch.float32):
    model = model.to(dtype)
    state = TrainState(model, build_optimizer("Adam", model.parameters(),
                                              wd),
                       LRSchedule.build(*schedule_args))
    cast = lambda a: None if a is None else _t(a).to(dtype)
    losses = []
    for y, cat, codes, cont, tracks in batches:
        distal = model_input(_t(codes), fused, cast(tracks))
        if distal.is_floating_point():
            distal = distal.to(dtype)
        loss, _ = train_step(state, _t(y, True), _t(cat, True), distal,
                             torch.ones(len(y), dtype=dtype), cast(cont))
        losses.append(float(loss))
    return losses


def _batches(seed, n_cont, in_channels, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cat, codes, cont, tracks = _inputs(rng, n_cont, in_channels)
        out.append((rng.integers(0, 4, size=B).astype(np.int32), cat,
                    codes, cont, tracks))
    return out


@pytest.mark.parametrize("model_no,n_cont,in_channels", [
    (0, 2, 4), (1, 0, 4), (2, 2, 6), (3, 2, 6), (3, 2, 4)])
def test_train_mode_and_adam_steps_match_jax(model_no, n_cont,
                                             in_channels):
    """A train-mode forward (BN batch statistics) and the running
    statistics it leaves, within 1e-4 of the JAX package's; then three
    Adam steps against JAX in float64: loss per step within 1e-4 (port in
    float32) and 1e-6 (port in float64)."""
    config = _no_dropout()
    jmodel, v, model, (cat, codes, cont, tracks) = _pair(
        model_no, n_cont, in_channels, config, seed=3, nontrivial=False)
    ref, mut = jmodel.apply(v, jnp.asarray(cat), _jnp(cont),
                            _j_distal(codes, tracks), True,
                            mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        out = model(_t(cat, True),
                    model_input(_t(codes), False, _t(tracks)), _t(cont))
    _close(out.numpy(), np.asarray(ref), TOL_STEP, "train-mode forward")
    stats = state_dict_from_jax(
        {"params": v["params"],
         "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])},
        model)
    for name, value in model.state_dict().items():
        if "running" in name:
            _close(value.numpy(), stats[name].numpy(), TOL_STEP, name)

    batches = _batches(5, n_cont, in_channels)
    schedule_args = ("StepLR", 5e-3, 0.9, B, 3 * B * 2, 1e-4, 1e-6)
    want = _jax_steps(jmodel, v, batches, schedule_args)
    for dtype, tol in ((torch.float32, TOL_STEP),
                       (torch.float64, TOL_STEP64)):
        model.load_state_dict(state_dict_from_jax(v, model), strict=True)
        got = _port_steps(model, batches, schedule_args, fused=False,
                          dtype=dtype)
        assert max(_rel(a, b) for a, b in zip(got, want)) <= tol, (
            dtype, got, want)


@pytest.mark.parametrize("model_no,n_cont", [(1, 0), (3, 2)])
def test_fused_stem_steps_match_unfused(model_no, n_cont):
    """Three Adam steps with the fused stem (the codes into each tower's
    first BN, conv and pool; the plain versions of K2/K3 on the CPU)
    against the port's unfused steps and the JAX package's, within 1e-4
    per step: SNVNet1, and SNVNet3 with continuous features and no track
    channels (``--without_bw_distal``)."""
    config = _no_dropout()
    jmodel, v, _, _ = _pair(model_no, n_cont, 4, config, seed=7,
                            nontrivial=False)
    batches = _batches(9, n_cont, 4)
    schedule_args = ("StepLR", 5e-3, 0.9, B, 3 * B * 2, 1e-4, 1e-6)
    runs = {}
    for fused in (True, False):
        model = build_model(model_no, config, _common(n_cont, 4), "snv")
        model.load_state_dict(state_dict_from_jax(v, model), strict=True)
        runs[fused] = _port_steps(model, batches, schedule_args, fused)
    want = _jax_steps(jmodel, v, batches, schedule_args)
    for got in runs.values():
        assert max(_rel(a, b) for a, b in zip(got, want)) <= TOL_STEP, (
            got, want)
    assert max(_rel(a, b) for a, b in zip(runs[True], runs[False])
               ) <= TOL_STEP


def test_fused_stem_refuses_track_channels():
    model = build_model(3, CONFIG, _common(2, 6), "snv")
    codes = torch.zeros((2, W), dtype=torch.uint8)
    with pytest.raises(ValueError, match="in_channels == 4"):
        model(torch.zeros((2, N_CAT), dtype=torch.long), codes,
              torch.zeros((2, 2)))


@pytest.mark.parametrize("use_reverse", [True, False])
def test_unet_with_track_channels_matches_jax(use_reverse):
    """The U-Net on 4 + 2 input channels: the stem (or the first encoder
    conv) takes all six, the ``use_reverse`` flip covers every channel;
    eval forward within 1e-5 of the largest output."""
    rng = np.random.default_rng(21)
    width, down = 200, (1, 2, 2, 5, 5, 1)
    codes = rng.integers(0, 4, size=(B, width)).astype(np.uint8)
    tracks = rng.random((B, width, 2)).astype(np.float32)
    x = np.asarray(_j_distal(codes, tracks))
    jmodel = j_indel.UNetSmall(8, 4, 7, down, use_reverse)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, None, None, jnp.asarray(x), False),
        jax.random.key(0))
    v = materialize_variables({"params": shapes["params"],
                               "batch_stats": shapes["batch_stats"]}, 0)
    v = {c: {k: jax.tree.map(
        lambda a: (a * rng.uniform(0.8, 1.25, a.shape)).astype(np.float32)
        if c == "batch_stats" else np.asarray(a), t)
        for k, t in v[c].items()} for c in ("params", "batch_stats")}
    model = UNetSmall(8, 4, 7, down, use_reverse, in_channels=6)
    model.load_state_dict(state_dict_from_jax(v, model), strict=True)
    first = "conv.0.weight" if use_reverse else "uplblocks.0.0.weight"
    assert model.state_dict()[first].shape[1] == 6
    ref = np.asarray(jmodel.apply(v, None, None, jnp.asarray(x), False))
    model.eval()
    with torch.no_grad():
        out = model(None, model_input(_t(codes), False, _t(tracks)),
                    torch.zeros((B, 2)))
    _close(out.numpy(), ref, TOL)
    config = dict(down_list=list(down), CNN_out_channels=4,
                  CNN_kernel_size=7, use_reverse=use_reverse, model_no=0,
                  n_class=8, emb_dims=[])
    built = build_model_from_config(config, 2, "indel")
    assert built.state_dict()[first].shape == model.state_dict()[
        first].shape
