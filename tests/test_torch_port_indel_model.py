"""The port's INDEL U-Net (mural_tpu_torch.models.indel) against the JAX
package's on the CPU, with the same weights carried over by the weight
bridge (mural_tpu_torch.utils.convert.state_dict_from_jax): eval and
train forwards, running statistics and gradients, the reference key set,
the reverse-complement stem, the geometry rule and the reference init.
The head's Dropout(0.1) is hard-wired and Flax and torch draw different
masks, so the train-mode test turns it off on both sides."""
import copy
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.models.indel as j_indel
from mural_tpu.models.init import materialize_variables
from mural_tpu.models.layers import one_hot_from_codes as j_one_hot
from mural_tpu.utils.torch_import import _torch_prefix
from mural_tpu_torch.models.indel import UNetSmall
from mural_tpu_torch.models.init import init_weights
from mural_tpu_torch.models.layers import one_hot_from_codes
from mural_tpu_torch.utils.convert import state_dict_from_jax

# U-Net outputs, running statistics and gradients, port against JAX, as
# a fraction of the largest entry (at least 1): float32 reassociation
TOL = 1e-5
# the same in float64 on both sides
TOL64 = 1e-10
SMALL = dict(width=200, down=(1, 2, 2, 5, 5, 1), channels=4, batch=8)
# the mural_indel train defaults: --distal_radius 4000, 8 channels
CLI_DEFAULT = dict(width=8000, down=(1, 4, 5, 5, 5, 2), channels=8, batch=2)
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


class _NoDropout:
    """Stands in for flax's ``nn.Dropout`` inside mural_tpu.models.indel."""

    def __init__(self, rate, deterministic=None, name=None):
        pass

    def __call__(self, x):
        return x


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch while this module runs: the suite
    runs one process per core, and the U-Net's CPU convolutions slow
    down by orders of magnitude when every process also starts a thread
    per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(j_indel, "nn", types.SimpleNamespace(
        **{**vars(flax.linen), "Dropout": _NoDropout}))


def _nontrivial(tree, rng):
    """BN statistics and affine parameters, and biases, drawn around
    their initial values (within 25%, so that the 28 BNs in a row keep
    the activations near unit scale)."""
    return {k: _nontrivial(v, rng) if isinstance(v, dict) else
            (rng.uniform(0.8, 1.25, v.shape) if k in ("scale", "var") else
             rng.normal(0, 0.2, v.shape) if k in ("bias", "mean") else
             np.asarray(v)).astype(np.float32)
            for k, v in tree.items()}


def _close(got, want, what="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _codes(rng, batch, width):
    codes = rng.integers(0, 4, size=(batch, width)).astype(np.uint8)
    codes[rng.random((batch, width)) < 0.02] = 14           # N
    codes[0, :30] = 14                                       # an N run
    return codes


def _pair(cfg, use_reverse, seed=0):
    """A JAX U-Net with non-trivial weights and BN statistics, the port's
    U-Net holding the same ones (strict load), and a one-hot batch."""
    rng = np.random.default_rng(seed)
    codes = _codes(rng, cfg["batch"], cfg["width"])
    x = np.array(j_one_hot(jnp.asarray(codes)))
    jmodel = j_indel.UNetSmall(8, cfg["channels"], 7, cfg["down"],
                               use_reverse)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, None, None, jnp.asarray(x), False),
        jax.random.key(0))
    v = materialize_variables({"params": shapes["params"],
                               "batch_stats": shapes["batch_stats"]}, seed)
    v = {c: _nontrivial(jax.tree.map(np.asarray, v[c]), rng)
         for c in ("params", "batch_stats")}
    model = UNetSmall(8, cfg["channels"], 7, cfg["down"], use_reverse)
    model.load_state_dict(state_dict_from_jax(v, model), strict=True)
    return jmodel, v, model, codes, x


@pytest.mark.parametrize("cfg,use_reverse", [
    (SMALL, False), (SMALL, True), (CLI_DEFAULT, True)],
    ids=["small", "small-reverse", "cli-default-reverse"])
def test_eval_forward_matches_jax(cfg, use_reverse):
    jmodel, v, model, codes, x = _pair(cfg, use_reverse)
    ref = np.asarray(jmodel.apply(v, None, None, jnp.asarray(x), False))
    model.eval()
    with torch.no_grad():
        out = model(None, one_hot_from_codes(torch.from_numpy(codes)))
    assert out.shape == (cfg["batch"], 8) and (out >= 0).all()
    print("largest output", float(np.abs(ref).max()),
          "max |diff|", float(np.abs(out.numpy() - ref).max()))
    _close(out, ref)


@pytest.mark.parametrize("use_reverse", [False, True])
def test_train_forward_stats_and_grads_match_jax(use_reverse,
                                                 no_jax_dropout):
    """Train mode, against the JAX package run in float64: the forward,
    every running statistic after it (the stem's BN updated twice) and
    every parameter gradient of a random cotangent.  The port in float64
    agrees within TOL64; the port in float32 holds the forward and the
    statistics within TOL.  (The JAX package's own float32 forward stands
    further than TOL from its float64 one on this input: its single-pass
    BN variance shifted by the running mean loses digits at the deepest
    levels, where a batch of 8 has 16 positions per channel.  Float32
    gradients of either package stand further than TOL from float64, so
    they are held in float64 only.)"""
    with jax.enable_x64(True):
        jmodel, v, model, codes, x = _pair(SMALL, use_reverse, seed=1)
        x = x.astype(np.float64)
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        g = np.random.default_rng(2).normal(size=(SMALL["batch"], 8))

        def loss(params):
            out, upd = jmodel.apply({"params": params,
                                     "batch_stats": v["batch_stats"]}, None,
                                    None, jnp.asarray(x), True,
                                    mutable=["batch_stats"])
            return jnp.sum(out * g), (out, upd["batch_stats"])

        grads, (ref, stats) = jax.grad(loss, has_aux=True)(v["params"])
        ref_sd = state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, grads),
             "batch_stats": jax.tree.map(np.asarray, stats)},
            copy.deepcopy(model).double())

    for dtype, tol in ((torch.float64, TOL64), (torch.float32, TOL)):
        m = copy.deepcopy(model).to(dtype).train()
        m.out_fc[1].p = 0.0
        out = m(None, torch.from_numpy(x).to(dtype))
        (out * torch.from_numpy(g).to(dtype)).sum().backward()
        _close(out.detach(), ref, tol=tol)
        stats = {name: b for name, b in m.named_buffers()
                 if not name.endswith("num_batches_tracked")}
        grads = {name: p.grad for name, p in m.named_parameters()}
        assert set(stats) | set(grads) == {k for k in ref_sd
                                           if "tracked" not in k}
        held = list(stats.items())
        if dtype == torch.float64:
            held += list(grads.items())
        for name, value in held:
            _close(value, ref_sd[name], name, tol=tol)
        if use_reverse:
            assert int(m.conv[1].num_batches_tracked) == 2


def test_state_dict_keys_are_the_reference_map():
    """The port's state_dict keys are those that mural_tpu's reference
    checkpoint importer maps the Flax U-Net's leaves to."""
    for use_reverse in (False, True):
        jmodel, v, model, _, _ = _pair(SMALL, use_reverse)
        keys = {f"{_torch_prefix(path[:-1])}.{_LEAF_NAMES[path[-1]]}"
                for coll in ("params", "batch_stats")
                for path in _paths(v[coll])}
        ours = {k for k in model.state_dict()
                if not k.endswith("num_batches_tracked")}
        assert ours == keys
        assert ("conv.0.weight" in ours) == use_reverse
        assert {"upblocks.5.0.conv.3.weight", "downblocks.4.0.conv.4.bias",
                "downlblocks.0.1.weight", "out_conv.3.bias",
                "out_fc.2.weight"} <= ours


def _paths(tree, prefix=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _paths(val, prefix + (k,))
        else:
            yield prefix + (k,)


def test_stem_is_reverse_complement_equivariant():
    """stem(revcomp(x)) == stem(x) flipped along length, in (N, 4, L)."""
    _, _, model, codes, x = _pair(SMALL, True)
    model.eval()
    with torch.no_grad():
        xt = torch.from_numpy(x).transpose(1, 2)
        s = model.stem(xt)
        s_rc = model.stem(xt.flip(1, 2))
    torch.testing.assert_close(s_rc, s.flip(2), rtol=0, atol=1e-6)


def test_geometry_rule():
    """W=95 with down_list 3,2,2,2,2,2 aligns (ceil(95/3) = 32 = 2^5) and
    runs in the port, as in the reference torch model; the JAX package
    rejects it by its own rule.  W=400 with the default down_list does
    not align and raises naming the flags."""
    rng = np.random.default_rng(4)
    down = (3, 2, 2, 2, 2, 2)
    x = np.asarray(j_one_hot(jnp.asarray(_codes(rng, 3, 95))))
    model = UNetSmall(8, 4, 7, down, True).eval()
    with torch.no_grad():
        out = model(None, torch.from_numpy(x))
    assert out.shape == (3, 8) and torch.isfinite(out).all()
    jmodel = j_indel.UNetSmall(8, 4, 7, down, True)
    with pytest.raises(ValueError, match="down_list"):
        jmodel.init(jax.random.key(0), None, None, jnp.asarray(x), False)
    default = UNetSmall(8, 8, 7, CLI_DEFAULT["down"], True)
    with pytest.raises(ValueError, match="--down_list") as err:
        default(None, torch.zeros(1, 400, 4))
    assert "--distal_radius" in str(err.value)


def test_init_weights_on_the_unet():
    """The reference init runs on the U-Net (its ConvBlock convs have no
    bias): conv biases zero, bias-free convs stay bias-free, BN reset."""
    model = UNetSmall(8, 4, 7, SMALL["down"], True)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(0.5)
    init_weights(model, torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv1d)]
    bias_free = [m for m in convs if m.bias is None]
    assert len(bias_free) == 2 * 11                 # 11 ConvBlocks
    assert all(float(m.bias.abs().max()) == 0 for m in convs
               if m.bias is not None)
    for m in convs:
        out_c, in_c, k = m.weight.shape
        a = (6.0 / (in_c * k + out_c * k)) ** 0.5
        assert float(m.weight.abs().max()) <= a and m.weight.std() > 0
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            assert float((m.weight - 1).abs().max()) == 0
            assert float(m.bias.abs().max()) == 0
    assert float(model.out_fc[2].bias.abs().max()) == 0
