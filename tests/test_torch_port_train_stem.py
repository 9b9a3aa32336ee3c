"""The port's fused training stem (mural_tpu_torch.ops.fused_train_stem,
kernels K2/K3, and its module ``models.layers.fused_stem_pool``) against
the JAX package on the CPU.  JAX's ``code_conv_pool`` takes its f32
reference path on the CPU and the port takes the plain versions of K2
and K3, so both sum true float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mural_tpu.models.layers import FusedStemConvPool as JFusedStem
from mural_tpu.models.layers import one_hot_from_codes as j_one_hot
from mural_tpu.ops.fused_train_stem import _reference_fwd
from mural_tpu.ops.fused_train_stem import code_conv_pool as j_code_conv_pool
from mural_tpu.ops.fused_train_stem import \
    hist_batch_stats as j_hist_batch_stats
from mural_tpu.train.loop import _init_variables
from mural_tpu_torch.models.layers import (BNConv, fused_stem_pool,
                                           one_hot_from_codes)
from mural_tpu_torch.models.snv import SNVNet2
from mural_tpu_torch.ops.fused_train_stem import (
    code_conv_pool, code_conv_pool_backward_reference,
    code_conv_pool_reference, hist_batch_stats, pool_out_len)
from mural_tpu_torch.utils.convert import state_dict_from_jax

C = 8
# (k, pk, pp, L, crop): tower 2, tower 1 on the centre crop of a 401 row,
# and an odd kernel/pool pair
CASES = [(3, 15, 7, 401, False), (3, 3, 1, 201, True), (5, 7, 3, 130, False)]


def _codes(rng, B, L):
    codes = rng.integers(0, 15, size=(B, L)).astype(np.uint8)
    codes[0, :9] = 14                      # an N run at the row edge
    codes[1] = np.tile([0, 1, 2], L)[:L]   # a repeat: tied pool windows
    return codes


def _inputs(rng, k, L, crop, B=6):
    """(port codes, JAX codes, table, bias); the crop case hands the port
    a strided view of 401-wide rows, as tower 1 does."""
    if crop:
        full = _codes(rng, B, 401)
        port = torch.from_numpy(full)[:, 100:301]
        jcodes = full[:, 100:301]
    else:
        jcodes = _codes(rng, B, L)
        port = torch.from_numpy(jcodes)
    table = rng.normal(size=(k, 16, C)).astype(np.float32)
    table[:, 15, :] = 0.0                  # sentinel row: conv zero padding
    bias = rng.normal(size=(C,)).astype(np.float32)
    return port, jcodes, table, bias


@pytest.mark.parametrize("k,pk,pp,L,crop", CASES)
def test_k2_plain_matches_jax(k, pk, pp, L, crop):
    port, jcodes, table, bias = _inputs(np.random.default_rng(k + pk), k, L,
                                        crop)
    assert port.stride(0) == (401 if crop else L)
    pooled, jstar = code_conv_pool_reference(
        port, torch.from_numpy(table), torch.from_numpy(bias), pk, pp)
    P = pool_out_len(L, pk, pp)
    assert pooled.shape == jstar.shape == (6, C, P)
    assert jstar.dtype == torch.uint8
    want = np.asarray(j_code_conv_pool(jnp.asarray(jcodes),
                                       jnp.asarray(table),
                                       jnp.asarray(bias), pk, pp))
    # both add the same f32 terms in the same order
    np.testing.assert_allclose(pooled.numpy(), want.transpose(0, 2, 1),
                               rtol=0, atol=1e-6)
    _, j_jstar = _reference_fwd(jnp.asarray(jcodes), jnp.asarray(table),
                                jnp.asarray(bias), pk, pp)
    np.testing.assert_array_equal(jstar.numpy(),
                                  np.asarray(j_jstar).transpose(0, 2, 1))


@pytest.mark.parametrize("k,pk,pp,L,crop", CASES)
def test_k3_plain_matches_jax_grad(k, pk, pp, L, crop):
    rng = np.random.default_rng(2 * k + pk)
    port, jcodes, table, bias = _inputs(rng, k, L, crop)
    P = pool_out_len(L, pk, pp)
    w = rng.normal(size=(6, P, C)).astype(np.float32)

    def loss(t, b):
        return jnp.sum(j_code_conv_pool(jnp.asarray(jcodes), t, b, pk, pp)
                       * w)

    want_t, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                                    jnp.asarray(bias))
    t = torch.from_numpy(table).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    out = code_conv_pool(port, t, b, pk, pp)
    (out * torch.from_numpy(w).permute(0, 2, 1)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_b),
                               rtol=1e-5, atol=1e-5)
    # the plain K3 alone, from the forward's jstar
    _, jstar = code_conv_pool_reference(port, torch.from_numpy(table),
                                        torch.from_numpy(bias), pk, pp)
    dtable = code_conv_pool_backward_reference(
        port, jstar, torch.from_numpy(w).permute(0, 2, 1).contiguous(), k,
        pk, pp)
    np.testing.assert_allclose(dtable.numpy(), np.asarray(want_t),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [221, 401])
def test_hist_batch_stats_matches_jax(L):
    codes = _codes(np.random.default_rng(L), 16, L)
    got = hist_batch_stats(torch.from_numpy(codes))
    want = j_hist_batch_stats(jnp.asarray(codes))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _jax_stem(pool):
    import flax.linen as nn

    class Stem(nn.Module):
        @nn.compact
        def __call__(self, x, train):
            return JFusedStem(C, 3, pool, name="conv1")(x, train)
    return Stem()


def _load_stem(conv1, variables):
    p, s = variables["params"]["conv1"], variables["batch_stats"]["conv1"]
    values = [p["bn"]["scale"], p["bn"]["bias"], s["bn"]["mean"],
              s["bn"]["var"],
              np.asarray(p["conv"]["kernel"]).transpose(2, 1, 0),
              p["conv"]["bias"]]
    targets = [conv1[0].weight, conv1[0].bias, conv1[0].running_mean,
               conv1[0].running_var, conv1[1].weight, conv1[1].bias]
    with torch.no_grad():
        for t, v in zip(targets, values):
            t.copy_(torch.tensor(np.asarray(v)))
    return conv1


@pytest.mark.parametrize("pool", [(15, 15, 7), (3, 3, 1)])
def test_fused_stem_module_matches_jax(pool):
    """The port's fused stem against JAX FusedStemConvPool on the same
    converted weights, at the tolerances of the JAX package's own module
    test (tests/test_fused_train_stem.py:213-242)."""
    rng = np.random.default_rng(11)
    codes = _codes(rng, 8, 401)
    jmod = _jax_stem(pool)
    v = jmod.init(jax.random.key(0), jnp.asarray(codes), True)
    r = np.random.default_rng(5)
    variables = jax.tree.map(
        lambda a: jnp.asarray(r.normal(0.5, 0.7, size=a.shape), a.dtype), v)
    variables["batch_stats"] = jax.tree.map(
        lambda a: jnp.asarray(r.uniform(0.5, 1.5, size=a.shape), a.dtype),
        v["batch_stats"])

    out_j, mut_j = jmod.apply(variables, jnp.asarray(codes), True,
                              mutable=["batch_stats"])
    w = rng.normal(size=out_j.shape).astype(np.float32)

    def loss(p):
        o, _ = jmod.apply({"params": p,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(codes), True, mutable=["batch_stats"])
        return jnp.sum(o * w)

    g_j = jax.grad(loss)(variables["params"])["conv1"]

    conv1 = _load_stem(BNConv(4, C, 3), variables).train()
    out = fused_stem_pool(conv1, torch.from_numpy(codes), pool)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(out_j).transpose(0, 2, 1),
                               rtol=2e-4, atol=2e-5)
    bn_j = mut_j["batch_stats"]["conv1"]["bn"]
    np.testing.assert_allclose(conv1[0].running_mean.numpy(),
                               np.asarray(bn_j["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(conv1[0].running_var.numpy(),
                               np.asarray(bn_j["var"]), rtol=1e-5, atol=1e-6)
    assert int(conv1[0].num_batches_tracked) == 1
    (out * torch.from_numpy(w).permute(0, 2, 1)).sum().backward()
    grads = {
        "bn.scale": (conv1[0].weight.grad, g_j["bn"]["scale"]),
        "bn.bias": (conv1[0].bias.grad, g_j["bn"]["bias"]),
        "conv.kernel": (conv1[1].weight.grad.permute(2, 1, 0),
                        g_j["conv"]["kernel"]),
        "conv.bias": (conv1[1].bias.grad, g_j["conv"]["bias"])}
    for name, (g, want) in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=5e-4,
                                   atol=5e-4, err_msg=name)

    # eval mode normalises with the running statistics
    conv1 = _load_stem(BNConv(4, C, 3), variables).eval()
    with torch.no_grad():
        out_e = fused_stem_pool(conv1, torch.from_numpy(codes), pool)
    out_je = jmod.apply(variables, jnp.asarray(codes), False)
    np.testing.assert_allclose(out_e.numpy(),
                               np.asarray(out_je).transpose(0, 2, 1),
                               rtol=2e-4, atol=2e-5)


KW = dict(emb_vocab=65, n_cat=13, lin_layer_sizes=[30, 10], emb_dropout=0.0,
          lin_layer_dropouts=[0.0, 0.0], in_channels=4, out_channels=C,
          kernel_size=3, distal_fc_dropout=0.0, n_class=4)


@pytest.fixture(scope="module")
def converted():
    """JAX SNVNet2 initial variables (the JAX trainer's own init) carried
    over by the weight bridge."""
    from mural_tpu.models.snv import SNVNet2 as JSNVNet2

    class _DS:                              # what _init_variables reads
        cat = np.zeros((2, 13), np.int32)
        n_cont = 0
        distal_width = 401
        n_distal_tracks = 0

    jmodel = JSNVNet2(**KW)
    variables = jax.tree.map(np.asarray,
                             _init_variables(jmodel, _DS(), 3))
    model = SNVNet2(**KW)
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    return jmodel, variables, model


def test_converted_jax_init_fused_matches_unfused(converted):
    """Flax variables -> the port's state_dict loads strictly, and the
    fused and unfused eval forwards of the port agree."""
    jmodel, variables, model = converted
    rng = np.random.default_rng(21)
    cat = torch.from_numpy(rng.integers(0, 65, size=(8, 13))).long()
    codes = torch.from_numpy(_codes(rng, 8, 401))
    model.eval()
    with torch.no_grad():
        fused = model(cat, codes)
        unfused = model(cat, one_hot_from_codes(codes))
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=0,
                               atol=1e-5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(cat.numpy()), None,
                                   j_one_hot(jnp.asarray(codes.numpy())),
                                   False))
    np.testing.assert_allclose(fused.numpy(), want, rtol=0, atol=1e-4)


def test_port_fused_matches_unfused_train_mode(converted):
    """One train-mode forward/backward of the port's SNVNet2 on codes
    (fused stem) and on the one-hot (unfused): same loss, gradients,
    running statistics, and state_dict keys."""
    import copy
    _, _, model = converted
    rng = np.random.default_rng(22)
    cat = torch.from_numpy(rng.integers(0, 65, size=(16, 13))).long()
    codes = torch.from_numpy(_codes(rng, 16, 401))
    y = torch.from_numpy(rng.integers(0, 4, size=16)).long()
    runs = {}
    for fused in (True, False):
        m = copy.deepcopy(model).train()
        out = m(cat, codes if fused else one_hot_from_codes(codes))
        loss = torch.nn.functional.cross_entropy(out, y, reduction="sum")
        loss.backward()
        runs[fused] = (loss.item(), m)
    assert abs(runs[True][0] - runs[False][0]) <= 1e-5 * abs(runs[False][0])
    fused_m, unfused_m = runs[True][1], runs[False][1]
    sd_f, sd_u = fused_m.state_dict(), unfused_m.state_dict()
    assert list(sd_f) == list(sd_u)
    for name in sd_f:
        np.testing.assert_allclose(sd_f[name].double().numpy(),
                                   sd_u[name].double().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # tolerance scaled to each gradient's magnitude, as the JAX package's
    # model-level test does: f32 rounding accumulates differently along
    # the two paths
    for (name, pf), pu in zip(fused_m.named_parameters(),
                              unfused_m.parameters()):
        gf, gu = pf.grad.double().numpy(), pu.grad.double().numpy()
        assert np.max(np.abs(gf - gu)) <= 1e-4 * (np.max(np.abs(gu)) + 0.1), \
            name


def test_code_conv_pool_refuses_other_devices_and_bad_pools():
    codes = torch.zeros((2, 401), dtype=torch.uint8)
    table = torch.zeros((3, 16, C))
    bias = torch.zeros(C)
    with pytest.raises(ValueError, match="pk"):
        code_conv_pool(codes, table, bias, 15, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        code_conv_pool(codes.to("meta"), table.to("meta"), bias.to("meta"),
                       15, 7)
