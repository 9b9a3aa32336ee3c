"""Port kernel module K1 (mural_tpu_torch.ops.fused_code_conv) against the
JAX package's fused_code_conv on the CPU: the folded table, the plain
PyTorch version against the JAX reference and the Pallas kernel in
interpret mode, and the CPU path of the wrapper."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mural_tpu.models.layers import BNConv, one_hot_from_codes
from mural_tpu.ops import fused_code_conv as jfc
from mural_tpu_torch.ops import fused_code_conv as tfc


def _setup(B=8, L=64, k=3, C=32, seed=0):
    """tests/test_pallas_ops.py's recipe: a BNConv with non-trivial BN."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 15, size=(B, L)).astype(np.uint8)
    module = BNConv(C, k)
    variables = module.init(jax.random.key(seed),
                            one_hot_from_codes(jnp.asarray(codes)), False)
    variables = jax.tree.map(np.asarray, variables)
    bs = variables["batch_stats"]["bn"]
    bs["mean"] = rng.normal(0.2, 0.1, 4).astype(np.float32)
    bs["var"] = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    p = variables["params"]["bn"]
    p["scale"] = rng.normal(1, 0.2, 4).astype(np.float32)
    p["bias"] = rng.normal(0, 0.2, 4).astype(np.float32)
    return codes, variables


def _fold_args(variables):
    p, s = variables["params"], variables["batch_stats"]
    return (p["conv"]["kernel"], p["conv"]["bias"], p["bn"]["scale"],
            p["bn"]["bias"], s["bn"]["mean"], s["bn"]["var"])


def _t(a):
    return torch.tensor(np.asarray(a))


def _tables(variables):
    """(JAX table, bias) as numpy and the port's as torch tensors."""
    args = _fold_args(variables)
    kern, cbias, scale, bbias, mean, var = args
    jt, jb = jfc.fold_bn_conv_table(*map(jnp.asarray, args))
    tt, tb = tfc.fold_bn_conv_table(_t(kern.transpose(2, 1, 0)), _t(cbias),
                                    _t(scale), _t(bbias), _t(mean), _t(var))
    return (np.asarray(jt), np.asarray(jb)), (tt, tb)


@pytest.mark.parametrize("k,C", [(3, 32), (7, 8)])
def test_fold_bn_conv_table_matches_jax(k, C):
    _, variables = _setup(k=k, C=C)
    (jt, jb), (tt, tb) = _tables(variables)
    assert tt.shape == (k, 16, C)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-6, rtol=0)
    assert np.all(tt.numpy()[:, 15] == 0)          # sentinel row


@pytest.mark.parametrize("k,L,C,B", [(3, 64, 32, 8), (7, 512, 8, 4),
                                     (3, 401, 32, 8)])
def test_reference_matches_jax_reference_and_interpret_kernel(k, L, C, B):
    codes, variables = _setup(B=B, k=k, L=L, C=C)
    (jt, jb), _ = _tables(variables)
    jref = np.asarray(jfc.code_conv1d_reference(
        jnp.asarray(codes), jnp.asarray(jt), jnp.asarray(jb)))
    jkern = np.asarray(jfc.code_conv1d(
        jnp.asarray(codes), jnp.asarray(jt), jnp.asarray(jb),
        interpret=True))
    out = tfc.code_conv1d_reference(torch.from_numpy(codes), _t(jt),
                                    _t(jb)).numpy()
    assert out.shape == (B, L, C) and out.dtype == np.float32
    np.testing.assert_allclose(out, jref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, jkern, atol=1e-5, rtol=0)


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing(monkeypatch):
    codes, variables = _setup(B=4, L=401)
    (jt, jb), _ = _tables(variables)
    monkeypatch.setattr(tfc, "LAUNCHES", 0)
    t_codes = torch.from_numpy(codes)
    crop = t_codes[:, 100:301]          # tower 1's strided crop view
    for c in (t_codes, crop):
        out = tfc.code_conv1d(c, _t(jt), _t(jb))
        ref = tfc.code_conv1d_reference(c.contiguous(), _t(jt), _t(jb))
        assert torch.equal(out, ref)
    assert tfc.LAUNCHES == 0
