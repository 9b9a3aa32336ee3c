"""The port's alternative losses (``mural_tpu_torch.train.losses``)
against ``mural_tpu.train.losses`` on the CPU: each loss and each
``loss_type`` of the class-balanced loss on the same inputs.  In float64
(JAX under ``jax.enable_x64``) the value and the gradient in the logits
(torch autograd against ``jax.grad``) agree within 1e-5 relative, the
gradient's elements within 1e-5 of its largest; in float32 the values
agree within 1e-5 relative.  float32 gradients are not compared: the
softmax variant's ``log(1 - p)`` cancels, and the two packages' float32
orders part by 2e-5 of the largest element there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mural_tpu.train import losses as jl
from mural_tpu_torch.train import losses as tl

RTOL = 1e-5


def _inputs(seed, n=512, k=4):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, k)) * 2).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    return logits, labels


def _check(t_fn, j_fn, logits):
    """Value and gradient of a scalar loss of the logits in float64, and
    the value in float32, both packages."""
    with jax.enable_x64(True):
        x = torch.tensor(logits.astype(np.float64), requires_grad=True)
        value = t_fn(x)
        value.backward()
        j_value, j_grad = jax.value_and_grad(j_fn)(
            jnp.asarray(logits, jnp.float64))
        assert value.dtype == torch.float64 and j_grad.dtype == jnp.float64
        np.testing.assert_allclose(value.item(), float(j_value), rtol=RTOL)
        scale = float(np.abs(np.asarray(j_grad)).max())
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad),
                                   rtol=RTOL, atol=RTOL * scale)
    value = t_fn(torch.from_numpy(logits))
    assert value.dtype == torch.float32
    np.testing.assert_allclose(value.item(), float(j_fn(jnp.asarray(logits))),
                               rtol=RTOL)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("gamma,size_average", [(0.0, False), (2.0, False),
                                                (0.5, True)])
def test_focal_ce_loss(k, gamma, size_average):
    logits, labels = _inputs(1, k=k)
    _check(lambda x: tl.focal_ce_loss(x, torch.from_numpy(labels), gamma,
                                      size_average),
           lambda x: jl.focal_ce_loss(x, jnp.asarray(labels), gamma,
                                      size_average), logits)


@pytest.mark.parametrize("gamma", [0.0, 1.0, 2.0])
def test_sigmoid_focal_loss(gamma):
    logits, labels = _inputs(2)
    one_hot = np.eye(4, dtype=np.float32)[labels]
    alpha = np.random.default_rng(3).uniform(0.2, 2.0, (512, 4)).astype(
        np.float32)
    _check(lambda x: tl.sigmoid_focal_loss(torch.from_numpy(one_hot), x,
                                           torch.from_numpy(alpha), gamma),
           lambda x: jl.sigmoid_focal_loss(jnp.asarray(one_hot), x,
                                           jnp.asarray(alpha), gamma),
           logits)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("loss_type", ["sigmoid", "focal", "softmax"])
def test_class_balanced_loss(k, loss_type):
    logits, labels = _inputs(4, k=k)
    counts = np.bincount(labels, minlength=k) * 100 + 7
    for beta, gamma in ((0.9999, 1.0), (0.99, 2.0)):
        _check(lambda x: tl.class_balanced_loss(
                   x, torch.from_numpy(labels), counts, k, loss_type, beta,
                   gamma),
               lambda x: jl.class_balanced_loss(
                   x, jnp.asarray(labels), counts, k, loss_type, beta,
                   gamma), logits)


def test_unknown_loss_type():
    logits, labels = _inputs(5)
    with pytest.raises(ValueError, match="unknown loss_type 'hinge'"):
        tl.class_balanced_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels), [1, 2, 3, 4], 4,
                               "hinge")
