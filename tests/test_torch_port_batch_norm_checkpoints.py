"""Checkpoints load into the port's models, whose BatchNorms of 3-D
activations are the port's ``BatchNorm1d`` (``ops/batch_norm.py``, kernel
K5 in train mode on a card), on the CPU.

A mural_tpu msgpack triple and a reference-layout triple (written by
``tests/test_torch_port_convert.py``'s helpers) load through
``load_zoo_checkpoint``: every BatchNorm slot of the towers or the U-Net
holds the port's class with the file's statistics, the eval forward is
within 1e-5 of mural_tpu's on the same variables, and a train-mode
forward and backward from the loaded state gives the same model's
numbers on torch's own BatchNorm bit for bit (on the CPU the port's
BatchNorm runs its plain version, torch's).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mural_tpu_torch.ops import batch_norm as bn
from mural_tpu_torch.utils.zoo import load_zoo_checkpoint
from test_torch_port_convert import _batch, _write_triples

# eval forwards, port against mural_tpu, as a fraction of the largest
# output (at least 1), as in test_torch_port_convert.py
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["snv", "indel"])
def triples(request, tmp_path_factory):
    return _write_triples(tmp_path_factory.mktemp(
        f"port_bn_ckpt_{request.param}"), request.param)


@pytest.mark.parametrize("source", ["ref", "msgpack"])
def test_checkpoints_load_into_the_port_bn(triples, source):
    t = triples
    model, config, model_type = load_zoo_checkpoint(str(t[source]))
    snv = model_type == "snv"
    slots = {n: m for n, m in model.named_modules()
             if isinstance(m, nn.BatchNorm1d)}
    ports = {n for n, m in slots.items() if type(m) is bn.BatchNorm1d}
    # SNV: the local branch's BatchNorms stay torch's
    assert set(slots) - ports == ({n for n in slots
                                   if n.startswith("bn_layers")}
                                  if snv else set())
    stats = t["v"]["batch_stats"]
    assert any(float(slots[n].running_var.sub(1).abs().max()) > 0
               for n in ports), "the file's statistics were not loaded"
    # the eval forward as mural_tpu's on the same variables
    cat, onehot = _batch(config, model_type, np.random.default_rng(5))
    want = np.asarray(t["jmodel"].apply(
        {"params": t["v"]["params"], "batch_stats": stats},
        jnp.asarray(cat) if snv else None, None, jnp.asarray(onehot), False))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(cat).long() if snv else None,
                    torch.from_numpy(onehot)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    # a train-mode step from the loaded state, against torch's BatchNorm
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if type(m) is bn.BatchNorm1d:
            m.__class__ = nn.BatchNorm1d
    y = torch.from_numpy(np.arange(len(cat)) % 4)
    losses = []
    for m in (model, twin):
        m.train()
        out = m(torch.from_numpy(cat).long() if snv else None,
                torch.from_numpy(onehot))
        loss = F.cross_entropy(out, y)
        loss.backward()
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    grads = dict(twin.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, grads[n].grad), n
    bufs = dict(twin.named_buffers())
    for n, b in model.named_buffers():
        assert torch.equal(b, bufs[n]), n
