"""The port's train step on SNVNet2 with the fused stem (the plain
versions of K2/K3 on the CPU) against the JAX package's packed single
step, over three optimizers.  Every dropout is 0: Flax and torch draw
their dropout masks from different generators."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
from mural_tpu.models.registry import build_model as j_build_model
from mural_tpu.train import optim as j_optim
from mural_tpu.train.packed import make_packed_train_step, pack_state
from mural_tpu.train.state import create_train_state
from mural_tpu_torch.models.registry import build_model
from mural_tpu_torch.train.optim import LRSchedule, build_optimizer
from mural_tpu_torch.train.steps import TrainState, train_step
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_train import CONFIG, _rel


def _common(n_cat):
    return {"emb_dims": [(17, 2)] * n_cat, "n_cont": 0, "n_class": 4,
            "distal_order": 1, "in_channels": 4}


@pytest.mark.parametrize("optim,sched", [("Adam", "StepLR"),
                                         ("AdamW2", "StepLR2"),
                                         ("SGD", "StepLR")])
def test_fused_train_steps_match_jax_packed_step(optim, sched):
    """Three train steps of the port (fused stem, plain K2/K3 on the CPU)
    against ``make_packed_train_step(fused_stem=True)``.  torch's
    clip_grad_norm_ adds 1e-6 to the norm and optax's clip does not: when
    clipping fires the updates differ by ~1e-7 relative, far inside the
    1e-4 loss tolerance."""
    rng = np.random.default_rng(31)
    B, steps, n_cat = 16, 3, 7
    jmodel = j_build_model(2, CONFIG, _common(n_cat), "snv")

    class _DS:
        cat = np.zeros((2, n_cat), np.int32)
        n_cont = 0
        distal_width = 401
        n_distal_tracks = 0

    variables = j_loop._init_variables(jmodel, _DS(), 4)
    schedule_args = (sched, 5e-3, 0.9, B, steps * B * 2, 1e-4, 1e-6)
    wd = 1e-2
    jstate = pack_state(create_train_state(
        jmodel, variables, optim, wd,
        j_optim.LRSchedule.build(*schedule_args)))
    jstep = make_packed_train_step(jmodel, jstate, donate=False,
                                   fused_stem=True)

    model = build_model(2, CONFIG, _common(n_cat), "snv")
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables), model), strict=True)
    state = TrainState(model, build_optimizer(optim, model.parameters(), wd),
                       LRSchedule.build(*schedule_args))
    for i in range(steps):
        y = rng.integers(0, 4, size=B).astype(np.int32)
        cat = rng.integers(0, 17, size=(B, n_cat)).astype(np.int32)
        codes = rng.integers(0, 15, size=(B, 401)).astype(np.uint8)
        jstate, jloss, jlr = jstep(
            jstate, jnp.asarray(y), jnp.asarray(cat), None,
            jnp.asarray(codes), jnp.ones((B,), jnp.float32),
            jax.random.key(0))
        loss, lr = train_step(state, torch.from_numpy(y).long(),
                              torch.from_numpy(cat).long(),
                              torch.from_numpy(codes), torch.ones(B))
        assert _rel(lr, float(jlr)) <= 1e-6
        assert _rel(float(loss), float(jloss)) <= 1e-4, (i, float(loss),
                                                         float(jloss))
