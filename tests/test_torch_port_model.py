"""Port SNVNet2 (mural_tpu_torch.models.snv) and its BN-folded fused
forward (mural_tpu_torch.ops.fused_inference) against the JAX package on
the CPU, with the same weights carried over by the weight bridge
(mural_tpu_torch.utils.convert.state_dict_from_jax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mural_tpu.models.init import materialize_variables
from mural_tpu.models.layers import ResNetTower as JTower
from mural_tpu.models.layers import one_hot_from_codes as j_one_hot
from mural_tpu.models.layers import MID_POOLS as J_MID_POOLS
from mural_tpu.models.snv import SNVNet2 as JSNVNet2
from mural_tpu.ops.fused_inference import fold_snv2 as j_fold_snv2
from mural_tpu.ops.fused_inference import \
    snv2_fused_forward as j_snv2_fused_forward
from mural_tpu_torch.models.layers import MID_POOLS, ResNetTower
from mural_tpu_torch.models.layers import one_hot_from_codes
from mural_tpu_torch.models.snv import SNVNet2
from mural_tpu_torch.ops.fused_inference import fold_snv2, snv2_fused_forward
from mural_tpu_torch.train.checkpoint import (clean_state_dict,
                                              load_checkpoint,
                                              save_checkpoint)
from mural_tpu_torch.utils.convert import state_dict_from_jax

# tests/test_fused_inference.py's widths
KW = dict(emb_vocab=65, n_cat=13, lin_layer_sizes=[48, 24], emb_dropout=0.1,
          lin_layer_dropouts=[0.1, 0.1], in_channels=4, out_channels=16,
          kernel_size=3, distal_fc_dropout=0.25, n_class=4)


def _nontrivial(tree, rng):
    """Random BN statistics and affine parameters (and non-zero biases),
    so that every fold is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _nontrivial(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _variables(module, *inputs, seed=0):
    shapes = jax.eval_shape(lambda k: module.init(k, *inputs, False),
                            jax.random.key(0))
    v = materialize_variables({"params": shapes["params"],
                               "batch_stats": shapes["batch_stats"]}, seed)
    rng = np.random.default_rng(seed)
    return {c: _nontrivial(jax.tree.map(np.asarray, v[c]), rng)
            for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    cat = rng.integers(0, 65, size=(8, 13)).astype(np.int32)
    codes = rng.integers(0, 15, size=(8, 401)).astype(np.uint8)
    codes[0, :20] = 14              # a run of N at the window edge
    jmodel = JSNVNet2(**KW)
    variables = _variables(jmodel, jnp.asarray(cat), None,
                           j_one_hot(jnp.asarray(codes)))
    model = SNVNet2(**KW)
    model.load_state_dict(state_dict_from_jax(variables, model),
                          strict=False)
    model.eval()
    return jmodel, variables, model, cat, codes


def test_snvnet2_eval_matches_jax(setup):
    jmodel, variables, model, cat, codes = setup
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(cat), None,
                                  j_one_hot(jnp.asarray(codes)), False))
    with torch.no_grad():
        out = model(torch.from_numpy(cat).long(),
                    one_hot_from_codes(torch.from_numpy(codes))).numpy()
    assert out.shape == (8, 4)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_fused_forward_matches_jax_fused(setup):
    jmodel, variables, model, cat, codes = setup
    ref = np.asarray(j_snv2_fused_forward(
        j_fold_snv2(variables, {"CNN_kernel_size": 3}), jnp.asarray(cat),
        jnp.asarray(codes), k=3, interpret=True))
    with torch.no_grad():
        out = snv2_fused_forward(fold_snv2(model),
                                 torch.from_numpy(cat).long(),
                                 torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_resnet_tower_matches_jax(setup):
    _, variables, model, _, _ = setup
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 201, 4)).astype(np.float32)
    tower_vars = {c: variables[c]["towers"]["tower1"]
                  for c in ("params", "batch_stats")}
    ref = np.asarray(JTower(16, 3, J_MID_POOLS).apply(
        tower_vars, jnp.asarray(x), False))
    # tower 1's layers sit under the same names in SNVNet2
    tower = ResNetTower(4, 16, 3, MID_POOLS)
    own = tower.state_dict()
    tower.load_state_dict({k: v for k, v in model.state_dict().items()
                           if k in own})
    tower.eval()
    with torch.no_grad():
        out = tower(torch.from_numpy(x).transpose(1, 2)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_weight_bridge_rejects_bad_leaves(setup):
    _, variables, model, _, _ = setup
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["local_fc"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        state_dict_from_jax(bad, model)
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["local_fc"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_jax(bad, model)


def test_checkpoint_roundtrip_and_reference_keys(setup, tmp_path):
    _, variables, model, cat, codes = setup
    path = str(tmp_path / "model")
    save_checkpoint(path, model, {"model_no": 2})
    # the reference's ResBlocks register their layers twice
    # (``RBs1.0.layer.N.*``) and its BNs carry num_batches_tracked
    sd = torch.load(path, weights_only=True)
    assert not any(".layer." in k or "tracked" in k for k in sd)
    sd["RBs1.0.layer.2.weight"] = sd["RBs1.0.conv1.weight"].clone()
    sd["conv1.0.num_batches_tracked"] = torch.tensor(7)
    assert set(clean_state_dict(sd)) == set(
        clean_state_dict(model.state_dict()))
    torch.save(sd, str(tmp_path / "ref_model"))
    loaded = load_checkpoint(str(tmp_path / "ref_model"), SNVNet2(**KW))
    loaded.eval()
    with torch.no_grad():
        args = (torch.from_numpy(cat).long(),
                one_hot_from_codes(torch.from_numpy(codes)))
        assert torch.equal(loaded(*args), model(*args))
