"""Weight bridge from the JAX package's Flax variables to the port's
state_dict (the reference MuRaL key layout).

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays under Flax names (what a ``mural_tpu`` msgpack checkpoint holds).
Conv kernels go from Flax (k, in, out) to torch (out, in, k), dense
kernels from (in, out) to (out, in); ``scale`` becomes ``weight`` and
``mean``/``var`` become ``running_mean``/``running_var``.  The name map
is that of ``mural_tpu/utils/torch_import.py:126-207`` (SNVNet0-3 and
the INDEL U-Net).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "bias": "bias", "mean": "running_mean",
               "var": "running_var"}


def torch_prefix(keys: List[str]) -> str:
    """Flax module path (without the leaf name) -> reference torch module
    prefix, for the SNV models and the INDEL U-Net."""
    if keys[0] == "model":
        # SNVNet0 wraps FeedForwardNN as ``model``
        return "model." + torch_prefix(keys[1:])
    head = keys[0]
    if head == "local":
        sub = keys[1]
        if sub == "emb_layer":
            return "emb_layer"
        if sub == "first_bn":
            return "first_bn_layer"
        if sub.startswith("lin_"):
            return f"lin_layers.{sub[4:]}"
        if sub.startswith("bn_"):
            return f"bn_layers.{sub[3:]}"
    elif head in _SNV_HEADS:
        return _SNV_HEADS[head]
    elif head == "towers":
        tower = keys[1]
        if tower.startswith("distal_fc"):
            return f"{tower}.{ {'bn': 0, 'fc': 2}[keys[2]] }"
        suffix = "_2" if tower == "tower2" else ""
        sub = keys[2]
        if sub in ("conv1", "conv2", "conv3"):
            return f"{sub}{suffix}.{ {'bn': 0, 'conv': 1}[keys[3]] }"
        if sub.startswith("RBs"):
            group, j = sub.split("_")          # RBs1_0 -> RBs1, 0
            return f"{group}{suffix}.{j}.{keys[3]}"
    elif head in _INDEL_FIXED:
        return _INDEL_FIXED[head]
    elif "_" in head:
        kind, level = head.rsplit("_", 1)
        if kind in _INDEL_LEVELS:
            return _INDEL_LEVELS[kind].format(level)
        if kind in ("upblock", "downblock") and len(keys) == 2:
            idx = {"conv_expand": 0, "bn1": 1, "conv_project": 3,
                   "bn2": 4}[keys[1]]
            return f"{kind}s.{level}.0.conv.{idx}"
    raise KeyError(f"no torch name for Flax path {'/'.join(keys)}")


# the SNV output heads (mural_tpu/utils/torch_import.py:143-151)
_SNV_HEADS = {"local_fc": "local_fc.0", "output_layer": "output_layer",
              "local_fc2_bn": "local_fc2.0", "local_fc2": "local_fc2.2"}
# the INDEL U-Net (mural_tpu/utils/torch_import.py:176-206)
_INDEL_FIXED = {"stem_conv": "conv.0", "stem_bn": "conv.1",
                "out_conv1": "out_conv.0", "out_bn": "out_conv.1",
                "out_conv2": "out_conv.3", "out_fc_bn": "out_fc.0",
                "out_fc": "out_fc.2"}
_INDEL_LEVELS = {"uplblock": "uplblocks.{}.0", "uplbn": "uplblocks.{}.1",
                 "downlblock": "downlblocks.{}.1",
                 "downlbn": "downlblocks.{}.2"}


def _leaves(tree: Dict, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def state_dict_from_jax(variables: Dict,
                        model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict of ``model`` filled from Flax ``variables``.

    Raises KeyError on a Flax leaf with no torch name or a model entry
    left unfilled, ValueError on a shape mismatch."""
    target = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for keys, arr in _leaves(variables.get(coll, {})):
            leaf = keys[-1]
            if leaf not in _LEAF_NAMES:
                raise KeyError(f"unmapped Flax leaf {'/'.join(keys)}")
            name = f"{torch_prefix(list(keys[:-1]))}.{_LEAF_NAMES[leaf]}"
            if leaf == "kernel":
                arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
            if name not in target:
                raise KeyError(f"Flax leaf {'/'.join(keys)} maps to "
                               f"{name}, which the model does not have")
            if tuple(arr.shape) != tuple(target[name].shape):
                raise ValueError(
                    f"shape mismatch for {name}: Flax {arr.shape} vs "
                    f"torch {tuple(target[name].shape)}")
            out[name] = torch.from_numpy(np.array(arr)).to(
                target[name].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"Flax variables leave model entries unfilled: "
                       f"{missing}")
    # Flax tracks no BN step count; a fresh counter completes the
    # state_dict, so it loads with strict=True
    for name, value in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros_like(value)
    return out
