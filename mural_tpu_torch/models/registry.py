"""Model construction from a checkpoint config (counterpart of
``mural_tpu/models/registry.py`` and
``mural_tpu/predict/pipeline.py:58-77 build_model_from_config``).

SNV ``model_no`` 2 (SNVNet2) and the INDEL U-Net (``model_no`` 0) are
ported; every other architecture raises ``NotImplementedError`` naming
its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from mural_tpu_torch.models.indel import UNetSmall
from mural_tpu_torch.models.snv import SNVNet2

_NOT_PORTED = {
    ("snv", 0): "SNVNet0 is not ported yet (ROADMAP.md item 6)",
    ("snv", 1): "SNVNet1 is not ported yet (ROADMAP.md item 6)",
    ("snv", 3): "SNVNet3 is not ported yet (ROADMAP.md item 6)",
}


def check_model_no(model_no: int, model_type: str) -> None:
    """Raise unless ``model_no`` names an architecture the port builds:
    ``ValueError`` for an INDEL number other than 0 (the JAX package's
    error), ``NotImplementedError`` naming ROADMAP.md item 6 for an SNV
    number other than 2."""
    if model_type == "indel":
        if model_no != 0:
            raise ValueError(f"model_no for indel must be one of [0], got "
                             f"{model_no}")
    elif model_no != 2:
        raise NotImplementedError(_NOT_PORTED.get(
            (model_type, model_no),
            f"{model_type} model_no {model_no} is not ported yet "
            "(ROADMAP.md item 6)"))


def build_model(model_no: int, config: Dict, common: Dict,
                model_type: str) -> nn.Module:
    """SNVNet2 or UNetSmall from a MuRaL-style config dict; ``common``
    carries ``emb_dims``, ``n_class`` and ``in_channels``."""
    check_model_no(model_no, model_type)
    if model_type == "indel":
        return UNetSmall(
            n_class=common["n_class"],
            out_channels=config["CNN_out_channels"],
            kernel_size=config["CNN_kernel_size"],
            downsize=config["down_list"],
            use_reverse=bool(config.get("use_reverse", False)))
    return SNVNet2(
        emb_vocab=4 ** config["local_order"] + 1,
        n_cat=len(common["emb_dims"]),
        lin_layer_sizes=[config["local_hidden1_size"],
                         config["local_hidden2_size"]],
        emb_dropout=config["emb_dropout"],
        lin_layer_dropouts=[config["local_dropout"]] * 2,
        in_channels=common["in_channels"],
        out_channels=config["CNN_out_channels"],
        kernel_size=config["CNN_kernel_size"],
        distal_fc_dropout=config["distal_fc_dropout"],
        n_class=common["n_class"])


def build_model_from_config(config: Dict, n_cont: int,
                            model_type: str) -> nn.Module:
    """Architecture from the checkpoint's ``model.config.pkl``; distal
    track channels (``n_cont > 0``) are not ported yet."""
    if n_cont:
        raise NotImplementedError(
            "track features (n_cont > 0) are not ported yet "
            "(ROADMAP.md item 6)")
    common = {
        "emb_dims": config["emb_dims"],
        "n_class": config["n_class"],
        "in_channels": 4 ** config.get("distal_order", 1),
    }
    return build_model(config["model_no"], config, common, model_type)
