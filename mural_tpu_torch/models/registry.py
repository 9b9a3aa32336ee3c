"""Model construction from a checkpoint config (counterpart of
``mural_tpu/models/registry.py`` and
``mural_tpu/predict/pipeline.py:58-77 build_model_from_config``).

SNV ``model_no`` 0-3 (SNVNet0-3) and the INDEL U-Net (``model_no`` 0).
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from mural_tpu_torch.models.indel import UNetSmall
from mural_tpu_torch.models.snv import SNVNet0, SNVNet1, SNVNet2, SNVNet3

MODEL_REGISTRY = {
    "snv": {0: SNVNet0, 1: SNVNet1, 2: SNVNet2, 3: SNVNet3},
    "indel": {0: UNetSmall},
}


def check_model_no(model_no: int, model_type: str) -> None:
    """Raise the JAX package's ``ValueError`` for an unknown model type or
    a ``model_no`` outside its family."""
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f"model_type must be one of "
                         f"{list(MODEL_REGISTRY)}, got {model_type}")
    model_map = MODEL_REGISTRY[model_type]
    if model_no not in model_map:
        raise ValueError(f"model_no for {model_type} must be one of "
                         f"{list(model_map)}, got {model_no}")


def build_model(model_no: int, config: Dict, common: Dict,
                model_type: str) -> nn.Module:
    """An SNV model or the U-Net from a MuRaL-style config dict;
    ``common`` carries ``emb_dims``, ``n_cont``, ``n_class`` and
    ``in_channels``."""
    check_model_no(model_no, model_type)
    if model_type == "indel":
        return UNetSmall(
            n_class=common["n_class"],
            out_channels=config["CNN_out_channels"],
            kernel_size=config["CNN_kernel_size"],
            downsize=config["down_list"],
            use_reverse=bool(config.get("use_reverse", False)),
            in_channels=common["in_channels"])
    local = dict(
        emb_vocab=4 ** config["local_order"] + 1,
        n_cat=len(common["emb_dims"]),
        lin_layer_sizes=[config["local_hidden1_size"],
                         config["local_hidden2_size"]],
        emb_dropout=config["emb_dropout"],
        lin_layer_dropouts=[config["local_dropout"]] * 2,
        n_class=common["n_class"], n_cont=common["n_cont"])
    towers = dict(
        in_channels=common["in_channels"],
        out_channels=config["CNN_out_channels"],
        kernel_size=config["CNN_kernel_size"],
        distal_fc_dropout=config["distal_fc_dropout"],
        n_class=common["n_class"])
    if model_no == 0:
        return SNVNet0(**local)
    if model_no == 1:
        return SNVNet1(**towers)
    return MODEL_REGISTRY["snv"][model_no](**local, **{
        k: v for k, v in towers.items() if k != "n_class"})


def in_channels_for(config: Dict, n_cont: int) -> int:
    """Distal input channels: ``4 ** distal_order``, plus ``n_cont``
    track channels when the run has track features and neither
    ``without_bw_distal`` nor ``seq_only``."""
    bw_distal = (n_cont > 0 and not config.get("without_bw_distal", False)
                 and not config.get("seq_only", False))
    return 4 ** config.get("distal_order", 1) + (n_cont if bw_distal else 0)


def build_model_from_config(config: Dict, n_cont: int,
                            model_type: str) -> nn.Module:
    """Architecture from the checkpoint's ``model.config.pkl`` and the
    number of track features."""
    common = {
        "emb_dims": config["emb_dims"],
        "n_cont": n_cont,
        "n_class": config["n_class"],
        "in_channels": in_channels_for(config, n_cont),
    }
    return build_model(config["model_no"], config, common, model_type)
