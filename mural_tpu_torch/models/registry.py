"""Model construction from a checkpoint config (counterpart of
``mural_tpu/models/registry.py`` and
``mural_tpu/predict/pipeline.py:58-77 build_model_from_config``).

Only SNV ``model_no`` 2 (SNVNet2) is ported; every other architecture
raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict

from mural_tpu_torch.models.snv import SNVNet2

_NOT_PORTED = {
    ("snv", 0): "SNVNet0 is not ported yet (ROADMAP.md item 6)",
    ("snv", 1): "SNVNet1 is not ported yet (ROADMAP.md item 6)",
    ("snv", 3): "SNVNet3 is not ported yet (ROADMAP.md item 6)",
    ("indel", 0): "the INDEL U-Net is not ported yet (ROADMAP.md item 5)",
}


def build_model(model_no: int, config: Dict, common: Dict,
                model_type: str) -> SNVNet2:
    """SNVNet2 from a MuRaL-style config dict; ``common`` carries
    ``emb_dims``, ``n_class`` and ``in_channels``."""
    if (model_type, model_no) != ("snv", 2):
        raise NotImplementedError(_NOT_PORTED.get(
            (model_type, model_no),
            f"{model_type} model_no {model_no} is not ported yet "
            "(ROADMAP.md item 6)"))
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
                            model_type: str) -> SNVNet2:
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
