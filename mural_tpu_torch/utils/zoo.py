"""Published-model zoo: load and convert checkpoints (counterpart of
``mural_tpu/utils/zoo.py``).

The reference ships trained checkpoints for four species
(``models/<species>/{SNV,INDEL}/<submodel>/``), each a torch state_dict
with a pickled config and FullDirichlet calibrator
(MuRaL/training.py:570-578).  :func:`load_zoo_checkpoint` builds the
model from the checkpoint's own ``model.config.pkl`` and fills it through
:func:`mural_tpu_torch.train.checkpoint.load_checkpoint` (a reference or
port torch state_dict, or a ``mural_tpu`` msgpack file);
:func:`convert_checkpoint` writes it back as this package's triple: the
cleaned state_dict, the config and the calibrator re-pickled onto
``mural_tpu_torch`` classes, so that no ``dirichletcal`` or
``mural_tpu`` name is left in it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mural_tpu_torch.models.registry import (build_model_from_config,
                                             in_channels_for)
from mural_tpu_torch.train.checkpoint import (load_calibrator,
                                              load_checkpoint, load_config,
                                              save_checkpoint)


def infer_model_type(config: Dict) -> str:
    """SNV checkpoints carry no ``down_list``; INDEL ones always do
    (MuRaL/commands/train.py:404)."""
    return "indel" if config.get("down_list") else "snv"


def input_geometry(config: Dict, model_type: str) -> Tuple[int, int]:
    """(k-mer columns, distal window length) of a checkpoint config: SNV
    windows are ``2r+1`` bases on a base, INDEL ones ``2r`` on a gap
    (MuRaL/data/preprocessing.py:524-567); the local branch sees
    ``2*local_radius + 2 - local_order`` k-mer columns."""
    r = int(config["local_radius"])
    k = int(config.get("local_order", 3))
    w = 2 * int(config["distal_radius"]) + (1 if model_type == "snv"
                                            else 0)
    return 2 * r + 2 - k, w


def load_zoo_checkpoint(ckpt_dir: str, model_type: Optional[str] = None):
    """``(model, config, model_type)`` of a checkpoint directory: the
    model built from its config (with the config's ``n_cont``) holding
    its weights, on the CPU in eval mode."""
    config = load_config(os.path.join(ckpt_dir, "model.config.pkl"))
    if model_type is None:
        model_type = infer_model_type(config)
    model = build_model_from_config(config, config.get("n_cont") or 0,
                                    model_type)
    load_checkpoint(os.path.join(ckpt_dir, "model"), model)
    return model.eval(), config, model_type


def convert_checkpoint(ckpt_dir: str, out_dir: str,
                       model_type: Optional[str] = None,
                       device: Optional[object] = None,
                       printer=print) -> Dict:
    """Convert a checkpoint directory into this package's triple under
    ``out_dir``, after a forward on a seeded batch of 4 on ``device``
    (finite, shape ``(4, n_class)``) and, when a calibrator is there, a
    check that it maps seeded probabilities to rows summing to 1 within
    1e-6.  Returns the config."""
    model, config, model_type = load_zoo_checkpoint(ckpt_dir, model_type)
    device = torch.device(device if device is not None else "cuda")
    n_cat, w = input_geometry(config, model_type)
    n_cont = config.get("n_cont") or 0

    rng = np.random.default_rng(0)
    cat = (torch.from_numpy(rng.integers(
        0, 4 ** int(config.get("local_order", 3)) + 1, (4, n_cat)))
        if model_type == "snv" else None)
    distal = torch.from_numpy(
        rng.normal(size=(4, w, in_channels_for(config, n_cont))).astype(
            np.float32))
    cont = (torch.from_numpy(rng.normal(size=(4, n_cont)).astype(
        np.float32)) if n_cont else None)
    with torch.no_grad():
        out = model.to(device)(
            *(None if t is None else t.to(device)
              for t in (cat, distal, cont))).cpu().numpy()
    model.cpu()
    if not np.all(np.isfinite(out)):
        raise ValueError(f"{ckpt_dir}: imported checkpoint produced "
                         "non-finite outputs")
    if out.shape != (4, int(config["n_class"])):
        raise ValueError(f"{ckpt_dir}: unexpected output shape "
                         f"{out.shape}")

    calibrator = None
    cal_path = os.path.join(ckpt_dir, "model.fdiri_cal.pkl")
    if os.path.exists(cal_path):
        calibrator = load_calibrator(cal_path)
        probs = np.asarray(calibrator.predict_proba(
            rng.dirichlet([1.0] * int(config["n_class"]), size=8)))
        if not (np.all(np.isfinite(probs))
                and np.allclose(probs.sum(axis=1), 1.0, atol=1e-6)):
            raise ValueError(f"{ckpt_dir}: calibrator sanity check "
                             "failed")

    os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(os.path.join(out_dir, "model"), model, dict(config),
                    calibrator=calibrator)
    printer(f"converted {ckpt_dir} -> {out_dir} "
            f"({model_type}, model_no {config.get('model_no')}, "
            f"distal_radius {config.get('distal_radius')}, "
            f"n_class {config.get('n_class')}"
            f"{', calibrator' if calibrator is not None else ''})")
    return config


def iter_reference_zoo(root: str):
    """Every checkpoint directory under a reference ``models/`` tree, as
    ``(species, family, submodel, path)``."""
    if not os.path.isdir(root):
        return
    for species in sorted(os.listdir(root)):
        sp_dir = os.path.join(root, species)
        if not os.path.isdir(sp_dir):
            continue
        for family in sorted(os.listdir(sp_dir)):
            fam_dir = os.path.join(sp_dir, family)
            if not os.path.isdir(fam_dir):
                continue
            for sub in sorted(os.listdir(fam_dir)):
                ck = os.path.join(fam_dir, sub)
                if os.path.exists(os.path.join(ck, "model")):
                    yield species, family, sub, ck
