"""Checkpoint triple ``model`` + ``model.config.pkl`` +
``model.fdiri_cal.pkl`` (counterpart of ``mural_tpu/train/checkpoint.py``).

``model`` is read in two formats: a torch zip state_dict (what the
reference MuRaL and this package write) or a ``mural_tpu`` Flax msgpack
file, whose ``{params, batch_stats}`` tree goes through the weight bridge
:func:`mural_tpu_torch.utils.convert.state_dict_from_jax`.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from mural_tpu_torch.utils.convert import state_dict_from_jax


def clean_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the reference's duplicate ``*.layer.N.*`` ResBlock keys, the
    BN ``num_batches_tracked`` counters and zero-size tensors: a
    reference SNV model without continuous features still carries a
    ``first_bn_layer`` of ``BatchNorm1d(0)``, which the port leaves
    out."""
    return {k: v for k, v in sd.items()
            if ".layer." not in k and not k.endswith("num_batches_tracked")
            and v.numel() > 0}


def save_checkpoint(save_path: str, model, config: Dict,
                    calibrator=None) -> None:
    """Write the triple; ``model`` is a module or its state_dict (the
    overlapped epoch tail passes a snapshot)."""
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    state = (model.state_dict() if isinstance(model, torch.nn.Module)
             else model)
    sd = {k: v.detach().cpu() for k, v in clean_state_dict(state).items()}
    torch.save(sd, save_path)
    with open(save_path + ".config.pkl", "wb") as fh:
        pickle.dump(config, fh)
    if calibrator is not None:
        with open(save_path + ".fdiri_cal.pkl", "wb") as fh:
            pickle.dump(calibrator, fh)


def _msgpack_ext_hook(code, data):
    """Flax's ndarray extension: ext code 1 holds (shape, dtype, bytes)."""
    import msgpack
    if code != 1:
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _is_msgpack_map(blob: bytes) -> bool:
    return bool(blob) and (0x80 <= blob[0] <= 0x8F or blob[0] in (0xDE, 0xDF))


def load_checkpoint(model_path: str, model: torch.nn.Module
                    ) -> torch.nn.Module:
    """Load the weights at ``model_path`` into ``model`` (in place)."""
    with open(model_path, "rb") as fh:
        blob = fh.read()
    if blob[:2] == b"PK":
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        sd = clean_state_dict(sd)
    elif _is_msgpack_map(blob):
        import msgpack
        variables = msgpack.unpackb(blob, ext_hook=_msgpack_ext_hook,
                                    raw=False)
        sd = state_dict_from_jax(variables, model)
    else:
        raise ValueError(f"{model_path}: neither a torch state_dict nor a "
                         "mural_tpu msgpack checkpoint")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{model_path}: missing keys {missing}, unexpected "
                       f"keys {unexpected}")
    return model


def load_config(config_path: str) -> Dict:
    """Load a checkpoint config pickle, normalising pre-1.2 key names
    (``central_radius`` -> ``segment_center``, ``batch_segment`` ->
    ``sampled_segments``); the oldest checkpoints carry neither and get
    the train CLI default segment_center."""
    with open(config_path, "rb") as fh:
        config = pickle.load(fh)
    if "segment_center" not in config and "central_radius" in config:
        config["segment_center"] = config["central_radius"]
    if "sampled_segments" not in config and "batch_segment" in config:
        config["sampled_segments"] = config["batch_segment"]
    config.setdefault("segment_center", 300000)
    return config


_DIRICHLET = "mural_tpu_torch.calibrate.dirichlet"
_EXTRA = "mural_tpu_torch.calibrate.extra"
_MULTINOMIAL = "mural_tpu_torch.calibrate.multinomial"
_CLASS_MAP = {
    ("dirichletcal.calib.fulldirichlet", "FullDirichletCalibrator"):
        (_DIRICHLET, "FullDirichletCalibrator"),
    ("dirichletcal.calib.tempscaling", "TemperatureScaling"):
        (_DIRICHLET, "TemperatureScaling"),
    ("dirichletcal.calib.vectorscaling", "VectorScaling"):
        (_DIRICHLET, "VectorScaling"),
    ("dirichletcal.calib.multinomial", "MultinomialRegression"):
        (_MULTINOMIAL, "MultinomialRegression"),
    ("mural_tpu.calibrate.dirichlet", "FullDirichletCalibrator"):
        (_DIRICHLET, "FullDirichletCalibrator"),
    ("mural_tpu.calibrate.dirichlet", "TemperatureScaling"):
        (_DIRICHLET, "TemperatureScaling"),
    ("mural_tpu.calibrate.dirichlet", "VectorScaling"):
        (_DIRICHLET, "VectorScaling"),
    ("mural_tpu.calibrate.multinomial", "MultinomialRegression"):
        (_MULTINOMIAL, "MultinomialRegression"),
    **{("mural_tpu.calibrate.extra", name): (_EXTRA, name)
       for name in ("DiagDirichlet", "FixedDiagDirichlet", "MatrixScaling",
                    "DirichletCalibrator")},
}


class _CalibratorUnpickler(pickle.Unpickler):
    """Maps calibrator classes pickled by the reference's ``dirichletcal``
    or by ``mural_tpu`` onto this package's classes, without importing
    either."""

    def find_class(self, module, name):
        if (module, name) in _CLASS_MAP:
            module, name = _CLASS_MAP[(module, name)]
        elif module.split(".")[0] in ("mural_tpu", "jax", "jaxlib"):
            if name == "_reconstruct_array" and module.startswith("jax"):
                return _rebuild_old_jax_array
            raise pickle.UnpicklingError(
                f"calibrator pickle holds {module}.{name}, which has no "
                "counterpart in mural_tpu_torch")
        return super().find_class(module, name)


def _rebuild_old_jax_array(fun, args, arr_state, aval_state):
    """Old-jax pickled DeviceArrays: rebuild as plain numpy."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return np.asarray(value)


def load_calibrator(path: str):
    with open(path, "rb") as fh:
        return _CalibratorUnpickler(fh).load()
