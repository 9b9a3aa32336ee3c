"""MuRaL on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of :mod:`mural_tpu`, module for module.  Entry
points run on a CUDA device unless the caller asks for the CPU; the
distal-tower stem of ``predict --fused_inference`` runs as a hand-written
CUDA kernel (:mod:`mural_tpu_torch.ops.fused_code_conv`).
"""

from mural_tpu_torch._version import __version__

__all__ = ["__version__"]
