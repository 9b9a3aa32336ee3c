"""MuRaL on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of :mod:`mural_tpu`, module for module.  Entry
points run on a CUDA device unless the caller asks for the CPU.  The
distal-tower stems run as hand-written CUDA kernels: in ``predict
--fused_inference`` and ``predict_genome --fused_inference``
(:mod:`mural_tpu_torch.ops.fused_code_conv`) and in ``train --fused_stem
on`` (:mod:`mural_tpu_torch.ops.fused_train_stem`).
"""

from mural_tpu_torch._version import __version__

__all__ = ["__version__"]
