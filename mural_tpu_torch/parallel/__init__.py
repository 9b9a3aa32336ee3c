"""Data-parallel training and sharded inference over CUDA devices
(counterpart of ``mural_tpu/parallel/``)."""
