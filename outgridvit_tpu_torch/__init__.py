"""OutGridViT on PyTorch + CUDA (NVIDIA Hopper).

A port of :mod:`outgridvit_tpu` (JAX/Flax/Pallas), module for module, held
against it with the same weights and inputs: serving (``serving.py``) and
the train step (``training/steps.py``). Activations are NHWC at every public
function, as in the JAX package. Every Pallas kernel on a ported path,
forward and backward, becomes a hand-written CUDA kernel under ``csrc/``
with a plain PyTorch version beside it (``ops/grid_attention.py``,
``ops/mlp_branch.py``).

This package imports ``torch`` and never ``jax`` or ``flax``; ``yaml`` is
not needed either (model configs are plain dicts).
"""

__version__ = "0.1.0"

from outgridvit_tpu_torch.stage_config import (  # noqa: F401
    DownsampleConfig,
    MBConvConfig,
    StageCfg,
)
