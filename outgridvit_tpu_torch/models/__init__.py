"""Models (eval forward): Model A (MaxOutNet) and its blocks and layers."""

from outgridvit_tpu_torch.models.build import build_model  # noqa: F401
from outgridvit_tpu_torch.models.model_a import MaxOutNet  # noqa: F401
