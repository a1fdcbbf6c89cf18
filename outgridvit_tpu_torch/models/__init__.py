"""Models: Model A (MaxOutNet) and Model B (OutlookerFrontGridNet), their
blocks and layers, and the baseline zoo (``models/baselines.py``)."""

from outgridvit_tpu_torch.models.build import build_model  # noqa: F401
from outgridvit_tpu_torch.models.model_a import MaxOutNet  # noqa: F401
from outgridvit_tpu_torch.models.model_b import (  # noqa: F401
    OutlookerFrontGridNet,
)
