"""Attention analysis (twin of ``outgridvit_tpu/experiments``): capture,
MAD / entropy metrics and heatmaps."""

from outgridvit_tpu_torch.experiments.capture import (  # noqa: F401
    capture_attention,
)
from outgridvit_tpu_torch.experiments.mad_entropy import (  # noqa: F401
    compute_grid_and_outlooker_mad_by_stage,
    compute_grid_and_outlooker_mad_entropy_by_stage,
    print_mad_abs_by_stage_simple,
    run_mad_entropy_pipeline,
)
