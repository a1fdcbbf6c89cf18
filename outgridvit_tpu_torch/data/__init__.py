"""Input pipeline (twin of ``outgridvit_tpu/data``): the dataset readers,
host transforms, ``ArrayDataLoader``, the CUDA ``Prefetcher`` and
``build_dataloaders``."""

from outgridvit_tpu_torch.data.pipeline import (  # noqa: F401
    ArrayDataLoader,
    Prefetcher,
    peek_loader,
)
from outgridvit_tpu_torch.data.registry import build_dataloaders  # noqa: F401
