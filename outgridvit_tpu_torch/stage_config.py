"""Typed configuration dataclasses, shared with the JAX package.

``outgridvit_tpu.stage_config`` is pure dataclasses and
``outgridvit_tpu/__init__.py`` imports only that module, so re-exporting it
pulls in no JAX (a test checks ``sys.modules``) and keeps one schema for both
packages.
"""

from outgridvit_tpu.stage_config import (  # noqa: F401
    DownsampleConfig,
    MBConvConfig,
    StageCfg,
    build_stages,
    make_dpr,
)
