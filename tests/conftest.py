"""Test configuration: force an 8-virtual-device CPU platform so sharding
tests run anywhere (the driver dry-runs multi-chip the same way).

Note: the env var JAX_PLATFORMS is not honored when a TPU plugin registers
itself with higher priority, so we also set the config flag explicitly after
importing jax (before any backend is initialized).
"""

import os
import sys
from pathlib import Path

# Must be set before jax initializes its backends.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Parity tests compare against fp32 PyTorch; keep matmuls at full precision
# in the suite (models pick their own compute dtype in production).
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: re-running the suite reuses compiled XLA
# programs from previous runs (first run pays full compile cost).
_CACHE_DIR = os.environ.get("OUTGRIDVIT_JAX_CACHE", "/tmp/outgridvit_jax_cache")
try:
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
except Exception:  # older jax without these knobs
    pass

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (heavy parity / multi-mesh); "
        "opt in with --runslow or RUN_SLOW=1")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (CUDA kernels of "
        "outgridvit_tpu_torch); skips without a card")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow (or RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
