"""Test configuration: force CPU with 8 virtual devices so data/tensor/expert
parallel mesh code is exercised without accelerators (SURVEY.md §4)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Pin the CPU in the config as well before any backend is initialised, so
# the tests run on 8 virtual CPU devices even where a GPU is present.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))
