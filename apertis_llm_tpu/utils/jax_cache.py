"""Persistent XLA compilation cache.

Serving and training programs at full width take tens of seconds to compile;
JAX's persistent cache lets a later process load them instead. The cache
lives where ``JAX_COMPILATION_CACHE_DIR`` says when that is set (JAX reads
the variable itself, and this module sets no other directory). Otherwise it
is ``.jax_cache`` at the root of the checkout, a fixed path because the
path is part of the cache key; ``.gitignore`` lists it.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The compilation-cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def maybe_enable_cache() -> str:
    """Enable the persistent compilation cache; must run before the first
    jit compilation. Returns the directory in use."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
