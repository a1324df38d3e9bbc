"""Where JAX keeps its persistent compilation cache.

Entry points (`chip_smoke.py`, `bench.py`, `neo-mpc-server`) call
`enable_compile_cache()` once, before their first compile. The rule:

- if `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
  is set here;
- otherwise the cache goes to `<checkout>/.jax_cache`, one fixed path. The
  path is part of the cache key, so a temporary, per-process or dated
  directory would never be hit again.

Importing the package sets nothing.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["CACHE_ENV", "default_cache_dir", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`.jax_cache` at the root of the checkout that holds this package."""
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
