"""JAX persistent compilation cache location.

The cache key includes the cache path, so the directory must not move
between runs: it is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX
reads the variable itself), else ``build/jax_cache`` in this checkout.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, "build", "jax_cache")


def configure_compile_cache() -> str:
    """Enable the persistent cache; return the directory it uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return env or DEFAULT_DIR
