"""JAX runtime configuration helpers."""

from __future__ import annotations

import os

# Fixed, gitignored cache directory inside the checkout: the path is part of
# the cache key, so a directory that moves between runs never hits.
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to DEFAULT_CACHE_DIR, unless
    the process already configured a directory of its own.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    if not jax.config.jax_compilation_cache_dir:
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return jax.config.jax_compilation_cache_dir
