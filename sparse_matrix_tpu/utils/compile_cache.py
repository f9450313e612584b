"""Persistent XLA compile cache at a fixed path.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module leaves it alone. Otherwise the cache goes to ``<checkout>/.jax_cache``
(git-ignored): a fixed path, since the path is part of what a later run
must find again.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "default_cache_dir"]


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``, the checkout being the directory that
    holds the ``sparse_matrix_tpu`` package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    from .debugflags import compilation_cache_dir

    env = compilation_cache_dir()
    if env:
        return env
    import jax

    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
