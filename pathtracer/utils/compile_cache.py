"""JAX's persistent compilation cache, set in one place.

With JAX_COMPILATION_CACHE_DIR set, JAX reads the variable itself and
nothing here touches the cache. Otherwise the cache is <repo>/.jax_cache,
a fixed path (the path is part of the cache key), which .gitignore lists.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
