"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench, smoke, tests): when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache lives in ``.jax_cache`` at the root of
this checkout, whatever the working directory.  The path is part of the
cache key, so a fixed path is what lets a later run hit.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    env = os.environ.get(ENV)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable(min_compile_time_secs: float = 1.0) -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path
