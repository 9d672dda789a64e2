"""Persistent XLA compile cache shared by the entry points (bench.py,
chip_smoke.py, `python -m mpc_quad_ros_tpu.run`)."""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and this sets
    no other directory; otherwise the cache lives at the fixed path
    `<repo>/.jax_cache` (a fixed path, because the path is part of the
    cache key)."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
