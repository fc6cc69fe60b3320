"""Persistent XLA compilation cache.

The fused solver programs take tens of seconds to compile; JAX's persistent
cache lets a later process load them instead. This is the analogue of the
reference's PackageCompiler sysimage + precompile workload
(compileRoME/compileRoMESysimage.jl, warmUpSolverJIT) — pay the compile once
per program shape.

The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it
itself, and nothing here overrides it). Otherwise it is ``.jax_cache`` at the
root of the checkout, a fixed path, since the path is part of what a cached
entry is found by.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache (idempotent, safe to call
    before or after device init). Returns the directory in use."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = REPO_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    return cache_dir
