"""Placement of JAX's persistent compilation cache.

Every entry point (the CLI, bench.py, benchmarks/, chip_smoke.py) calls
`configure_compile_cache()` once before its first compile, so repeat runs
skip the minutes of XLA compilation that the streaming programs take.

* When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and that
  directory is the cache; no other path is set here.
* Otherwise the cache is `.jax_cache/` at the checkout root (listed in
  `.gitignore`).  The path is fixed because it is part of the cache key:
  a directory that moves between runs never hits.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `JAX_COMPILATION_CACHE_DIR`
    or, when that is unset, DEFAULT_DIR, and cache every program that
    takes at least a second to compile.  Returns the directory."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
