"""Persistent XLA compilation cache for the entry points.

The first compile of the full chain takes tens of seconds; the persistent
cache lets a later process load the compiled program instead. Library
imports never touch jax.config — only the entry points (CLI tools,
bench.py, chip_smoke.py) opt in, before their first compile."""

from __future__ import annotations

import os

# Fixed path inside the checkout (listed in .gitignore), so every run of
# this checkout finds what earlier runs cached.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Enable the persistent compilation cache and return its directory.

    If $JAX_COMPILATION_CACHE_DIR is set, jax already uses it and nothing
    is set here. Otherwise the cache goes to DEFAULT_CACHE_DIR. Call
    before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_CACHE_DIR
