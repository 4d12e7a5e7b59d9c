"""Persistent XLA compile cache for the entry points.

``bench.py``, ``spmm`` (``cli.main``) and ``chip_smoke.py`` call
:func:`enable_compile_cache` before their first compilation, so repeated
runs on the same machine skip recompiling kernels and programs.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

#: Fixed default location: the checkout's ``.jax_cache`` (gitignored).
#: The path is part of the cache key, so it never depends on a temporary
#: name, a process id or the time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
