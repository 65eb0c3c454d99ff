"""JAX's persistent compilation cache for this checkout.

Scripts that compile large programs (``chip_smoke.py``, ``bench.py``)
call :func:`enable_compile_cache` before their first compile.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache goes to ``.jax_cache`` at the root of the
checkout: a fixed path (the cache key includes it), listed in
``.gitignore``.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "default_cache_dir"]

_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir():
    """``<checkout>/.jax_cache`` — the fixed in-repo cache path."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache():
    """Turn on the persistent compilation cache; return its directory.

    Honours ``JAX_COMPILATION_CACHE_DIR`` (sets nothing when it is set);
    otherwise points the cache at :func:`default_cache_dir`."""
    env = os.environ.get(_ENV)
    if env:
        return env
    import jax

    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
