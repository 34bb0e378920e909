"""Where JAX keeps its persistent compile cache for this program.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set.  Otherwise the cache
lives in ``.jax_cache`` at the root of the checkout (listed in
``.gitignore``): a fixed path, because the path is part of what makes a
later run find the cache again.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The cache directory this process uses."""
    return os.environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``; returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
