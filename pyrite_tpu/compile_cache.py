"""JAX's persistent compilation cache for accelerator runs.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
alone. Otherwise the cache lives at a fixed path, ``<checkout>/.jax_cache``
(listed in .gitignore): the path is part of the cache key, so a directory
that moves never hits. Nothing is set at import, and CPU runs (the tests)
keep no cache.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str | None:
    """Point JAX's persistent cache at CACHE_DIR for a run on an
    accelerator. Returns the directory in use, or None on the CPU."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
