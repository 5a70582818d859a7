"""Persistent XLA compilation cache.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this module
sets nothing. Otherwise the cache lives at a fixed path inside the checkout,
`<checkout>/.jax_cache` (listed in .gitignore): the directory is part of the
cache's identity, so a fixed path is what lets a later process reuse what an
earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_DONE = False


def enable_compilation_cache() -> None:
    """Idempotently point JAX at the default cache when the environment
    names none."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
