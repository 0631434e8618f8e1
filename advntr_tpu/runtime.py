"""Runtime initialization: JAX's persistent compilation cache.

Every entry point enables the cache, so an executable compiled once (one
per shape bucket) is loaded from disk by later runs instead of being
compiled again.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
uses that directory and nothing is overridden; otherwise the cache lives
at a fixed path inside the checkout, because the path is part of the
cache's key and a directory that moves never hits.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")

_initialized = False


def compilation_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    global _initialized
    if _initialized:
        return
    import jax
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _initialized = True
