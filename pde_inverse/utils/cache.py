"""Persistent XLA compilation cache.

Called by every entry point (main / bench / __graft_entry__ / chip_smoke).
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
sets no directory.  Otherwise the cache lives at one fixed path inside the
checkout (``.jax_cache/``, listed in .gitignore): the path is part of the
cache key, so a directory that moves between runs never hits.  Opt out
with PDE_INVERSE_NO_CACHE=1.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> None:
    if os.environ.get("PDE_INVERSE_NO_CACHE") == "1":
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
