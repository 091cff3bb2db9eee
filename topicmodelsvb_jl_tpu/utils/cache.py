"""Persistent compile cache for the program's entry points.

Compiling the training step for a new corpus shape takes seconds to
minutes on a GPU; JAX's persistent cache keeps the compiled programs on
disk so a second run of the same command starts at once.  The entry
points (``train.main``, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``) call :func:`enable_compile_cache` once; nothing
is set at package import.
"""

from __future__ import annotations

import os
from typing import Optional

ENV = "JAX_COMPILATION_CACHE_DIR"

# a fixed directory inside the checkout (listed in .gitignore): the path
# is part of what a cache hit needs, so it never depends on the working
# directory, a temp name, a process id or the time
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache(platform: Optional[str] = None) -> Optional[str]:
    """Turn on JAX's persistent compile cache; returns the directory used.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  Otherwise, on an accelerator, the cache
    goes to ``<checkout>/.jax_cache``.  On the CPU backend (``platform``
    defaults to JAX's) nothing is cached: CPU compiles are cheap, and
    JAX's CPU cache entries are tied to the host's instruction set.
    """
    import jax

    env = os.environ.get(ENV)
    if env:
        return env
    if (platform or jax.default_backend()) == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
