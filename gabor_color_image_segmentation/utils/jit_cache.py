"""Persistent XLA compilation cache for the framework's entry points.

JAX's persistent compilation cache serializes compiled executables to disk,
so a fresh process skips recompiling programs it has compiled before. The
CLI, ``bench.py``, ``chip_smoke.py`` and the eval entry point enable it; the
library itself never mutates global jax config on import.

Placement:
  * ``JAX_COMPILATION_CACHE_DIR`` set -> that directory and no other (JAX
    reads the variable itself; this module leaves the setting alone).
  * otherwise -> ``<checkout>/.jax_cache`` (listed in ``.gitignore``), one
    fixed path, because the path is part of what makes a cache hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache lives in (see the module docstring)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Point jax at the persistent executable cache; returns the dir used."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # only persist compilations that actually cost something
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
