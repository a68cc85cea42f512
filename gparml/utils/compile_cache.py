"""Where the persistent XLA compile cache lives — one rule for every entry
point (CLI, tests, examples, benchmark, smoke run).

``$JAX_COMPILATION_CACHE_DIR`` wins when it is set: JAX reads it itself and
no code here sets another directory. Otherwise the cache is ``.jax_cache``
at the root of the checkout, a fixed path (the path is part of the cache
key, so a directory that moves never hits).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable() -> str:
    """Turn the persistent compile cache on (every program, however quick
    to compile, is cached) and return its directory."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir()
