"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``
and the test suite): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here overrides it. Otherwise the cache goes to one fixed
path, because the directory is part of the cache key and a moving one never
hits: ``.jax_cache`` at the root of a checkout (listed in ``.gitignore``),
or the user cache directory for an installed package, whose tree may be
read-only.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# Compiles shorter than this are not written to the cache.
MIN_COMPILE_SECS = 0.5


def default_cache_dir() -> str:
    """The fixed cache path used when ``JAX_COMPILATION_CACHE_DIR`` is unset."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, ".jax_cache")
    return os.path.join(os.environ.get("XDG_CACHE_HOME",
                                       os.path.expanduser("~/.cache")),
                        "vision_basedsensor_tpu", "jax")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    cache = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache)
    return cache
