"""Persistent XLA compilation cache for the entry points.

The staged 10^9-bit flagship compiles several large programs; the reference
pays its equivalent cost (gcc -O2 of one TU) once.  JAX's persistent compile
cache makes every bench/CLI invocation after the first reuse the compiled
executables.  The cache lives where JAX_COMPILATION_CACHE_DIR says when that
is set, and otherwise at the fixed <repo>/.cache/jax (a fixed path, because
a cache directory that moves never hits)."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache", "jax")


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    cache = os.environ.get(ENV_VAR) or _DEFAULT
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache
