"""Persistent XLA compilation cache.

The N=243 train step takes minutes to compile, and a fresh process pays
that again unless the compiled program is cached on disk.  JAX's persistent
compilation cache serializes compiled executables keyed by the program and
its compile options, so a later process deserializes in seconds.

Every CLI entry point (train.py / bench.py / eval.py / demo.py / tools/*)
calls :func:`enable_compilation_cache` at startup.  Where the cache goes:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; no directory is
  set in code.
- otherwise: ``<checkout>/.jax_cache`` (a fixed path, so it hits again:
  the path is part of what the cache is found by).

``GFT_COMPILE_CACHE=0`` disables the cache entirely.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled_dir = None


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.  Returns the directory in
    use, or None when disabled via ``GFT_COMPILE_CACHE=0``.  Idempotent."""
    global _enabled_dir
    if os.environ.get("GFT_COMPILE_CACHE", "1") in ("0", "false", "off"):
        return None
    if _enabled_dir is not None:
        return _enabled_dir

    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything that took any real compile time; tiny programs aren't
    # worth the disk round trip
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _enabled_dir = cache_dir
    return cache_dir
