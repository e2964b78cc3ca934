"""Persistent XLA compilation cache.

First compile of a (code, batch, iterations) shape costs tens of seconds of
host-side work (the decoders unroll per-base-row update chains, so the
programs are large). The reference pays an analogous one-time cost
rebuilding decoder adjacency per process (python_ldpc_app/main.py:563-567);
here the fix is JAX's persistent compilation cache: executables are keyed
by (program, compile flags, device), so every CLI invocation, bench run and
script after the first reuses the binary instead of recompiling.

Call :func:`enable_compile_cache` before building executors. It is on by
default in the CLI, bench.py, chip_smoke.py and the scripts. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the program
sets no directory; otherwise the cache lives at ``<checkout>/.xla_cache``, a
fixed path that the next process finds again. Source locations in the
compiled programs keep only their innermost frame, so a kernel traced from
another call site still hits. ``LDPC_TPU_NO_COMPILE_CACHE=1``
disables the program's own setting (e.g. when measuring cold-compile time).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".xla_cache")
ENV_DIR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir_for(environ=os.environ) -> str | None:
    """The directory this program sets, or None when it sets none (the
    environment names one, which JAX honours itself, or caching is off)."""
    if environ.get("LDPC_TPU_NO_COMPILE_CACHE") or environ.get(ENV_DIR):
        return None
    return DEFAULT_DIR


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache for this process.

    Returns the directory in use (``$JAX_COMPILATION_CACHE_DIR`` or
    :data:`DEFAULT_DIR`), or None when disabled. Safe to call more than
    once."""
    if os.environ.get("LDPC_TPU_NO_COMPILE_CACHE"):
        return None
    import jax

    cache_dir = cache_dir_for()
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything: on a small host even "cheap" compiles cost seconds
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # the QC kernel's Triton IR rides inside the program with its source
    # locations; full tracebacks there would tie the cache key to the call
    # stack that first traced it, so the next caller would miss
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    return cache_dir or os.environ[ENV_DIR]
