"""Compile cache placement (ldpc_tpu.utils.cache)."""

from __future__ import annotations

import os

import jax

from ldpc_tpu.utils import cache


def test_env_dir_left_to_jax():
    assert cache.cache_dir_for({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_default_is_checkout_xla_cache():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir_for({}) == os.path.join(root, ".xla_cache")


def test_disabled():
    assert cache.cache_dir_for({"LDPC_TPU_NO_COMPILE_CACHE": "1"}) is None


def test_enable_with_env_sets_no_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory
    of its own: jax's option keeps what JAX read from the environment."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_without_env_uses_default(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    try:
        assert cache.enable_compile_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
        assert os.path.isdir(cache.DEFAULT_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_disabled(monkeypatch):
    monkeypatch.setenv("LDPC_TPU_NO_COMPILE_CACHE", "1")
    assert cache.enable_compile_cache() is None


def test_kernel_program_independent_of_call_site():
    """With the cache on, the lowered program (the kernel's Triton IR
    included) does not depend on the call stack that traced it, so a
    second caller hits the persistent cache."""
    import jax.numpy as jnp

    from ldpc_tpu.ops.spa_pallas import make_qc_decoder
    from ldpc_tpu.sim.runner import load_code

    before = jax.config.jax_include_full_tracebacks_in_locations
    try:
        cache.enable_compile_cache()
        code = load_code("builtin:CCSDS_ldpc_n128_k64.alist.txt")
        info = code.standard_encode_spec.info_pos("orig")
        x = jax.ShapeDtypeStruct((16, code.n), jnp.float32)

        def lowered():
            dec = make_qc_decoder(code.qc, info, 2, "minsum")
            return jax.jit(dec).trace(x).lower(
                lowering_platforms=("cuda",)).as_text()

        def site_a():
            return lowered()

        def site_b():
            return lowered()

        assert site_a() == site_b()
    finally:
        jax.config.update("jax_include_full_tracebacks_in_locations", before)
