"""Test harness configuration.

Tests run on CPU with 8 virtual devices (sharding tests) and x64 enabled
(float64 numerical-parity tests vs the numpy reference decoder). Run them
with ``JAX_PLATFORMS=cpu``; if JAX was already initialized on another
backend before this file loads, the backends are cleared and JAX is
re-pointed at a virtual 8-device CPU platform in-process.

Tests that need the card carry the ``gpu`` marker and decide inside the
``gpu_device`` fixture, never at import, whether one is present.
"""

from __future__ import annotations

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
if jax.default_backend() != "cpu" or jax.device_count() < 8:
    import jax.extend.backend

    jax.extend.backend.clear_backends()
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu" and jax.device_count() >= 8, (
        "could not obtain an 8-virtual-device CPU backend for tests"
    )

import numpy as np
import pytest

REFERENCE_DB = "/root/reference/Channel_Codes_Database"


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, so every
    xdist worker collects the same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return gpus[0]


@pytest.fixture(scope="session")
def matrix_db() -> str:
    if not os.path.isdir(REFERENCE_DB):
        pytest.skip("ALIST matrix database not available")
    return REFERENCE_DB


@pytest.fixture(scope="session")
def bch_matrix_path(matrix_db) -> str:
    path = os.path.join(matrix_db, "BCH_7_4_1_strip.alist.txt")
    if not os.path.isfile(path):
        pytest.skip("BCH(7,4) matrix not available")
    return path


@pytest.fixture(scope="session")
def wimax_matrix_path(matrix_db) -> str:
    path = os.path.join(matrix_db, "Wimax LDPC Codes", "wimax_576_0.5.alist.txt")
    if not os.path.isfile(path):
        pytest.skip("wimax_576_0.5 matrix not available")
    return path


@pytest.fixture(scope="session")
def small_code():
    """A generated (3,6)-regular (48, 24) code -- database-independent."""
    from ldpc_tpu.models.code import LDPCCode
    from ldpc_tpu.models.generate import gallager_regular

    return LDPCCode(alist=gallager_regular(48, 3, 6, seed=11), name="reg_48_24")


@pytest.fixture
def sample_simulation_result():
    """Synthetic SimulationResult with 3 SNR points (mirrors the reference's
    conftest fixture, tests/conftest.py:28-71)."""
    from ldpc_tpu.sim.results import SimulationConfig, SimulationResult, SNRPointResult

    config = SimulationConfig(
        matrix_path="test/matrix.alist.txt",
        n=576,
        m=288,
        k=288,
        rate=0.5,
        blocks=100,
        max_iterations=5,
        encoding_method="standard",
        interleaver_type="none",
        decoder_type="sumproduct",
        channel_mode=1,
        modulation=1,
        speed=1.0,
        snr_range=(0.0, 2.0, 1.0),
        threads=1,
        timestamp="2026-01-01T00:00:00",
    )
    points = [
        SNRPointResult(
            snr_db=float(s),
            ber=10.0 ** (-(s + 1)),
            fer=min(1.0, 10.0 ** (-s)),
            avg_normalized_llr=0.1 / (s + 1),
            total_blocks=100,
            successful_blocks=100 - 10 * (2 - int(s)),
            failed_blocks=10 * (2 - int(s)),
            avg_convergence_iterations=3.0 - s,
            matrix_path="test/matrix.alist.txt",
        )
        for s in np.arange(0.0, 3.0, 1.0)
    ]
    return SimulationResult(config=config, snr_points=points, wall_clock_seconds=12.5)
