"""The QC kernel's wrapper: tiles, padding, the kernel choice for a backend,
vmap over SNR points and the shard_map wrapper on the virtual CPU mesh.
The kernel itself runs in the Pallas interpreter."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.ops.spa_pallas import (
    TilePlan,
    make_qc_decoder,
    next_pow2,
    pick_tile,
)
from ldpc_tpu.sim.runner import choose_kernel, load_code

WIMAX = "builtin:wimax_576_0.5.alist.txt"


@pytest.fixture(scope="module")
def wimax():
    return load_code(WIMAX)


@pytest.fixture(scope="module")
def llrs(wimax):
    rng = np.random.default_rng(4)
    spec = wimax.standard_encode_spec
    u = rng.integers(0, 2, (40, wimax.k), dtype=np.uint8)
    w = spec.encode_numpy(u, "orig").astype(np.float64)
    sigma = 0.85
    llr = 2.0 * ((2 * w - 1) + rng.normal(0, sigma, w.shape)) / sigma**2
    return jnp.asarray(llr.astype(np.float32))


@pytest.mark.parametrize("x,want", [(1, 1), (2, 2), (3, 4), (24, 32),
                                    (48, 64), (96, 128), (384, 512)])
def test_next_pow2(x, want):
    assert next_pow2(x) == want


@pytest.mark.parametrize("name,warps", [
    ("wimax_576_0.5.alist.txt", 8), ("wimax_1152_0.5.alist.txt", 8),
    ("wimax_2304_0.5.alist.txt", 8), ("wimax_2304_0.83.alist.txt", 16),
    ("wifi_648_r083.alist.txt", 16), ("wigig_R05_N672_K336.alist.txt", 8),
    ("CCSDS_ldpc_n128_k64.alist.txt", 8), ("Tanner_155_64.alist.txt", 8),
])
def test_pick_tile_fits_budget(name, warps):
    """Every standard family gets a tile of 8 codewords; rows of degree 14
    and more (WiMAX rate 5/6: 20, Wi-Fi rate 5/6: 22) get 16 warps."""
    qc = load_code("builtin:" + name).qc
    assert pick_tile(qc) == TilePlan(8, warps)


@pytest.mark.parametrize("backend", ["gpu", "cpu", "metal"])
@pytest.mark.parametrize("want", ["auto", "xla"])
@pytest.mark.parametrize("eligible", [True, False])
def test_choose_kernel_auto_and_xla(backend, want, eligible):
    got = choose_kernel(want, backend, eligible)
    assert got == (want == "auto" and backend == "gpu" and eligible)


@pytest.mark.parametrize("backend,interpret,ok", [
    ("gpu", False, True), ("gpu", True, True),
    ("cpu", True, True), ("cpu", False, False), ("metal", False, False),
])
def test_choose_kernel_forced(backend, interpret, ok):
    if ok:
        assert choose_kernel("pallas", backend, True, interpret=interpret)
    else:
        with pytest.raises(ValueError, match="GPU"):
            choose_kernel("pallas", backend, True, interpret=interpret)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_choose_kernel_forced_rejects(backend):
    with pytest.raises(ValueError, match="quasi-cyclic"):
        choose_kernel("pallas", backend, False, interpret=True)


def test_choose_kernel_unknown():
    with pytest.raises(ValueError, match="kernel must be"):
        choose_kernel("mosaic", "gpu", True)


@pytest.mark.parametrize("B", [1, 7, 17])
def test_batch_padding(wimax, llrs, B):
    """A batch that is not a multiple of the tile decodes exactly like the
    same codewords inside a full batch (padding lanes start done)."""
    info = wimax.standard_encode_spec.info_pos("orig")
    dec = jax.jit(make_qc_decoder(wimax.qc, info, 5, "minsum",
                                  schedule="layered", tile_b=8,
                                  interpret=True))
    full = dec(llrs[:24])
    part = dec(llrs[:B])
    assert part.est.shape == (B, wimax.n)
    for f in ("ok", "est", "conv_iter"):
        assert np.array_equal(np.asarray(getattr(part, f)),
                              np.asarray(getattr(full, f))[:B])


def test_results_independent_of_tile(wimax, llrs):
    """A codeword's decode does not depend on which tile it shares."""
    info = wimax.standard_encode_spec.info_pos("orig")
    r8, r16 = (
        jax.jit(make_qc_decoder(wimax.qc, info, 5, "normalized_minsum",
                                schedule="layered", tile_b=tb,
                                interpret=True))(llrs[:32])
        for tb in (8, 16)
    )
    for f in ("ok", "est", "conv_iter"):
        assert np.array_equal(np.asarray(getattr(r8, f)),
                              np.asarray(getattr(r16, f)))


def test_skip_runs_no_iteration(wimax, llrs):
    info = wimax.standard_encode_spec.info_pos("orig")
    dec = make_qc_decoder(wimax.qc, info, 5, "minsum", tile_b=8,
                          interpret=True)
    r = jax.jit(dec)(llrs[:8], jnp.int32(1))
    assert int(r.iters_run) == 0
    assert (np.asarray(r.conv_iter) == -1).all()


def test_vmap_over_points_matches_loop(wimax, llrs):
    """The parallel SNR sweep vmaps the decoder: the custom batching rule
    flattens the points into one batch, with per-point skips."""
    info = wimax.standard_encode_spec.info_pos("orig")
    dec = make_qc_decoder(wimax.qc, info, 5, "minsum", schedule="layered",
                          tile_b=8, interpret=True)
    stack = jnp.stack([llrs[:12], 0.5 * llrs[12:24]])
    skips = jnp.asarray([0, 1], jnp.int32)
    rv = jax.jit(jax.vmap(dec))(stack, skips)
    r0 = jax.jit(dec)(stack[0])
    assert np.array_equal(np.asarray(rv.est[0]), np.asarray(r0.est))
    assert np.array_equal(np.asarray(rv.conv_iter[0]),
                          np.asarray(r0.conv_iter))
    assert int(rv.iters_run[0]) == int(r0.iters_run)
    assert int(rv.iters_run[1]) == 0  # the skipped point never iterates


def test_shard_map_matches_unsharded(wimax, llrs):
    """Under a mesh each device decodes its batch shard (shard_map over the
    batch axis): results equal the unsharded call."""
    from ldpc_tpu.parallel.mesh import make_mesh

    mesh = make_mesh({"batch": 8})
    info = wimax.standard_encode_spec.info_pos("orig")
    kw = dict(schedule="layered", tile_b=8, interpret=True)
    plain = jax.jit(make_qc_decoder(wimax.qc, info, 5, "offset_minsum", **kw))
    sharded = jax.jit(make_qc_decoder(wimax.qc, info, 5, "offset_minsum",
                                      mesh=mesh, batch_axes=("batch",), **kw))
    x = llrs[:32]
    r1, r2 = plain(x), sharded(x)
    for f in ("ok", "est", "conv_iter"):
        assert np.array_equal(np.asarray(getattr(r1, f)),
                              np.asarray(getattr(r2, f)))
    assert int(r1.iters_run) == int(r2.iters_run)


def test_runner_mesh_kernel_counters_equal_one_device(wimax):
    """PointExecutor on the 8-device batch mesh with the kernel (interpreter)
    gives the one-device counters, and the parallel SNR sweep on a
    ('snr', 'batch') mesh gives the sequential sweep's."""
    from ldpc_tpu.parallel.mesh import make_mesh
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import run_simulation, run_simulation_parallel

    opts = SimOptions(
        matrix=WIMAX, blocks=32, batch=16, iterations=4, ber=True, fer=True,
        fidelity="exact", decoder="minsum", schedule="layered",
        kernel="pallas", initial_snr=1.5, end_snr=2.0, step_snr=0.5,
        seed=5, quiet=True,
    )
    one = run_simulation(opts, wimax, interpret=True)
    meshed = run_simulation(opts, wimax, mesh=make_mesh({"batch": 8}),
                            interpret=True)
    par = run_simulation_parallel(opts, wimax,
                                  mesh=make_mesh({"snr": 2, "batch": 4}),
                                  interpret=True)
    key = lambda p: (p.total_blocks, p.successful_blocks, p.ber,  # noqa: E731
                     p.avg_convergence_iterations)
    assert [key(p) for p in one.snr_points] == [key(p) for p in meshed.snr_points]
    assert [key(p) for p in one.snr_points] == [key(p) for p in par.snr_points]
