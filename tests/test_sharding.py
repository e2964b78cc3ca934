"""Multi-device sharding tests on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.ops.channel import ChannelParams
from ldpc_tpu.parallel.mesh import make_mesh, sharded_sweep_step
from ldpc_tpu.sim.config import SimOptions
from ldpc_tpu.sim.runner import PointExecutor


@pytest.fixture(scope="module", autouse=True)
def require_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def test_make_mesh_shapes():
    mesh = make_mesh({"batch": 8})
    assert mesh.shape == {"batch": 8}
    mesh2 = make_mesh({"snr": 2, "batch": -1})
    assert mesh2.shape == {"snr": 2, "batch": 4}
    with pytest.raises(ValueError):
        make_mesh({"batch": 3})


def test_sharded_step_matches_unsharded(small_code):
    """Counters from the mesh-sharded step must equal the single-device step
    (threefry is partitionable => identical randomness)."""
    opts = SimOptions(
        matrix=small_code.name, blocks=64, iterations=6, ber=True, fer=True,
        fidelity="exact", batch=64,
    )
    consts = ChannelParams(snr_db=2.0, noise_model="exact").consts()
    key = jax.random.key(0)

    plain = PointExecutor(small_code, opts)
    s_plain, _ = plain._step(key, consts)
    c_plain = plain._reduce(s_plain, jnp.int32(64))

    mesh = make_mesh({"batch": 8})
    sharded = PointExecutor(small_code, opts, mesh=mesh)
    s_shard, _ = sharded._step(key, consts)
    c_shard = sharded._reduce(s_shard, jnp.int32(64))

    for a, b in zip(jax.tree.leaves(c_plain), jax.tree.leaves(c_shard)):
        a, b = np.asarray(a), np.asarray(b)
        if np.issubdtype(a.dtype, np.integer):
            assert a == b  # counters identical: same randomness, exact ints
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6)  # psum reduce order


def test_sharded_outputs_are_sharded(small_code):
    mesh = make_mesh({"batch": 8})
    opts = SimOptions(
        matrix=small_code.name, blocks=64, iterations=4, fidelity="exact", batch=64
    )
    ex = PointExecutor(small_code, opts, mesh=mesh)
    stats, _ = ex._step(jax.random.key(1), ChannelParams(snr_db=1.0).consts())
    sh = stats.ok.sharding
    assert set(getattr(sh, "mesh", None).axis_names) == {"batch"}
    # stats really live across devices
    assert len(stats.ok.devices()) == 8


def test_2d_snr_batch_sweep(small_code):
    mesh = make_mesh({"snr": 2, "batch": 4})
    opts = SimOptions(
        matrix=small_code.name, blocks=32, iterations=4, fidelity="exact", batch=32
    )
    ex = PointExecutor(small_code, opts)
    sweep = sharded_sweep_step(lambda k, c, s: ex._step(k, c, s), mesh, "snr")
    consts = [
        ChannelParams(snr_db=s, noise_model="exact").consts() for s in (0.0, 4.0)
    ]
    consts_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *consts)
    keys = jax.random.split(jax.random.key(2), 2)
    stats, iters = sweep(keys, consts_stack, jnp.zeros((2,), jnp.int32))
    assert stats.ok.shape == (2, 32)
    ok = np.asarray(stats.ok)
    # higher SNR decodes at least as well
    assert ok[1].sum() >= ok[0].sum()
    assert len(stats.ok.devices()) == 8


def test_executor_pads_batch_to_mesh(small_code):
    mesh = make_mesh({"batch": 8})
    opts = SimOptions(matrix=small_code.name, blocks=10, batch=10, fidelity="exact")
    ex = PointExecutor(small_code, opts, mesh=mesh)
    assert ex.batch % 8 == 0


def test_run_point_on_mesh(small_code):
    mesh = make_mesh({"batch": 8})
    opts = SimOptions(
        matrix=small_code.name, blocks=100, iterations=5, ber=True, fer=True,
        fidelity="exact", batch=48,
    )
    ex = PointExecutor(small_code, opts, mesh=mesh)
    stats = ex.run_point(3.0, 100, jax.random.key(3), 0)
    assert stats.blocks == 100
    assert 0 <= stats.ok_blocks <= 100


def test_parallel_sweep_matches_sequential_exactly():
    """run_simulation_parallel on a ('snr','batch') mesh must reproduce the
    sequential runner point-for-point (identical PRNG key folding)."""
    from ldpc_tpu.parallel.mesh import make_mesh
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import run_simulation, run_simulation_parallel

    opts = SimOptions(
        matrix="builtin:CCSDS_ldpc_n32_k16.alist.txt",
        blocks=128,
        iterations=5,
        ber=True,
        fer=True,
        normalized_llr=True,
        initial_snr=0.0,
        end_snr=2.0,
        step_snr=1.0,  # 3 points; snr axis 2 -> padding path exercised
        fidelity="exact",
        batch=32,
        seed=11,
        quiet=True,
    )
    seq = run_simulation(opts)
    mesh = make_mesh({"snr": 2, "batch": 4})
    par = run_simulation_parallel(opts, mesh=mesh)

    assert len(seq.snr_points) == len(par.snr_points) == 3
    for a, b in zip(seq.snr_points, par.snr_points):
        assert a.snr_db == b.snr_db
        assert a.ber == b.ber
        assert a.fer == b.fer
        assert a.total_blocks == b.total_blocks
        assert a.successful_blocks == b.successful_blocks
        assert abs(a.avg_normalized_llr - b.avg_normalized_llr) < 1e-6


def test_parallel_sweep_batch_only_mesh():
    """Without an 'snr' axis the parallel runner vmaps points on one shard."""
    from ldpc_tpu.parallel.mesh import make_mesh
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import run_simulation_parallel

    opts = SimOptions(
        matrix="builtin:BCH_7_4_1_strip.alist.txt",
        blocks=64,
        iterations=4,
        ber=True,
        fer=True,
        initial_snr=1.0,
        end_snr=3.0,
        step_snr=1.0,
        fidelity="exact",
        batch=64,
        seed=5,
        quiet=True,
    )
    res = run_simulation_parallel(opts, mesh=make_mesh({"batch": 8}))
    assert len(res.snr_points) == 3
    assert all(p.total_blocks == 64 for p in res.snr_points)


def test_snr_only_mesh():
    """A mesh with only an 'snr' axis leaves the codeword batch unsharded."""
    from ldpc_tpu.parallel.mesh import make_mesh
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import run_simulation_parallel

    opts = SimOptions(
        matrix="builtin:BCH_7_4_1_strip.alist.txt", blocks=32, iterations=3,
        ber=True, fer=True, fidelity="exact", batch=32, seed=2, quiet=True,
        initial_snr=1.0, end_snr=4.0, step_snr=1.0,
    )
    res = run_simulation_parallel(opts, mesh=make_mesh({"snr": 8}))
    assert len(res.snr_points) == 4
    assert all(p.total_blocks == 32 for p in res.snr_points)


def test_adaptive_sweep_on_mesh_matches_single_device():
    """Adaptive sweeps shard their point executors over the batch mesh
   ; counters must equal the
    single-device run (threefry partitionability)."""
    from ldpc_tpu.models.catalog import MatrixCatalog
    from ldpc_tpu.sim.adaptive import AdaptiveController, ThresholdStrategy
    from ldpc_tpu.sim.config import SimOptions

    opts = SimOptions(
        matrix="builtin:wimax_576_0.5.alist.txt", blocks=32, iterations=5,
        ber=True, fer=True, initial_snr=0.0, end_snr=2.0, step_snr=1.0,
        fidelity="exact", batch=32, seed=3, quiet=True,
    )
    catalog = MatrixCatalog(None)
    single = AdaptiveController(ThresholdStrategy(), catalog).run_adaptive_sweep(opts)
    meshed = AdaptiveController(
        ThresholdStrategy(), catalog, mesh=make_mesh({"batch": 8})
    ).run_adaptive_sweep(opts)

    assert single.adaptation_log == meshed.adaptation_log
    for a, b in zip(single.snr_points, meshed.snr_points):
        assert (a.snr_db, a.total_blocks, a.successful_blocks) == (
            b.snr_db, b.total_blocks, b.successful_blocks)
        assert a.ber == b.ber and a.fer == b.fer


def test_parallel_sweep_target_errors_matches_sequential():
    """With --target-errors the parallel sweep stops each point at its own
    frame-error quota (skip-masked decode), reproducing the sequential
    runner's per-point early stop exactly -- finished points must no longer
    accumulate blocks until the slowest point is done."""
    from ldpc_tpu.parallel.mesh import make_mesh
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import run_simulation, run_simulation_parallel

    opts = SimOptions(
        matrix="builtin:CCSDS_ldpc_n32_k16.alist.txt",
        blocks=256,
        iterations=5,
        ber=True,
        fer=True,
        initial_snr=0.0,
        end_snr=4.0,
        step_snr=2.0,  # FERs differ steeply -> points finish at different times
        fidelity="exact",
        batch=32,
        seed=7,
        quiet=True,
        target_errors=10,
    )
    seq = run_simulation(opts)
    par = run_simulation_parallel(opts, mesh=make_mesh({"batch": 8}))

    # the low-SNR point must stop well before `blocks`, the high-SNR point
    # must run longer (otherwise this test exercises nothing)
    assert seq.snr_points[0].total_blocks < seq.snr_points[-1].total_blocks
    for a, b in zip(seq.snr_points, par.snr_points):
        assert a.snr_db == b.snr_db
        assert a.total_blocks == b.total_blocks
        assert a.successful_blocks == b.successful_blocks
        assert a.ber == b.ber
        assert a.fer == b.fer
