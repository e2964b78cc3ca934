"""QC detection + QC decode kernel parity tests (Pallas interpreter on CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.models.generate import gallager_regular
from ldpc_tpu.models.qc import detect_qc
from ldpc_tpu.ops.spa import make_decoder
from ldpc_tpu.ops.spa_pallas import make_qc_decoder, pick_tile
from ldpc_tpu.sim.runner import load_code

WIMAX = "builtin:wimax_576_0.5.alist.txt"


@pytest.fixture(scope="module")
def wimax():
    return load_code(WIMAX)


def test_qc_detection_wimax(wimax):
    qc = wimax.qc
    assert qc is not None
    assert qc.Z == 24 and qc.mb == 12 and qc.nb == 24
    assert np.array_equal(qc.to_dense(), wimax.H.to_dense())


@pytest.mark.parametrize("name,z", [
    ("wifi_648_r083.alist.txt", 27),
    ("CCSDS_ldpc_n128_k64.alist.txt", 16),
    ("Tanner_155_64.alist.txt", 31),
    ("WRAN_N480_K240_P20_R05.txt", 20),
])
def test_qc_detection_families(name, z):
    from ldpc_tpu.models import standards

    a = standards.make_builtin(name)
    qc = detect_qc(a)
    assert qc is not None and qc.Z == z, name
    assert np.array_equal(qc.to_dense(), a.to_dense()), name


def test_random_code_is_not_qc():
    a = gallager_regular(48, 3, 6, seed=11)
    assert detect_qc(a) is None


def test_qc_slots_consistency(wimax):
    qc = wimax.qc
    rows = qc.row_slots()
    cols = qc.col_slots()
    assert sum(len(r) for r in rows) == qc.n_base_edges
    assert sum(len(c) for c in cols) == qc.n_base_edges
    # col_slots back-references valid row slots
    for bj, entries in enumerate(cols):
        for bi, slot, s in entries:
            assert rows[bi][slot] == (bj, s)


def _llrs(code, B, seed, sigma=0.9):
    rng = np.random.default_rng(seed)
    spec = code.standard_encode_spec
    u = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    w = spec.encode_numpy(u, "orig").astype(np.float64)
    llr = 2.0 * ((2 * w - 1) + rng.normal(0, sigma, w.shape)) / sigma**2
    return u, w, llr.astype(np.float32)


@pytest.mark.parametrize("variant", ["spa", "minsum", "normalized_minsum"])
def test_pallas_matches_xla_decoder(wimax, variant):
    """Interpreted kernel (flooding) must agree with the XLA decoder."""
    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    _, _, llr = _llrs(code, 24, seed=5)
    d_xla = make_decoder(code.layout("orig"), info, 10, variant, rule="exact")
    d_qc = make_qc_decoder(code.qc, info, 10, variant, interpret=True)
    r1 = d_xla(jnp.asarray(llr))
    r2 = d_qc(jnp.asarray(llr))
    assert np.array_equal(np.asarray(r1.est), np.asarray(r2.est))
    assert np.array_equal(np.asarray(r1.ok), np.asarray(r2.ok))
    assert np.array_equal(np.asarray(r1.conv_iter), np.asarray(r2.conv_iter))
    np.testing.assert_allclose(
        np.asarray(r1.norm_llr), np.asarray(r2.norm_llr), atol=1e-6
    )


_SCHED = (0.64, 0.73, 0.78, 0.8, 0.8125, 0.8125, 0.82, 0.82)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("form", ["per_iteration", "per_degree"])
def test_alpha_schedule_matches_xla(wimax, schedule, form):
    """[T] / [T, D] normalized-min-sum weight schedules must be bit-identical
    between the XLA decoders and the kernel on every schedule -- the
    deployment guarantee for learned weights (analysis.learned_minsum)."""
    from ldpc_tpu.ops.layered import make_qc_layered_decoder
    from ldpc_tpu.ops.spa import check_degree_classes

    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    _, _, llr = _llrs(code, 24, seed=7)
    if form == "per_iteration":
        alpha = _SCHED
    else:
        _, degrees = check_degree_classes(code.layout("orig"))
        alpha = np.asarray(_SCHED)[:, None] * (
            0.96 + 0.04 * np.arange(len(degrees))
        )[None, :]
    if schedule == "flooding":
        d_xla = make_decoder(
            code.layout("orig"), info, 8, "normalized_minsum",
            rule="exact", alpha=alpha,
        )
    else:
        d_xla = make_qc_layered_decoder(
            code.qc, info, 8, "normalized_minsum", alpha=alpha
        )
    d_qc = make_qc_decoder(
        code.qc, info, 8, "normalized_minsum", alpha=alpha,
        schedule=schedule, interpret=True,
    )
    r1 = d_xla(jnp.asarray(llr))
    r2 = d_qc(jnp.asarray(llr))
    assert np.array_equal(np.asarray(r1.est), np.asarray(r2.est))
    assert np.array_equal(np.asarray(r1.ok), np.asarray(r2.ok))
    assert np.array_equal(np.asarray(r1.conv_iter), np.asarray(r2.conv_iter))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_track_norm_off_identical(wimax, schedule):
    """track_norm=False elides the normalized-LLR bookkeeping (and its
    ``prior`` buffer) without touching the decode: est/ok/conv must be
    bit-identical and norm_llr zeros."""
    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    _, _, llr = _llrs(code, 16, seed=9)
    d_on = make_qc_decoder(code.qc, info, 8, "spa", interpret=True,
                           schedule=schedule)
    d_off = make_qc_decoder(code.qc, info, 8, "spa", interpret=True,
                            schedule=schedule, track_norm=False)
    r1 = d_on(jnp.asarray(llr))
    r2 = d_off(jnp.asarray(llr))
    assert np.array_equal(np.asarray(r1.est), np.asarray(r2.est))
    assert np.array_equal(np.asarray(r1.ok), np.asarray(r2.ok))
    assert np.array_equal(np.asarray(r1.conv_iter), np.asarray(r2.conv_iter))
    assert (np.asarray(r2.norm_llr) == 0).all()
    assert np.asarray(r1.norm_llr).any()


def test_pallas_batch_padding(wimax):
    """Batch not a multiple of the tile: outputs for real codewords
    unchanged."""
    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    _, _, llr = _llrs(code, 24, seed=7, sigma=0.5)
    d_qc = make_qc_decoder(code.qc, info, 6, "spa", interpret=True,
                           tile_b=16)
    r_small = d_qc(jnp.asarray(llr[:10]))
    r_full = d_qc(jnp.asarray(llr))
    assert np.array_equal(np.asarray(r_small.est), np.asarray(r_full.est)[:10])
    assert r_small.est.shape == (10, code.n)


def test_pallas_decodes_clean_input(wimax):
    code = wimax
    spec = code.standard_encode_spec
    info = spec.info_pos("orig")
    u = np.random.default_rng(1).integers(0, 2, (8, code.k), dtype=np.uint8)
    w = spec.encode_numpy(u, "orig").astype(np.float32)
    llr = 9.0 * (2 * w - 1)
    d_qc = make_qc_decoder(code.qc, info, 5, "spa", interpret=True)
    r = d_qc(jnp.asarray(llr))
    assert np.asarray(r.ok).all()
    assert (np.asarray(r.conv_iter) == 0).all()
    assert int(r.iters_run) == 1  # the tile exits after its first check
    assert np.array_equal(np.asarray(r.est), w.astype(np.uint8))


def test_pick_tile(wimax):
    plan = pick_tile(wimax.qc)
    assert plan.tile_b & (plan.tile_b - 1) == 0 and 8 <= plan.tile_b <= 32
    assert plan.num_warps == 8  # check degree 7


def test_runner_kernel_selection(wimax):
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor

    code = wimax
    # auto on the CPU -> xla
    ex = PointExecutor(code, SimOptions(matrix=WIMAX, fidelity="exact",
                                        batch=32))
    assert ex.kernel_used == "xla"
    # forced pallas needs a GPU ...
    with pytest.raises(ValueError, match="GPU"):
        PointExecutor(code, SimOptions(matrix=WIMAX, fidelity="exact",
                                       batch=32, kernel="pallas"))
    # ... or the interpreter, asked for through the API
    ex2 = PointExecutor(
        code, SimOptions(matrix=WIMAX, fidelity="exact", batch=32,
                         kernel="pallas"),
        interpret=True,
    )
    assert ex2.kernel_used.startswith("pallas+tb")
    # reference fidelity is not kernel-eligible
    with pytest.raises(ValueError):
        PointExecutor(
            code,
            SimOptions(matrix=WIMAX, fidelity="reference", batch=32,
                       kernel="pallas"),
            interpret=True,
        )


def test_runner_pallas_end_to_end(wimax):
    """One SNR point through the forced kernel (interpreter) on CPU: the
    counters equal the XLA decoder's on the same stream (min-sum)."""
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import run_simulation

    kw = dict(
        matrix=WIMAX, blocks=32, iterations=5, ber=True, fer=True,
        initial_snr=2.5, end_snr=2.5, step_snr=1.0, fidelity="exact",
        decoder="minsum", batch=32, quiet=True,
    )
    rp = run_simulation(SimOptions(kernel="pallas", **kw), interpret=True)
    rx = run_simulation(SimOptions(kernel="xla", **kw))
    p, x = rp.snr_points[0], rx.snr_points[0]
    assert p.total_blocks == 32
    assert (p.successful_blocks, p.ber, p.avg_convergence_iterations) == (
        x.successful_blocks, x.ber, x.avg_convergence_iterations)


@pytest.mark.parametrize("name,snr", [
    ("Tanner_155_64.alist.txt", 3.0),          # Z=31: not a power of two
    ("wigig_R05_N672_K336.alist.txt", 2.5),    # Z=42
    ("CCSDS_ldpc_n128_k64.alist.txt", 3.0),    # Z=16, multi-diagonal blocks
])
def test_pallas_matches_xla_across_families(name, snr):
    """Flooding parity across lift sizes and block structures."""
    from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
    from ldpc_tpu.ops.encode import make_encoder, random_info_bits

    code = load_code("builtin:" + name)
    spec = code.standard_encode_spec
    enc = make_encoder(spec, "orig")
    chan = make_channel_fn(1, 1)
    key = jax.random.key(3)
    u = random_info_bits(key, 48, code.k)
    llr = chan(jax.random.fold_in(key, 1), enc(u),
               ChannelParams(snr_db=snr, speed=0.5, noise_model="exact").consts())
    ip = spec.info_pos("orig")
    rp = jax.jit(make_qc_decoder(code.qc, ip, 8, "spa", tile_b=16,
                                 interpret=True))(llr)
    rx = jax.jit(make_decoder(code.layout("orig"), ip, 8, "spa", rule="exact"))(llr)
    assert np.array_equal(np.asarray(rx.ok), np.asarray(rp.ok))
    assert np.array_equal(np.asarray(rx.est), np.asarray(rp.est))
    assert np.array_equal(np.asarray(rx.conv_iter), np.asarray(rp.conv_iter))
