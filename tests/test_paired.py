"""Paired layered schedule: grouping properties + bit-parity (interpret)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.models.qc import paired_layer_groups
from ldpc_tpu.ops.layered import make_qc_layered_decoder
from ldpc_tpu.ops.spa_pallas import make_qc_decoder


@pytest.fixture(scope="module")
def wimax():
    from ldpc_tpu.sim.runner import load_code

    return load_code("builtin:wimax_576_0.5.alist.txt")


def _llrs(code, B, seed, sigma=0.9):
    rng = np.random.default_rng(seed)
    spec = code.standard_encode_spec
    u = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    w = spec.encode_numpy(u, "orig").astype(np.float64)
    llr = 2.0 * ((2 * w - 1) + rng.normal(0, sigma, w.shape)) / sigma**2
    return u, w, llr.astype(np.float32)


@pytest.mark.parametrize("name", [
    "wimax_1152_0.5.alist.txt",
    "wimax_576_0.83.alist.txt",
    "wigig_R05_N672_K336.alist.txt",
    "CCSDS_ldpc_n128_k64.alist.txt",
    "WRAN_N384_K192_P16_R05.txt",
])
def test_groups_partition_and_disjoint(name):
    """Groups cover every base row exactly once; pairs share no columns."""
    from ldpc_tpu.sim.runner import load_code

    qc = load_code(f"builtin:{name}").qc
    groups = paired_layer_groups(qc)
    flat = [bi for g in groups for bi in g]
    assert sorted(flat) == list(range(qc.mb))
    rows = qc.row_slots()
    for g in groups:
        assert len(g) in (1, 2)
        if len(g) == 2:
            a = {bj for bj, _ in rows[g[0]]}
            b = {bj for bj, _ in rows[g[1]]}
            assert not (a & b), f"group {g} shares base columns"


def test_groups_deterministic(wimax):
    g1 = paired_layer_groups(wimax.qc)
    g2 = paired_layer_groups(wimax.qc)
    assert g1 == g2
    # the flagship pairs fully (12 rows -> 6 pairs)
    assert all(len(g) == 2 for g in g1)


@pytest.mark.parametrize("variant", ["spa", "normalized_minsum"])
def test_paired_pallas_matches_xla_flat_order(wimax, variant):
    """The paired kernel must agree BIT-FOR-BIT with the XLA layered decoder
    running the flattened group order serially -- the arithmetic-identity
    claim behind the pairing (disjoint rows share no posteriors)."""
    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    _, _, llr = _llrs(code, 8, seed=7)
    groups = paired_layer_groups(code.qc)
    flat = [bi for g in groups for bi in g]
    d_x = make_qc_layered_decoder(code.qc, info, 8, variant, layer_order=flat)
    d_p = make_qc_decoder(code.qc, info, 8, variant, interpret=True,
                          schedule="layered", layer_groups=groups, tile_b=8)
    r1 = d_x(jnp.asarray(llr))
    r2 = d_p(jnp.asarray(llr))
    assert np.array_equal(np.asarray(r1.est), np.asarray(r2.est))
    assert np.array_equal(np.asarray(r1.ok), np.asarray(r2.ok))
    assert np.array_equal(np.asarray(r1.conv_iter), np.asarray(r2.conv_iter))
    np.testing.assert_allclose(
        np.asarray(r1.norm_llr), np.asarray(r2.norm_llr), atol=1e-6
    )


def test_paired_decodes_like_serial_statistically(wimax):
    """Pairing is a row reorder: not bit-equal to serial, but it must decode
    the same channel about equally well (same converged count +-20%)."""
    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    _, _, llr = _llrs(code, 48, seed=9, sigma=0.82)
    groups = paired_layer_groups(code.qc)
    d_s = make_qc_decoder(code.qc, info, 8, "spa", interpret=True,
                          schedule="layered", tile_b=16)
    d_p = make_qc_decoder(code.qc, info, 8, "spa", interpret=True,
                          schedule="layered", layer_groups=groups, tile_b=16)
    ok_s = int(np.asarray(d_s(jnp.asarray(llr)).ok).sum())
    ok_p = int(np.asarray(d_p(jnp.asarray(llr)).ok).sum())
    assert ok_s > 24  # the operating point actually decodes
    assert abs(ok_s - ok_p) <= max(8, ok_s // 5)


def test_bad_groups_rejected(wimax):
    info = wimax.standard_encode_spec.info_pos("orig")
    # rows 0 and 1 share base columns in 802.16e R1/2
    with pytest.raises(ValueError, match="share base columns"):
        make_qc_decoder(wimax.qc, info, 4, "spa", interpret=True,
                        schedule="layered",
                        layer_groups=[[0, 1]] + [[i] for i in range(2, 12)])
    with pytest.raises(ValueError, match="partition"):
        make_qc_decoder(wimax.qc, info, 4, "spa", interpret=True,
                        schedule="layered", layer_groups=[[0, 2]])
    with pytest.raises(ValueError, match="layered"):
        make_qc_decoder(wimax.qc, info, 4, "spa", interpret=True,
                        schedule="flooding", layer_groups=[[0, 2]])


def test_config_validation():
    from ldpc_tpu.sim.config import SimOptions

    with pytest.raises(ValueError, match="layer_order"):
        SimOptions(matrix="x", blocks=1, layer_order="zigzag").resolved()
    with pytest.raises(ValueError, match="requires --schedule layered"):
        SimOptions(matrix="x", blocks=1, layer_order="paired",
                   schedule="flooding").resolved()


def test_runner_paired_end_to_end():
    """Full sweep through the QC kernel (interpreter) with --layer-order
    paired: sane stats, kernel string advertises the pairing, fingerprint
    differs from serial."""
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import (
        load_code,
        make_sim_config,
        run_simulation,
        sweep_fingerprint,
    )

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    kw = dict(
        matrix="builtin:wimax_576_0.5.alist.txt",
        blocks=64, batch=64, iterations=6, ber=True, fer=True,
        fidelity="exact", schedule="layered", kernel="pallas",
        initial_snr=2.0, end_snr=2.0, step_snr=1.0, seed=3, quiet=True,
    )
    res = run_simulation(SimOptions(layer_order="paired", **kw), code,
                         interpret=True)
    pt = res.snr_points[0]
    assert 0.0 <= pt.fer <= 1.0
    assert pt.total_blocks == 64
    assert res.config.layer_order == "paired"
    f_paired = sweep_fingerprint(res.config)
    f_serial = sweep_fingerprint(
        make_sim_config(SimOptions(layer_order="serial", **kw).resolved(), code)
    )
    assert f_paired != f_serial
