"""Layered (serial-C) QC decoding (ldpc_tpu.ops.layered).

Checks: decoded outputs are valid codewords, layered converges in
substantially fewer iterations than flooding at the same operating point,
and FER at the same iteration budget is no worse than flooding's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.models.code import LDPCCode
from ldpc_tpu.models.standards import wimax
from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
from ldpc_tpu.ops.encode import make_encoder, random_info_bits
from ldpc_tpu.ops.layered import make_qc_layered_decoder
from ldpc_tpu.ops.spa import make_decoder


@pytest.fixture(scope="module")
def setup():
    code = LDPCCode(alist=wimax(576, "1/2"), name="wimax_576_0.5")
    spec = code.standard_encode_spec
    enc = make_encoder(spec, "orig")
    chan = make_channel_fn(1, 1)
    key = jax.random.key(7)
    u = random_info_bits(key, 512, code.k)
    w = enc(u)
    consts = ChannelParams(snr_db=2.2, speed=0.5, noise_model="exact").consts()
    llr = chan(jax.random.fold_in(key, 1), w, consts)
    return code, spec, np.asarray(w), llr


@pytest.mark.parametrize("variant", ["spa", "normalized_minsum"])
def test_layered_decodes_to_valid_codewords(setup, variant):
    code, spec, w, llr = setup
    dec = jax.jit(
        make_qc_layered_decoder(code.qc, spec.info_pos("orig"), 20, variant)
    )
    r = dec(llr)
    ok = np.asarray(r.ok)
    est = np.asarray(r.est)
    assert ok.mean() > 0.9
    # every 'ok' word satisfies the original H (exact syndrome)
    H = code.H.to_dense().astype(np.int64)
    syn = (est[ok] @ H.T) % 2
    assert not syn.any()
    # and matches the transmitted codeword for the vast majority
    assert (est[ok] == w[ok]).all(axis=1).mean() > 0.999


def test_layered_converges_faster_than_flooding(setup):
    code, spec, w, llr = setup
    ip = spec.info_pos("orig")
    flood = jax.jit(make_decoder(code.layout("orig"), ip, 40, "spa", rule="exact"))
    layer = jax.jit(make_qc_layered_decoder(code.qc, ip, 40, "spa"))
    rf, rl = flood(llr), layer(llr)

    okf, okl = np.asarray(rf.ok), np.asarray(rl.ok)
    # at saturation both plateau; allow small trapping-set differences
    assert okl.sum() >= okf.sum() - 0.01 * okf.size
    both = okf & okl
    mean_f = np.asarray(rf.conv_iter)[both].mean()
    mean_l = np.asarray(rl.conv_iter)[both].mean()
    # classic result: layered needs ~half the iterations
    assert mean_l <= 0.65 * mean_f, (mean_l, mean_f)


def test_layered_fer_at_half_budget_not_worse(setup):
    code, spec, w, llr = setup
    ip = spec.info_pos("orig")
    flood20 = jax.jit(make_decoder(code.layout("orig"), ip, 20, "spa", rule="exact"))
    layer10 = jax.jit(make_qc_layered_decoder(code.qc, ip, 10, "spa"))
    f = np.asarray(flood20(llr).ok).mean()
    l = np.asarray(layer10(llr).ok).mean()
    assert l >= f - 0.02, (l, f)


def test_layered_conv_iter_and_freeze_semantics(setup):
    code, spec, w, llr = setup
    ip = spec.info_pos("orig")
    dec = jax.jit(make_qc_layered_decoder(code.qc, ip, 15, "spa"))
    r = dec(llr)
    conv = np.asarray(r.conv_iter)
    ok = np.asarray(r.ok)
    assert (conv[ok] >= 0).all() and (conv[ok] < 15).all()
    assert (conv[~ok] == -1).all()


def test_pallas_layered_matches_jnp_layered(setup):
    """The QC kernel's layered schedule (Pallas interpreter on CPU) must
    agree with the jnp layered reference."""
    from ldpc_tpu.ops.spa_pallas import make_qc_decoder

    code, spec, w, llr = setup
    ip = spec.info_pos("orig")
    llr_small = llr[:128]
    ref = jax.jit(make_qc_layered_decoder(code.qc, ip, 8, "spa"))(llr_small)
    pal = jax.jit(
        make_qc_decoder(code.qc, ip, 8, "spa", schedule="layered",
                        tile_b=32, interpret=True)
    )(llr_small)
    assert np.array_equal(np.asarray(ref.ok), np.asarray(pal.ok))
    assert np.array_equal(np.asarray(ref.est), np.asarray(pal.est))
    assert np.array_equal(np.asarray(ref.conv_iter), np.asarray(pal.conv_iter))
    np.testing.assert_allclose(
        np.asarray(ref.norm_llr), np.asarray(pal.norm_llr), atol=1e-6
    )


def test_runner_layered_schedule(setup):
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor

    code, *_ = setup
    opts = SimOptions(
        matrix=code.name, blocks=256, iterations=10, ber=True, fer=True,
        fidelity="exact", batch=256, schedule="layered",
    )
    ex = PointExecutor(code, opts)
    assert "layered" in ex.kernel_used
    stats = ex.run_point(2.5, 256, jax.random.key(1), 0)
    assert stats.ok_blocks > 240

    with pytest.raises(ValueError, match="layered"):
        from ldpc_tpu.models.generate import gallager_regular
        from ldpc_tpu.models.code import LDPCCode as LC

        nonqc = LC(alist=gallager_regular(96, 3, 6, seed=1), name="nonqc")
        PointExecutor(nonqc, opts)


def test_layered_multidiagonal_ccsds():
    """Multi-diagonal blocks (CCSDS '0+7') decode through the layered
    schedule via additive in-layer posterior updates; jnp and Pallas agree
    bit-for-bit, and layered still converges faster than flooding."""
    from ldpc_tpu.models.standards import ccsds
    from ldpc_tpu.ops.spa_pallas import make_qc_decoder

    code = LDPCCode(alist=ccsds(128), name="ccsds_128")
    assert code.qc is not None and not code.qc.single_diagonal
    spec = code.standard_encode_spec
    ip = spec.info_pos("orig")
    enc = make_encoder(spec, "orig")
    key = jax.random.key(3)
    u = random_info_bits(key, 256, code.k)
    w = np.asarray(enc(u))
    consts = ChannelParams(snr_db=2.5, speed=0.5, noise_model="exact").consts()
    llr = make_channel_fn(1, 1)(jax.random.fold_in(key, 1), jnp.asarray(w), consts)

    ref = jax.jit(make_qc_layered_decoder(code.qc, ip, 10, "spa"))(llr)
    ok = np.asarray(ref.ok)
    est = np.asarray(ref.est)
    assert ok.mean() > 0.8
    H = code.H.to_dense().astype(np.int64)
    assert not ((est[ok] @ H.T) % 2).any()

    pal = jax.jit(
        make_qc_decoder(code.qc, ip, 10, "spa", schedule="layered",
                        tile_b=32, interpret=True)
    )(llr[:128])
    assert np.array_equal(ok[:128], np.asarray(pal.ok))
    assert np.array_equal(est[:128], np.asarray(pal.est))
    assert np.array_equal(np.asarray(ref.conv_iter)[:128],
                          np.asarray(pal.conv_iter))

    # layered reaches flooding's 20-iteration FER within 10 iterations
    flood20 = jax.jit(make_decoder(code.layout("orig"), ip, 20, "spa",
                                   rule="exact"))(llr)
    assert ok.mean() >= np.asarray(flood20.ok).mean() - 0.02
