"""Failure-structure profiler (ldpc_tpu.analysis.failures).

Ground truth: the same MC steps run one-by-one through the executor's
jitted step, histogrammed in numpy. The profiler's scan must reproduce
those histograms exactly (same key folding, same decode)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.analysis.failures import (
    collect_failure_patterns,
    make_pattern_profiler,
    make_profiler,
    profile_point,
    trapping_census,
    weight_summary,
)
from ldpc_tpu.ops.channel import ChannelParams
from ldpc_tpu.sim.config import SimOptions
from ldpc_tpu.sim.runner import PointExecutor, load_code

SNR = 2.0


def _opts(**kw):
    return SimOptions(
        matrix="builtin:wimax_576_0.5.alist.txt",
        blocks=128,
        batch=128,
        iterations=4,
        ber=True,
        fer=True,
        fidelity="exact",
        exact_ber=True,
        speed=0.5,
        seed=3,
        **kw,
    )


def test_profiler_matches_per_step_histograms():
    code = load_code("builtin:wimax_576_0.5.alist.txt")
    opts = _opts()
    ex = PointExecutor(code, opts)
    consts = ChannelParams(
        mode=1, modulation=1, speed=0.5, snr_db=SNR, noise_model="exact"
    ).consts()
    key_point = jax.random.fold_in(jax.random.key(opts.seed), 0)
    n_steps = 3

    chunk = make_profiler(ex, ex.k_active)
    hd, hu, frames = chunk(key_point, jnp.int32(0), consts, n_steps)
    hd, hu = np.asarray(hd), np.asarray(hu)
    assert int(frames) == n_steps * opts.batch

    # ground truth: same keys through the executor's own step
    ref_d = np.zeros(ex.k_active + 1)
    ref_u = np.zeros(ex.k_active + 1)
    for i in range(n_steps):
        stats, _ = ex._step(jax.random.fold_in(key_point, i), consts)
        w = np.asarray(stats.error_bits)
        ok = np.asarray(stats.ok)
        np.add.at(ref_d, w[~ok], 1)
        np.add.at(ref_u, w[ok & (w > 0)], 1)
    assert np.array_equal(hd, ref_d)
    assert np.array_equal(hu, ref_u)
    # at 2 dB / 4 iterations failures must exist, and detected failures
    # dominate (undetected events are minimum-distance rare)
    assert ref_d.sum() > 0
    assert hd.sum() >= hu.sum()


def test_profile_point_stops_at_quota():
    code = load_code("builtin:wimax_576_0.5.alist.txt")
    hd, hu, frames = profile_point(
        code, _opts(), SNR, min_failures=1, max_blocks=4096,
        say=lambda *a, **k: None,
    )
    # first dispatch group is 8 batches; the quota check runs per group
    assert frames == 8 * 128
    assert hd.sum() >= 1

    s = weight_summary(hd)
    assert s["count"] == int(hd.sum())
    assert 0 <= s["min_weight"] <= s["median"] <= s["p90"] <= s["max_weight"]
    assert weight_summary(np.zeros(5)) == {"count": 0}


def test_pattern_capture_matches_weight_histogram():
    """Residual patterns and the weight histogram describe the SAME failures:
    every captured residual fails the syndrome check, and the multiset of
    info-projected weights equals the detected-failure histogram."""
    code = load_code("builtin:wimax_576_0.5.alist.txt")
    opts = _opts()
    ex = PointExecutor(code, opts)
    consts = ChannelParams(
        mode=1, modulation=1, speed=0.5, snr_db=SNR, noise_model="exact"
    ).consts()
    key_point = jax.random.fold_in(jax.random.key(opts.seed), 0)
    n_steps = 3

    hd, _, _ = make_profiler(ex, ex.k_active)(
        key_point, jnp.int32(0), consts, n_steps
    )
    buf, cnt = make_pattern_profiler(ex, max_patterns=512)(
        key_point, jnp.int32(0), consts, n_steps
    )
    hd = np.asarray(hd)
    cnt = int(np.asarray(cnt))
    assert cnt == int(hd.sum()) > 0
    assert cnt <= 512  # all failures captured at this FER/batch
    pats = np.asarray(buf[:cnt])

    H = code.H.to_dense().astype(np.int64)
    assert all(((H @ e.astype(np.int64)) % 2).any() for e in pats)

    info_pos = np.asarray(ex._info_pos)
    w_info = pats[:, info_pos].sum(axis=1).astype(np.int64)
    ref_hist = np.bincount(w_info, minlength=ex.k_active + 1)
    assert np.array_equal(ref_hist, hd.astype(ref_hist.dtype))


def test_trapping_census_classes():
    code = load_code("builtin:wimax_576_0.5.alist.txt")
    pats, seen, frames = collect_failure_patterns(
        code, _opts(), SNR, min_patterns=10, max_blocks=4096,
        say=lambda *a, **k: None,
    )
    assert len(pats) >= 10 and frames <= 4096
    census = trapping_census(pats, code)
    assert census["patterns"] == len(pats)
    assert sum(census["classes"].values()) == len(pats)
    # detected failures always leave unsatisfied checks: b >= 1 in every class
    assert all(int(k.split(",")[1]) >= 1 for k in census["classes"])
    for r in census["recurring_supports"]:
        assert r["count"] > 1 and r["a"] == len(r["support"])


def test_undetected_capture_yields_codewords():
    """kind='undetected' selects syndrome-passing wrong frames; their
    residuals are nonzero CODEWORDS (b = 0 in the census), each an explicit
    minimum-distance upper bound. Exercised with a stubbed pattern step so
    the selection logic is tested without waiting for a rare real event."""
    from ldpc_tpu.analysis.failures import make_pattern_profiler
    from ldpc_tpu.ops.encode import make_encoder
    from ldpc_tpu.ops.metrics import BlockStats

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    opts = _opts()
    ex = PointExecutor(code, opts)

    # craft one true codeword as the wrong-convergence residual
    u1 = np.zeros((1, code.k), np.uint8)
    u1[0, 3] = 1
    c = np.asarray(make_encoder(code.standard_encode_spec, "orig")(
        jnp.asarray(u1)))[0]
    assert c.sum() > 0 and not code.syndrome_orig(c).any()  # codeword

    B = opts.batch
    ok = np.ones(B, bool)
    ok[5] = False  # one detected failure: must NOT be captured
    err = np.zeros(B, np.int32)
    err[2] = err[7] = int(u1.sum())  # two undetected frames
    err[5] = 17
    resid = np.zeros((B, code.n), np.uint8)
    resid[2] = resid[7] = c
    resid[5] = 1  # garbage; detected row, excluded by the undetected filter
    stats = BlockStats(
        error_bits=jnp.asarray(err), ok=jnp.asarray(ok),
        conv_iter=jnp.zeros(B, jnp.int32), norm_llr=jnp.zeros(B, jnp.float32),
    )
    ex._pattern_step = lambda key, consts: (stats, jnp.int32(1),
                                            jnp.asarray(resid))

    chunk = make_pattern_profiler(ex, 8, kind="undetected")
    consts = ChannelParams(
        mode=1, modulation=1, speed=0.5, snr_db=SNR, noise_model="exact"
    ).consts()
    buf, cnt = chunk(jax.random.key(0), jnp.int32(0), consts, 2)
    assert int(cnt) == 4  # 2 undetected frames x 2 scan steps
    pats = np.asarray(buf[:4])
    assert all(np.array_equal(p, c) for p in pats)

    census = trapping_census(pats, code)
    # every class has b == 0: the residuals are codewords
    assert all(k.endswith(",0") for k in census["classes"])
    assert census["recurring_supports"][0]["count"] == 4

    with pytest.raises(ValueError, match="detected"):
        make_pattern_profiler(ex, 8, kind="bogus")
    import dataclasses

    bad = PointExecutor(code, dataclasses.replace(opts, exact_ber=False))
    with pytest.raises(ValueError, match="exact_ber"):
        make_pattern_profiler(bad, 8, kind="undetected")


def test_cli_failure_profile_export(tmp_path):
    """--failure-profile writes per-SNR histograms after the sweep."""
    import json

    from ldpc_tpu.cli import main as cli_main

    out = tmp_path / "fp.json"
    rc = cli_main([
        "--matrix", "builtin:wimax_576_0.5.alist.txt",
        "--blocks", "256", "--batch", "128", "--iterations", "3",
        "--ber", "--fer", "--fidelity", "exact", "--speed", "0.5",
        "--kernel", "xla",
        "--initial-snr", str(SNR), "--end-snr", str(SNR), "--step-snr", "1",
        "--failure-profile", str(out), "--quiet",
    ])
    assert rc == 0
    profiles = json.loads(out.read_text())
    assert list(profiles) == [str(SNR)]
    p = profiles[str(SNR)]
    assert p["frames"] >= 256
    assert p["detected"]["count"] == sum(p["hist_detected"].values())
    assert p["detected"]["count"] > 0  # 2 dB / 3 iterations: failures exist

    # plot surface: module function and the plot CLI both render the JSON
    from ldpc_tpu.plot_cli import main as plot_main

    png = tmp_path / "fp.png"
    rc = plot_main(["--failure-profile", str(out), "--output", str(png),
                    "--no-show"])
    assert rc == 0 and png.stat().st_size > 0
