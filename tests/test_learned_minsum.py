"""Learned min-sum weight schedules (ldpc_tpu.analysis.learned_minsum)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_tpu.analysis.learned_minsum import (
    evaluate_alphas,
    make_unrolled_minsum,
    train_alphas,
)
from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
from ldpc_tpu.ops.encode import make_encoder, random_info_bits
from ldpc_tpu.ops.spa import make_decoder
from ldpc_tpu.sim.runner import load_code

slow = pytest.mark.slow


@pytest.fixture(scope="module")
def wimax():
    return load_code("builtin:wimax_576_0.5.alist.txt")


def _llrs(code, B, snr_db=2.0, seed=0):
    key = jax.random.key(seed)
    k_u, k_ch = jax.random.split(key)
    u = random_info_bits(k_u, B, code.k)
    w = make_encoder(code.standard_encode_spec, "orig")(u)
    consts = ChannelParams(
        mode=1, modulation=1, speed=code.rate, snr_db=snr_db,
        noise_model="exact",
    ).consts()
    llr = make_channel_fn(1, 1, n=code.n)(k_ch, w, consts)
    return u, w, llr


def test_vector_alpha_constant_equals_scalar(wimax):
    """A constant per-iteration alpha vector must reproduce the scalar
    normalized-min-sum decoder bit-for-bit (regression for the vector-alpha
    path and the minsum_excl_update refactor)."""
    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    layout = code.layout("orig")
    _, _, llr = _llrs(code, 32)
    d_s = make_decoder(layout, info, 8, "normalized_minsum", alpha=0.8125)
    d_v = make_decoder(layout, info, 8, "normalized_minsum",
                       alpha=np.full(8, 0.8125))
    r1, r2 = d_s(llr), d_v(llr)
    assert np.array_equal(np.asarray(r1.est), np.asarray(r2.est))
    assert np.array_equal(np.asarray(r1.ok), np.asarray(r2.ok))
    assert np.array_equal(np.asarray(r1.conv_iter), np.asarray(r2.conv_iter))


def test_vector_alpha_requires_normalized_minsum(wimax):
    code = wimax
    info = code.standard_encode_spec.info_pos("orig")
    with pytest.raises(ValueError, match="normalized_minsum"):
        make_decoder(code.layout("orig"), info, 4, "minsum",
                     alpha=np.full(4, 0.8))


def test_unrolled_first_iteration_matches_decoder(wimax):
    """The differentiable unroll and the production decoder share one
    forward: iteration-1 posterior hard decisions must agree exactly."""
    code = wimax
    layout = code.layout("orig")
    info = code.standard_encode_spec.info_pos("orig")
    _, _, llr = _llrs(code, 32, seed=4)
    alphas = jnp.full((1,), 0.8125)
    Ls = make_unrolled_minsum(layout, 1)(alphas, llr)
    est_unrolled = (Ls[0] < 0).astype(np.uint8)
    d = make_decoder(layout, info, 1, "normalized_minsum", alpha=0.8125,
                     early_exit=False)
    res = d(llr)
    assert np.array_equal(np.asarray(est_unrolled), np.asarray(res.est))


def test_degree_specific_weights(wimax):
    """[T, D] degree-specific weights: constant matrix == scalar decoder
    bit-for-bit; distinct per-degree values agree between the unrolled
    forward and the production decoder."""
    from ldpc_tpu.ops.spa import check_degree_classes

    code = wimax
    layout = code.layout("orig")
    info = code.standard_encode_spec.info_pos("orig")
    deg_idx, degrees = check_degree_classes(layout)
    assert len(degrees) >= 2 and deg_idx.shape == (code.m,)

    _, _, llr = _llrs(code, 32, seed=6)
    d_s = make_decoder(layout, info, 6, "normalized_minsum", alpha=0.8125)
    d_m = make_decoder(layout, info, 6, "normalized_minsum",
                       alpha=np.full((6, len(degrees)), 0.8125))
    r1, r2 = d_s(llr), d_m(llr)
    assert np.array_equal(np.asarray(r1.est), np.asarray(r2.est))
    assert np.array_equal(np.asarray(r1.ok), np.asarray(r2.ok))

    # distinct per-degree values: unrolled forward == decoder, iteration 1
    a = np.linspace(0.6, 0.9, len(degrees))[None, :]  # [1, D]
    Ls = make_unrolled_minsum(layout, 1, per_degree=True)(jnp.asarray(a), llr)
    d1 = make_decoder(layout, info, 1, "normalized_minsum", alpha=a,
                      early_exit=False)
    assert np.array_equal(
        (np.asarray(Ls[0]) < 0).astype(np.uint8), np.asarray(d1(llr).est)
    )

    with pytest.raises(ValueError, match="degree classes"):
        make_decoder(layout, info, 4, "normalized_minsum",
                     alpha=np.full((4, len(degrees) + 1), 0.8))


def test_cli_alpha_schedule_parsing():
    from ldpc_tpu.cli import build_parser, options_from_args

    base = ["--matrix", "m", "--decoder", "normalized-minsum"]
    o = options_from_args(build_parser().parse_args(
        base + ["--minsum-alpha", "0.8125"]
    ))
    assert o.minsum_alpha == 0.8125
    o = options_from_args(build_parser().parse_args(
        base + ["--minsum-alpha", "0.64,0.73,0.81"]
    ))
    assert o.minsum_alpha == (0.64, 0.73, 0.81)


def test_cli_sweep_with_alpha_schedule(wimax, tmp_path):
    """End-to-end CLI run decoding with a per-iteration schedule."""
    import json

    from ldpc_tpu.cli import main as cli_main

    out = tmp_path / "r.json"
    rc = cli_main([
        "--matrix", "builtin:wimax_576_0.5.alist.txt",
        "--blocks", "128", "--batch", "128", "--iterations", "3",
        "--ber", "--fer", "--fidelity", "exact", "--speed", "0.5",
        "--decoder", "normalized-minsum",
        "--minsum-alpha", "0.64,0.73,0.81",
        "--initial-snr", "2.0", "--end-snr", "2.0", "--step-snr", "1",
        "--output-json", str(out), "--quiet",
    ])
    assert rc == 0
    pts = json.loads(out.read_text())["snr_points"]
    assert len(pts) == 1 and 0 < pts[0]["fer"] <= 1


def test_empty_alpha_schedule_rejected(wimax):
    """resolve_alpha_schedule must reject an empty [0] or [0, D] schedule
    with a clear error instead of a trace-time IndexError."""
    from ldpc_tpu.ops.spa import resolve_alpha_schedule

    row_slots = wimax.qc.row_slots()
    for bad in (np.zeros((0,)), np.zeros((0, 3))):
        with pytest.raises(ValueError, match="empty"):
            resolve_alpha_schedule(bad, "normalized_minsum", row_slots)


def test_alpha_schedule_requires_normalized_minsum_decoder():
    """The one remaining invalid config: a per-iteration schedule with a
    plain (non-normalized) min-sum decoder."""
    from ldpc_tpu.cli import build_parser, options_from_args
    from ldpc_tpu.sim.runner import PointExecutor

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    opts = options_from_args(build_parser().parse_args([
        "--matrix", "x", "--fidelity", "exact", "--batch", "64",
        "--iterations", "3", "--minsum-alpha", "0.6,0.7,0.8",
        "--decoder", "minsum",
    ]))
    with pytest.raises(ValueError, match="normalized-minsum"):
        PointExecutor(code, opts)


@pytest.mark.parametrize("argv", [
    ["--schedule", "layered"],
    ["--kernel", "pallas"],
    ["--kernel", "pallas", "--schedule", "layered"],
])
def test_alpha_schedule_builds_on_all_paths(argv):
    """Per-iteration alpha schedules run on every decode path (XLA layered,
    the QC kernel on both schedules) -- these configs must construct
    without error (bit-identity vs the XLA decoder is covered in
    tests/test_pallas.py). The kernel runs in the interpreter here."""
    from ldpc_tpu.cli import build_parser, options_from_args
    from ldpc_tpu.sim.runner import PointExecutor

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    base = [
        "--matrix", "x", "--fidelity", "exact", "--batch", "64",
        "--iterations", "3", "--minsum-alpha", "0.6,0.7,0.8",
        "--decoder", "normalized-minsum",
    ]
    opts = options_from_args(build_parser().parse_args(base + argv))
    PointExecutor(code, opts, interpret=True)  # must not raise


@slow
def test_training_learns_useful_schedule(wimax):
    """Loss decreases, the schedule stays in-range, and the learned
    schedule's paired FER does not regress vs the default alpha=0.75."""
    code = wimax
    alphas, losses = train_alphas(
        code, 2.0, iters=5, steps=40, batch=64, lr=0.05, seed=0,
        say=lambda *a, **k: None,
    )
    assert alphas.shape == (5,)
    assert np.all((alphas > 0) & (alphas < 1.5))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])

    base = evaluate_alphas(code, 0.75, 2.0, iters=5, blocks=2048, batch=256)
    learned = evaluate_alphas(code, alphas, 2.0, iters=5, blocks=2048,
                              batch=256)
    assert base["frames"] == learned["frames"]
    assert learned["fer"] <= base["fer"]


@slow
def test_training_per_degree(wimax):
    from ldpc_tpu.ops.spa import check_degree_classes

    code = wimax
    n_deg = len(check_degree_classes(code.layout("orig"))[1])
    alphas, losses = train_alphas(
        code, 2.0, iters=4, steps=25, batch=64, lr=0.05, seed=0,
        per_degree=True, say=lambda *a, **k: None,
    )
    assert alphas.shape == (4, n_deg)
    assert np.all((alphas > 0) & (alphas < 1.5))
    # the learned matrix deploys through the production decoder
    r = evaluate_alphas(code, alphas, 2.0, iters=4, blocks=512, batch=256)
    assert 0 <= r["fer"] <= 1
