"""Helpers of chip_smoke.py (the script itself needs a GPU)."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs


class _Dev:
    def __init__(self, platform):
        self.platform = platform


def test_require_gpus_raises_on_cpu():
    import jax

    with pytest.raises(RuntimeError, match="GPU"):
        cs.require_gpus(jax.devices())


@pytest.mark.parametrize("platforms,count,ok", [
    (["gpu"], 1, True), (["gpu"] * 4, 4, True), (["gpu"], 4, False),
    ([], 1, False), (["cpu"], 1, False), (["gpu", "cpu"], 1, False),
])
def test_require_gpus(platforms, count, ok):
    devs = [_Dev(p) for p in platforms]
    if ok:
        cs.require_gpus(devs, count)
    else:
        with pytest.raises(RuntimeError):
            cs.require_gpus(devs, count)


def test_script_fails_without_gpu():
    """Run as a script on a machine without a GPU: non-zero exit and no
    result line."""
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    p = subprocess.run([sys.executable, cs.__file__], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_gpu_tests_phase_fails_without_gpu():
    """Without a card the gpu tests cannot run: the phase raises rather
    than counting skips as a pass."""
    with pytest.raises(RuntimeError, match="gpu tests"):
        cs.phase_gpu_tests("no card")


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", "NVIDIA H100 80GB HBM3, 700.00 W"),
    ("NVIDIA H100 80GB HBM3, 400.00 W\nNVIDIA H100 80GB HBM3, 400.00 W\n",
     "NVIDIA H100 80GB HBM3, 400.00 W"),
    ("\n  NVIDIA H200 ,  [N/A] \n", "NVIDIA H200, [N/A]"),
])
def test_parse_card(text, want):
    assert cs.parse_card(text) == want


@pytest.mark.parametrize("text", ["", "garbage", "a, b, c"])
def test_parse_card_rejects(text):
    with pytest.raises(ValueError):
        cs.parse_card(text)


def test_syndromes_zero():
    from ldpc_tpu.sim.runner import load_code

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    spec = code.standard_encode_spec
    u = np.random.default_rng(0).integers(0, 2, (6, code.k), dtype=np.uint8)
    w = spec.encode_numpy(u, "orig").astype(np.uint8)
    H = code.H.to_dense()
    assert cs.syndromes_zero(H, w).all()
    w[2, 5] ^= 1
    assert list(cs.syndromes_zero(H, w)) == [True, True, False, True, True,
                                             True]


def test_wilson_brackets():
    lo, hi = cs.wilson(25, 4096)
    assert lo < 25 / 4096 < hi
    assert cs.wilson(0, 100)[0] == 0.0


@pytest.mark.parametrize("points,ok", [
    ([(1.0, 0.5), (1.5, 0.1), (2.0, 0.006), (2.5, 1e-4)], True),
    ([(1.0, 0.5), (1.5, 0.1), (2.0, 0.02), (2.5, 1e-4)], False),  # band
    ([(1.0, 0.5), (1.5, 0.1), (2.0, 0.006), (2.5, 0.007)], False),  # rises
    ([(1.0, 0.5), (1.5, 0.1)], False),  # no 2 dB point
])
def test_check_sweep(points, ok):
    if ok:
        cs.check_sweep(points)
    else:
        with pytest.raises(RuntimeError):
            cs.check_sweep(points)


@pytest.mark.parametrize("variant,agree,f1,f2,ok", [
    ("minsum", 1.0, 30, 30, True),
    ("minsum", 0.9999, 30, 31, True),
    ("offset_minsum", 0.9990, 30, 30, False),
    ("spa", 0.9995, 25, 27, True),
    ("spa", 0.998, 25, 25, False),
    ("spa", 0.9995, 25, 60, False),  # FERs outside each other's interval
])
def test_check_parity(variant, agree, f1, f2, ok):
    if ok:
        cs.check_parity(variant, agree, f1, f2, 4096)
    else:
        with pytest.raises(RuntimeError):
            cs.check_parity(variant, agree, f1, f2, 4096)


def test_point_counters():
    p = {"total_blocks": 1000, "successful_blocks": 990, "fer": 0.01,
         "ber": 123 / (576 * 1000), "avg_convergence_iterations": 4.25}
    assert cs.point_counters(p, 576) == {
        "blocks": 1000, "ok_blocks": 990, "fer_frames": 10,
        "error_bits": 123, "conv_iters_sum": 4208}


def test_parse_throughput():
    log = ("\nSNR: 1.00 dB\n  FER: 0.5\n  Throughput: 1,234 codewords/s "
           "(710,784 info bits/s)\n\nSNR: 1.50 dB\n  Throughput: 2,000 "
           "codewords/s (1,152,000 info bits/s)\n")
    assert cs.parse_throughput(log) == [(1.0, 1234.0, 710784.0),
                                        (1.5, 2000.0, 1152000.0)]
