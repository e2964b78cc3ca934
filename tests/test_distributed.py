"""Real multi-process jax.distributed tests (SURVEY.md S4 commitment).

N OS processes, each with 4 virtual CPU devices, join one multi-controller
runtime (coordinator + Gloo collectives) and run mesh-sharded work with the
batch axis spanning the processes. Counters must agree between the
processes (replicated psum result) AND match a single-process run of the
identical configuration -- threefry partitionability makes the randomness
independent of the process layout.

Coverage (every sweep mode the single-process
path has):
  * 2-process point sweep vs in-process 8-device ground truth
  * 2-process parallel-sweep checkpoint + mid-stream resume (bit-identity)
  * 2-process adaptive sweep (threshold strategy on the cross-process mesh)
  * 4-process x 4 devices = 16-device sweep vs a single-process 16-device
    run (launched as a worker subprocess: the in-process backend is pinned
    to 8 devices by conftest)

The reference's only parallelism is single-host ProcessPoolExecutor fan-out
(`python_ldpc_app/main.py:241-292`); this is the multi-host analogue.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")

_COUNTER_KEYS = ("blocks", "ok_blocks", "error_bits", "fer_frames",
                 "conv_iters_sum", "conv_count")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    # Workers import ldpc_tpu by path, not via an installed package. The
    # repo path REPLACES any inherited PYTHONPATH, so nothing on it can
    # initialize JAX at interpreter startup -- before the worker points it
    # at the virtual-CPU platform (the workers stay off any GPU).
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    return env


def _run_workers(tmp_path, nproc, scenario, dev_per_proc=4, timeout=900,
                 prefix=""):
    port = _free_port()
    outs = [str(tmp_path / f"{prefix}{scenario}-w{i}.json")
            for i in range(nproc)]
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(nproc), str(port),
             outs[i], scenario, str(dev_per_proc)],
            env=_worker_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nproc)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"distributed workers timed out ({scenario})")
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed ({scenario}):\n{log[-3000:]}"
    return [json.load(open(o)) for o in outs]


def test_two_process_sharded_sweep(tmp_path):
    a, b = _run_workers(tmp_path, 2, "sweep")
    assert a["devices"] == b["devices"] == 8
    for key in _COUNTER_KEYS:
        assert a[key] == b[key], key

    # single-process ground truth on the in-process 8-device CPU backend
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices for the single-process check")
    from ldpc_tpu.parallel.mesh import make_mesh
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor, load_code

    code = load_code("builtin:CCSDS_ldpc_n32_k16.alist.txt")
    opts = SimOptions(
        matrix=code.name, blocks=64, iterations=5, ber=True, fer=True,
        normalized_llr=True, fidelity="exact", batch=64, seed=7, quiet=True,
    )
    ex = PointExecutor(code, opts, mesh=make_mesh({"batch": -1}))
    stats = ex.run_point(1.0, 64, jax.random.key(7), 0)
    assert (a["blocks"], a["ok_blocks"], a["error_bits"], a["fer_frames"]) \
        == (stats.blocks, stats.ok_blocks, stats.error_bits, stats.fer_frames)
    assert abs(a["norm_llr_sum"] - stats.norm_llr_sum) < 1e-4


def test_two_process_parallel_checkpoint_resume(tmp_path):
    """Checkpoint + mid-stream resume of the PARALLEL sweep under a
    2-process mesh: resumed == uninterrupted, and both processes saw the
    identical (psum-replicated) checkpoint stream."""
    a, b = _run_workers(tmp_path, 2, "ckpt")
    assert a["resumed"] == a["full"], "resume not bit-identical (proc 0)"
    assert b["resumed"] == b["full"], "resume not bit-identical (proc 1)"
    assert a["full"] == b["full"], "processes disagree on the sweep"
    assert a["checkpoint"]["counters"] == b["checkpoint"]["counters"]


def test_two_process_adaptive_sweep(tmp_path):
    """Adaptive threshold strategy with point executors sharded over the
    cross-process mesh: both processes must take the same adaptation
    decisions (they see identical replicated counters)."""
    a, b = _run_workers(tmp_path, 2, "adaptive")
    assert a["adaptation_log"] == b["adaptation_log"]
    assert a["points"] == b["points"]
    assert len(a["points"]) == 3


def test_four_process_16_device_sweep(tmp_path):
    """4 processes x 4 devices = 16-device runtime; counters must agree
    across all processes and match a single-process 16-device run (the
    same worker with nproc=1, devices_per_proc=16)."""
    results = _run_workers(tmp_path, 4, "sweep", timeout=1500)
    assert all(r["devices"] == 16 for r in results)
    for r in results[1:]:
        for key in _COUNTER_KEYS:
            assert r[key] == results[0][key], key

    (single,) = _run_workers(tmp_path, 1, "sweep", dev_per_proc=16,
                             prefix="single-")
    assert single["devices"] == 16
    for key in _COUNTER_KEYS:
        assert results[0][key] == single[key], key
    assert abs(results[0]["norm_llr_sum"] - single["norm_llr_sum"]) < 1e-4
