"""Worker process for the multi-controller tests (tests/test_distributed.py).

Not a test module. Launched as:
    python distributed_worker.py <pid> <nproc> <port> <out.json> \
        [scenario] [devices_per_proc]

Each worker owns ``devices_per_proc`` virtual CPU devices (default 4);
jax.distributed stitches them into one ``nproc * devices_per_proc``-device
runtime (``nproc == 1`` skips the distributed init: the single-process
ground-truth configuration). Scenarios:

  sweep     (default) one mesh-sharded Monte-Carlo point; counters dumped.
  ckpt      multi-process PARALLEL sweep with a mid-stream checkpoint and a
            resume: the resumed result must be bit-identical to an
            uninterrupted run of the same sweep (every process checkpoints
            to its own path; contents must agree across processes because
            counters are psum-replicated).
  adaptive  threshold-strategy adaptive sweep with the point executors
            sharded over the cross-process mesh; the adaptation log and
            per-point counters are dumped for cross-process comparison.
"""

from __future__ import annotations

import json
import os
import sys


def _stats_payload(stats) -> dict:
    return {
        "blocks": stats.blocks,
        "ok_blocks": stats.ok_blocks,
        "error_bits": stats.error_bits,
        "fer_frames": stats.fer_frames,
        "norm_llr_sum": stats.norm_llr_sum,
        "conv_iters_sum": stats.conv_iters_sum,
        "conv_count": stats.conv_count,
    }


def _points_payload(result) -> list:
    return [
        {
            "snr_db": p.snr_db,
            "blocks": p.total_blocks,
            "ok": p.successful_blocks,
            "ber": p.ber,
            "fer": p.fer,
        }
        for p in result.snr_points
    ]


def scenario_sweep(opts_kw, mesh):
    import jax

    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor, load_code

    code = load_code(opts_kw["matrix"])
    ex = PointExecutor(code, SimOptions(**opts_kw), mesh=mesh)
    stats = ex.run_point(1.0, opts_kw["blocks"], jax.random.key(7), 0)
    return _stats_payload(stats)


def scenario_ckpt(opts_kw, mesh, out):
    """Parallel sweep: uninterrupted vs checkpoint+resume, on the mesh."""
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import (
        load_code,
        make_sim_config,
        run_simulation_parallel,
        sweep_fingerprint,
    )

    sweep_kw = dict(
        opts_kw, blocks=96, batch=32,
        initial_snr=0.0, end_snr=2.0, step_snr=1.0,
    )
    full = run_simulation_parallel(SimOptions(**sweep_kw))

    ckpt = out + ".ckpt.json"
    run_simulation_parallel(SimOptions(**dict(sweep_kw, blocks=32,
                                              checkpoint=ckpt)))
    saved = json.load(open(ckpt))
    assert saved["parallel_sweep"] == 1 and saved["batch_idx"] == 1, saved

    # patch the fingerprint/remaining the way a real interrupted 96-block run
    # would have written them (blocks is part of the sweep identity)
    resumed_opts = SimOptions(**dict(sweep_kw, checkpoint=ckpt, resume=True))
    fp = json.loads(json.dumps(sweep_fingerprint(
        make_sim_config(resumed_opts.resolved(),
                        load_code(sweep_kw["matrix"]))
    )))
    saved["fingerprint"] = fp
    saved["remaining"] = 96 - 32
    json.dump(saved, open(ckpt, "w"))

    resumed = run_simulation_parallel(resumed_opts)
    return {
        "full": _points_payload(full),
        "resumed": _points_payload(resumed),
        "checkpoint": saved,
    }


def scenario_adaptive(opts_kw, mesh):
    from ldpc_tpu.models.catalog import MatrixCatalog
    from ldpc_tpu.sim.adaptive import AdaptiveController, ThresholdStrategy
    from ldpc_tpu.sim.config import SimOptions

    sweep_kw = dict(
        opts_kw, blocks=32, batch=32,
        initial_snr=0.0, end_snr=2.0, step_snr=1.0,
    )
    result = AdaptiveController(
        ThresholdStrategy(), MatrixCatalog(None), mesh=mesh
    ).run_adaptive_sweep(SimOptions(**sweep_kw))
    return {
        "points": _points_payload(result),
        "adaptation_log": result.adaptation_log,
    }


def main() -> int:
    pid, nproc, port, out = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    scenario = sys.argv[5] if len(sys.argv) > 5 else "sweep"
    dev_per_proc = int(sys.argv[6]) if len(sys.argv) > 6 else 4

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={dev_per_proc}"
        ).strip()

    from ldpc_tpu.parallel.distributed import (
        initialize_distributed,
        is_multi_process,
    )

    if nproc > 1:
        started = initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
        assert started and is_multi_process(), "multi-controller init failed"
    import jax

    assert jax.process_count() == nproc
    assert jax.device_count() == dev_per_proc * nproc
    assert jax.local_device_count() == dev_per_proc

    from ldpc_tpu.parallel.mesh import make_mesh

    opts_kw = dict(
        matrix="builtin:CCSDS_ldpc_n32_k16.alist.txt", blocks=64,
        iterations=5, ber=True, fer=True, normalized_llr=True,
        fidelity="exact", batch=64, seed=7, quiet=True,
    )
    mesh = make_mesh({"batch": -1})

    if scenario == "sweep":
        payload = scenario_sweep(opts_kw, mesh)
    elif scenario == "ckpt":
        payload = scenario_ckpt(opts_kw, mesh, out)
    elif scenario == "adaptive":
        payload = scenario_adaptive(opts_kw, mesh)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")

    payload.update(
        process_id=pid, devices=jax.device_count(), scenario=scenario
    )
    json.dump(payload, open(out, "w"))
    if nproc > 1:
        jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
