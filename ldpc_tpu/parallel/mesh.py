"""Device meshes and sharded Monte-Carlo steps.

The reference's only parallelism is ProcessPoolExecutor over codeword blocks
(`python_ldpc_app/main.py:241-292`). Here it is a `jax.sharding.Mesh` whose
axes carry the two embarrassingly parallel dimensions of the workload:

  batch -- Monte-Carlo codewords: every tensor in the pipeline is
           batch-leading, so a sharding constraint on the info-bit batch
           propagates data-parallel layouts through encode/channel/decode and
           XLA reduces the BlockCounters with cross-device sums. The QC
           Pallas kernel runs per shard under ``jax.shard_map``.
  snr   -- SNR points: independent channel configurations evaluated
           simultaneously by vmapping the point step over a stacked
           ChannelConsts and sharding that axis.

The mesh reshapes the device list in order and assumes no topology: the
cards of one host reach each other all to all (NVLink), so the axes follow
the algorithm alone. Multi-host: initialize `jax.distributed` before
building the mesh; the same code paths then span hosts (each host feeds its
addressable shard of the batch axis).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_sizes: dict[str, int] | None = None, devices=None
) -> Mesh:
    """Build a mesh; default is all devices on one 'batch' axis.

    ``axis_sizes``: e.g. {'snr': 2, 'batch': 4}. A single axis may be -1 to
    absorb the remaining devices.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {"batch": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        fixed = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // fixed
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh {dict(zip(names, sizes))} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, axis_names=tuple(names))


def sharded_sweep_step(executor_step, mesh: Mesh, snr_axis: str = "snr"):
    """Vectorize a point step over a sharded SNR axis.

    ``executor_step(key, consts, skip) -> (BlockStats, iters)`` becomes
    ``sweep(keys[S], consts_stack[S], skips[S]) -> (BlockStats[S],
    iters[S])`` with the S axis sharded over ``snr_axis`` -- every SNR point
    of a sweep runs concurrently on its own mesh slice, while each point's
    codeword batch stays sharded over the remaining axes. ``skips`` (int32,
    nonzero = skip) lets the driver stop paying for points that already
    reached their error quota: a skipped point's decode loop exits before
    iteration 0 and its outputs are discarded by the caller.
    """
    from ldpc_tpu.ops.metrics import BlockStats

    # spmd_axis_name: a shard_map inside the step (the QC kernel's) sees the
    # vmapped SNR axis as sharded over snr_axis instead of replicated
    vstep = jax.vmap(executor_step, spmd_axis_name=snr_axis)
    key_spec = NamedSharding(mesh, P(snr_axis))
    batch_axes = tuple(a for a in mesh.axis_names if a != snr_axis)
    # stats are [S, B]: SNR axis x codeword batch sharded over remaining axes
    stats_spec = NamedSharding(mesh, P(snr_axis, batch_axes or None))
    iters_spec = NamedSharding(mesh, P(snr_axis))

    def sweep(keys, consts_stack, skips):
        keys = jax.lax.with_sharding_constraint(keys, key_spec)
        return vstep(keys, consts_stack, skips)

    out_shardings = (
        BlockStats(stats_spec, stats_spec, stats_spec, stats_spec),
        iters_spec,
    )
    return jax.jit(sweep, out_shardings=out_shardings)
