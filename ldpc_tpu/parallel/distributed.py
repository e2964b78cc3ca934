"""Multi-host initialization.

The reference is single-host by construction (ProcessPoolExecutor + pickle,
main.py:241-292). Here, multi-host scaling is the same code path as
single-host: initialize the JAX multi-controller runtime, build one
`jax.sharding.Mesh` over all devices (local + remote), and the batch/snr
shardings in ldpc_tpu.parallel.mesh span hosts transparently -- each host
feeds its addressable shard of the codeword batch and counter reductions
ride the interconnect.

Launch pattern (one process per host; nothing infers the cluster, so all
three values are given):

    JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=k \
        python -m ldpc_tpu.cli --distributed --matrix ... --mesh batch=-1

The cards of one host need no process per card: one process drives them
all (``--mesh batch=4``).
"""

from __future__ import annotations

import os

_initialized = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed for multi-host runs; returns True if a
    multi-process runtime was started.

    Arguments default to $JAX_COORDINATOR_ADDRESS / $JAX_NUM_PROCESSES /
    $JAX_PROCESS_ID; with none available, falls back to
    ``jax.distributed.initialize()``'s own cluster detection. A
    single-process environment (no coordinator, no cluster) is left
    untouched so local runs keep working with the same flag.
    """
    global _initialized
    if _initialized:
        return True

    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and env_pid:
        process_id = int(env_pid)

    try:
        if coordinator_address:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        else:
            jax.distributed.initialize()  # cluster auto-detection
    except (ValueError, RuntimeError) as e:
        # single-process environment: nothing to coordinate
        if coordinator_address or num_processes:
            raise
        print(f"--distributed: single-process fallback ({e})")
        return False
    _initialized = True
    return True


def is_multi_process() -> bool:
    import jax

    return jax.process_count() > 1
