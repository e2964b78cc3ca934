"""BER / FER / convergence accounting with the reference's conventions.

Reference quirks faithfully reproduced (see main.py:124-146, 319-339):
  * FER counts frames whose decode result != OK.
  * BER counts erroneous info bits ONLY for failed frames; converged frames
    contribute zero error bits by construction of the syndrome check. (A
    converged frame can in principle land on a wrong codeword -- an
    undetected error -- which the reference silently scores as error-free.
    ``exact=True`` counts those too.)
  * Decoded bits are stored inverted (z = 1 <=> LLR < 0); comparisons
    re-invert (main.py:137). Our DecodeResult.est already holds z ^ 1, the
    estimated bits, so comparison is direct.
  * avg convergence iterations average over converged frames only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class BlockCounters(NamedTuple):
    """Summable per-batch counters (all scalars, f64-safe int32/float32)."""

    blocks: jax.Array  # int32: codewords processed
    ok_blocks: jax.Array  # int32: frames decoded OK
    error_bits: jax.Array  # int32: info-bit errors (failed frames only unless exact)
    fer_frames: jax.Array  # int32: failed frames
    norm_llr_sum: jax.Array  # f32: sum of per-frame normalized-LLR summaries
    conv_iters_sum: jax.Array  # int32: sum of convergence iterations (converged)
    conv_count: jax.Array  # int32: number of converged frames

    def __add__(self, other: "BlockCounters") -> "BlockCounters":
        return BlockCounters(*(a + b for a, b in zip(self, other)))

    @staticmethod
    def zeros() -> "BlockCounters":
        z32 = jnp.int32(0)
        return BlockCounters(z32, z32, z32, z32, jnp.float32(0.0), z32, z32)


class BlockStats(NamedTuple):
    """Per-codeword metric arrays (all [B]), produced alongside the decode.

    Kept unreduced inside the decode program on purpose: XLA's compile time
    explodes (minutes) when cross-batch reductions consume while-loop outputs
    in the same program, so the cheap reduction to BlockCounters lives in a
    separately compiled function (``make_reducer``).
    """

    error_bits: jax.Array  # int32 [B]
    ok: jax.Array  # bool [B]
    conv_iter: jax.Array  # int32 [B]
    norm_llr: jax.Array  # f32 [B]


def block_stats(
    u: jax.Array,  # uint8 [B, k] original info bits
    result,  # DecodeResult
    info_pos: jax.Array,  # int32 [k] positions of info bits in the codeword
    exact: bool = False,
) -> BlockStats:
    decoded_info = jnp.take(result.est, info_pos, axis=1)
    errs = jnp.sum(decoded_info != u.astype(decoded_info.dtype), axis=1).astype(
        jnp.int32
    )
    if not exact:
        # reference: bits counted only when decode failed (main.py:134)
        errs = jnp.where(result.ok, 0, errs)
    return BlockStats(
        error_bits=errs,
        ok=result.ok,
        conv_iter=result.conv_iter,
        norm_llr=result.norm_llr,
    )


def reduce_block_stats(stats: BlockStats, valid: jax.Array) -> BlockCounters:
    """Masked reduction of BlockStats -> BlockCounters (jit separately)."""
    msum = lambda x: jnp.sum(jnp.where(valid, x, 0))
    converged = stats.conv_iter >= 0
    return BlockCounters(
        blocks=jnp.sum(valid).astype(jnp.int32),
        ok_blocks=msum(stats.ok).astype(jnp.int32),
        error_bits=msum(stats.error_bits).astype(jnp.int32),
        fer_frames=msum(~stats.ok).astype(jnp.int32),
        norm_llr_sum=msum(stats.norm_llr).astype(jnp.float32),
        conv_iters_sum=msum(jnp.where(converged, stats.conv_iter, 0)).astype(
            jnp.int32
        ),
        conv_count=msum(converged).astype(jnp.int32),
    )


def pack_counters(c: BlockCounters, iters: jax.Array) -> jax.Array:
    """BlockCounters + iteration count -> ONE int32[8] device vector.

    Every host fetch is a device sync; fetching a BlockCounters leaf by
    leaf costs 7 of them. Packing the six int32 counters, the iteration
    count and the bitcast norm_llr_sum into a single vector makes the
    whole batch result one transfer (:func:`unpack_counters` reverses it
    on the host)."""
    ints = jnp.stack([
        c.blocks, c.ok_blocks, c.error_bits, c.fer_frames,
        c.conv_iters_sum, c.conv_count, iters.astype(jnp.int32),
    ])
    f = jax.lax.bitcast_convert_type(
        c.norm_llr_sum.astype(jnp.float32), jnp.int32
    )
    return jnp.concatenate([ints, f[None]])


def unpack_counters(vec) -> tuple[BlockCounters, int]:
    """Host-side inverse of :func:`pack_counters` (numpy scalars)."""
    import numpy as np

    v = np.asarray(vec)
    norm = v[7:8].view(np.float32)[0]
    return (
        BlockCounters(
            blocks=v[0], ok_blocks=v[1], error_bits=v[2], fer_frames=v[3],
            norm_llr_sum=norm, conv_iters_sum=v[4], conv_count=v[5],
        ),
        int(v[6]),
    )


def count_block_metrics(
    u: jax.Array,
    result,
    info_pos: jax.Array,
    exact: bool = False,
    valid: jax.Array | None = None,
) -> BlockCounters:
    """One-shot convenience (tests / small runs): stats + reduction together.
    Production steps should keep the two in separate jits (see BlockStats)."""
    if valid is None:
        valid = jnp.ones(u.shape[0], bool)
    return reduce_block_stats(block_stats(u, result, info_pos, exact), valid)
