"""Batched flooding LDPC decoders on the padded edge layout.

Re-designs the reference SPA (`python_ldpc_app/spa_decoder.py:63-280`) as a
pure array program: messages live check-major in a dense padded tensor
``M[batch, m, dc]`` over the EdgeLayout compiled at code-load time, so every
iteration is gathers + elementwise math + reductions with static shapes.
A `lax.while_loop` with per-codeword masks provides syndrome early
termination (spa_decoder.py:190-241) without dynamic shapes: converged
codewords freeze their outputs while stragglers keep iterating, and the loop
exits when every codeword in the batch is done or max_iterations is reached.

Iteration structure matched to the reference:
  1. M initialized to channel LLRs on H's edges      (spa_decoder.py:88-91)
  2. check-node update E = 2 atanh(prod_{i'!=i} tanh(M/2)) with the
     reference's clipping constants; the leave-one-out product is computed
     EXACTLY via exclusive prefix/suffix products rather than the reference's
     divide-with-fallback (spa_decoder.py:114-168) -- identical math, no
     division hazards.
  3. posterior L = llr + sum_j E[j, .]; hard decision z = (L < 0), i.e. the
     estimated bit is z ^ 1 = (L >= 0)                (spa_decoder.py:170-188)
  4. syndrome H (z ^ 1) = 0 -> converged, record 0-based iteration
                                                      (spa_decoder.py:190-241)
  5. variable-node update M = L - E                   (spa_decoder.py:255-268)

Variants: 'spa' (tanh rule), 'minsum', 'normalized_minsum' (alpha-scaled),
'offset_minsum' (beta-offset), plus a Gallager-B 'bitflipping' decoder (the
reference declares bit-flipping in its CLI but never implemented it --
main.py:464 vs main.py:78).

Normalized-LLR metric (spa_decoder.py:206-228): per iteration, the fraction
of info bits whose prior/posterior LLRs changed sign among those with
|posterior| <= 7.0; the reported value is the final iteration's
(spa_decoder.py:236-239).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Reference clipping constants (spa_decoder.py:139-145,167). In float64 these
# are the exact values the reference uses; in float32 the tightest
# representable magnitude below 1 plays the same role.
TANH_IN_CLIP = 17.5
PROD_CLIP_F64 = 0.99999999999999878
PROD_CLIP_F32 = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
LLR_WINDOW = 7.0  # normalized-LLR confidence window (spa_decoder.py:218)
# Variable degrees up to this sum their incoming messages left to right, the
# QC kernel's order (the built-in QC codes' graphs have degrees up to 6).
# Denser graphs, such as the systematic H_std of the reference fidelity
# (degree 191 for WiMAX 576), take one reduction: there the unrolled chain
# took 1.8x the reduction's time on an H100 and 31x on the CPU (PERF.md).
SEQ_SUM_MAX_DV = 32


class DecodeResult(NamedTuple):
    ok: jax.Array  # bool [B]   syndrome satisfied
    est: jax.Array  # uint8 [B, n]  estimated codeword bits (z ^ 1 convention)
    conv_iter: jax.Array  # int32 [B]  0-based converging iteration, -1 if failed
    norm_llr: jax.Array  # f32 [B]    normalized-LLR at the final iteration
    iters_run: jax.Array  # int32 []   iterations the batch actually executed


def _prod_clip(dtype) -> float:
    """Largest value strictly below 1.0 IN THE MESSAGE DTYPE.

    The clip must survive a round-trip through ``dtype``: the f32 constant
    rounds to exactly 1.0 in bfloat16, which sends the 2*atanh log form to
    +inf and collapses the whole decode to NaN -> all-zero estimates that
    pass the syndrome check."""
    if dtype == jnp.float64:
        return PROD_CLIP_F64
    if dtype == jnp.bfloat16:
        return 1.0 - 2.0**-8  # largest bf16 < 1
    return PROD_CLIP_F32


def _exclusive_prod(t: jax.Array) -> jax.Array:
    """Exact leave-one-out product along the last axis."""
    ones = jnp.ones_like(t[..., :1])
    prefix = jnp.concatenate([ones, jnp.cumprod(t[..., :-1], axis=-1)], axis=-1)
    rev = jnp.cumprod(t[..., ::-1], axis=-1)[..., ::-1]
    suffix = jnp.concatenate([rev[..., 1:], ones], axis=-1)
    return prefix * suffix


def _signs(x: jax.Array) -> jax.Array:
    return jnp.where(x < 0, -1.0, 1.0).astype(x.dtype)


def exclusive_combine(values, op):
    """Exclusive prefix/suffix combine of a static list (leave-one-out).

    ``None`` marks the symbolic identity. Shared by the QC kernel and the
    jnp layered decoder so both evaluate float reductions in the SAME
    association order -- a precondition for bit-identical results.
    """

    def op2(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return op(a, b)

    d = len(values)
    prefix = [None] * d
    suffix = [None] * d
    for i in range(1, d):
        prefix[i] = op2(prefix[i - 1], values[i - 1])
        suffix[d - 1 - i] = op2(suffix[d - i], values[d - i])
    return [op2(p, s) for p, s in zip(prefix, suffix)]


def check_degree_classes(layout):
    """Distinct check degrees of a graph: ``(deg_idx [m], degrees)``.

    ``degrees`` lists the distinct row degrees ascending; ``deg_idx[i]`` is
    row i's index into it. The degree axis of degree-specific min-sum
    weights ([T, D] alpha in make_decoder / learned_minsum) follows this
    order.
    """
    deg = np.sum(np.asarray(layout.chk_var) < layout.n, axis=1)
    degrees = sorted(int(d) for d in set(deg.tolist()))
    lookup = {d: i for i, d in enumerate(degrees)}
    return np.asarray([lookup[int(d)] for d in deg], np.int32), degrees


def resolve_alpha_schedule(alpha, variant, row_slots):
    """Validate a per-iteration alpha schedule against a QC graph.

    Returns ``(arr, class_of)``: ``arr`` is the float64 schedule ([T] or
    [T, D]) or None for a trace-time-constant scalar; ``class_of[bi]`` maps
    a base row to its column of a degree-specific [T, D] matrix (distinct
    check degrees ascending -- the same order as
    :func:`check_degree_classes`, so learned weights deploy to either decode
    path unchanged). Shared by the XLA layered decoder and the QC kernel
    (ldpc_tpu.ops.spa_pallas)."""
    if np.ndim(alpha) == 0:
        return None, None
    if variant != "normalized_minsum":
        raise ValueError(
            "per-iteration alpha requires variant='normalized_minsum'"
        )
    arr = np.asarray(alpha, np.float64)
    if arr.size == 0:
        raise ValueError(
            "alpha schedule is empty: need at least one per-iteration value"
        )
    if arr.ndim == 1:
        return arr, None
    if arr.ndim != 2:
        raise ValueError("alpha schedule must be scalar, [T] or [T, D]")
    degrees = sorted({len(r) for r in row_slots})
    if arr.shape[1] != len(degrees):
        raise ValueError(
            f"alpha has {arr.shape[1]} degree classes but the graph has "
            f"{len(degrees)} distinct check degrees {degrees}"
        )
    lookup = {d: i for i, d in enumerate(degrees)}
    return arr, [lookup[len(r)] for r in row_slots]


def minsum_excl_update(M: jax.Array, slot_valid: jax.Array, dtype):
    """Leave-one-out min-sum check update over the padded edge layout.

    Returns ``(excl_sign, excl_min)`` per slot of ``M`` [..., m, dc]. Shared
    by the decode loop and the differentiable unrolled decoder
    (ldpc_tpu.analysis.learned_minsum) so train and inference use the same
    forward. Padding magnitude is a large FINITE value: inf would turn a
    degree-1 check's extrinsic into inf and poison L - E with NaN.
    """
    pad_mag = jnp.asarray(1e30, dtype)
    sgn = jnp.where(slot_valid, _signs(M), jnp.ones((), dtype))
    mag = jnp.where(slot_valid, jnp.abs(M), pad_mag)
    # total sign via negative-count parity: exact, and no multiply chain
    neg = jnp.sum((sgn < 0).astype(jnp.int32), axis=-1, keepdims=True)
    total_sign = (1 - 2 * (neg % 2)).astype(dtype)
    excl_sign = total_sign * sgn  # sign in {+-1}: division == multiplication
    # two-min via value masks, not argmin+one_hot (masks are cheaper).
    # Tie semantics are identical:
    # a duplicated minimum means every min slot's exclusive min is still
    # min1 (min2 == min1 from the other duplicate).
    min1 = jnp.min(mag, axis=-1, keepdims=True)
    is_min = mag == min1
    multi = jnp.sum(is_min, axis=-1, keepdims=True) > 1
    min2 = jnp.min(jnp.where(is_min, pad_mag, mag), axis=-1, keepdims=True)
    excl_min = jnp.where(is_min & ~multi, min2, min1)
    return excl_sign, excl_min


def make_decoder(
    layout,
    info_pos: np.ndarray,
    max_iterations: int,
    variant: str = "spa",
    *,
    rule: str = "exact",
    alpha: float = 0.75,
    beta: float = 0.15,
    dtype=jnp.float32,
    early_exit: bool = True,
    quantize_msgs=None,
):
    """Build ``decode(llr: [B, n]) -> DecodeResult`` over an EdgeLayout.

    Input LLRs follow the reference channel's convention LLR > 0 <=> bit 1
    (channel.py:80).

    ``rule`` selects the check-node sign convention:
      'exact'  -- the mathematically correct SPA: messages are converted to
                  the log(p0/p1) domain internally, where the plain tanh
                  product rule implements the parity constraint for any check
                  degree.
      'legacy' -- the reference's update (spa_decoder.py:106-168): the plain
                  product rule applied directly to log(p1/p0) messages. This
                  is only a correct parity update for EVEN-degree checks (it
                  effectively decodes the complement word); for odd-degree
                  checks the extrinsic sign is inverted. Kept for bit-level
                  parity with the reference, whose own results rely on it.

    ``info_pos`` int32 [k]: codeword positions of the info bits (for the
    normalized-LLR metric and downstream BER accounting).
    ``early_exit``: use a while_loop that stops when all codewords converged
    (host semantics identical either way; fixed-trip fori_loop variant is
    useful for benchmarking steady-state iteration cost).
    ``quantize_msgs``: optional elementwise fn applied to the var->check
    messages at the start of every iteration -- the hook for message
    precision studies (bf16 rounding, int8 min-sum grids).
    """
    variant = variant.lower().replace("-", "_")
    if variant in ("bitflipping", "bit_flipping"):
        return make_bitflip_decoder(layout, info_pos, max_iterations)
    if rule not in ("exact", "legacy"):
        raise ValueError(f"Unknown check-node rule: {rule}")

    n, m, dc, dv = layout.n, layout.m, layout.dc, layout.dv
    chk_var = jnp.asarray(layout.chk_var)  # [m, dc] pad = n
    var_edge = jnp.asarray(layout.var_edge)  # [n, dv] pad = m*dc
    slot_valid = jnp.asarray(layout.chk_var < layout.n)  # [m, dc]
    info_pos = jnp.asarray(np.asarray(info_pos, dtype=np.int32))
    k = info_pos.shape[0]
    prod_clip = _prod_clip(dtype)

    # per-iteration normalized-min-sum weights (learned schedules,
    # ldpc_tpu.analysis.learned_minsum): alpha may be a length-T vector
    # applied as alpha[min(it, T-1)], or a [T, D] matrix of degree-specific
    # weights (D = distinct check degrees, ascending; arXiv:2107.04221).
    # A scalar keeps the original trace-time-constant path (bit-identical,
    # Pallas-eligible).
    alpha_seq = None
    deg_idx = None
    if np.ndim(alpha) > 0:
        if variant != "normalized_minsum":
            raise ValueError(
                "per-iteration alpha requires variant='normalized_minsum'"
            )
        alpha_seq = jnp.asarray(alpha, dtype)
        if alpha_seq.ndim == 2:
            idx, degrees = check_degree_classes(layout)
            if alpha_seq.shape[1] != len(degrees):
                raise ValueError(
                    f"alpha has {alpha_seq.shape[1]} degree classes but the "
                    f"graph has {len(degrees)} distinct check degrees "
                    f"{degrees}"
                )
            deg_idx = jnp.asarray(idx)

    def check_node_update(M: jax.Array, alpha_t=None) -> jax.Array:
        if variant == "spa":
            t = jnp.tanh(jnp.clip(M / 2.0, -TANH_IN_CLIP, TANH_IN_CLIP))
            t = jnp.clip(t, -prod_clip, prod_clip)
            t = jnp.where(slot_valid, t, jnp.ones((), dtype))
            prod = _exclusive_prod(t)
            prod = jnp.clip(prod, -prod_clip, prod_clip)
            # 2*atanh(p) in log form -- the same expression as the QC kernel
            # (ldpc_tpu.ops.spa_pallas) and the XLA layered decoder
            return jnp.log((1.0 + prod) / (1.0 - prod))
        excl_sign, excl_min = minsum_excl_update(M, slot_valid, dtype)
        if variant == "normalized_minsum":
            excl_min = (alpha if alpha_t is None else alpha_t) * excl_min
        elif variant == "offset_minsum":
            excl_min = jnp.maximum(excl_min - beta, 0.0)
        elif variant != "minsum":
            raise ValueError(f"Unknown decoder variant: {variant}")
        return excl_sign * excl_min

    # 'exact': negate into the log(p0/p1) domain where the product rule is the
    # true parity update; hard decision there is bit 1 <=> L < 0. 'legacy'
    # keeps the reference's log(p1/p0) messages and its z^1 = (L >= 0) rule.
    conv_sign = -1.0 if rule == "exact" else 1.0

    def decode(llr: jax.Array, skip: jax.Array | None = None) -> DecodeResult:
        llr = conv_sign * llr.astype(dtype)
        B = llr.shape[0]
        llr_pad = jnp.pad(llr, ((0, 0), (0, 1)))  # sentinel var n -> 0
        M0 = jnp.take(llr_pad, chk_var, axis=1)  # [B, m, dc]

        # ``skip`` (traced bool scalar): start with every codeword marked
        # done, so the while loop exits before iteration 0 -- lets a vmapped
        # sweep stop paying for SNR points that already reached their error
        # quota (outputs of a skipped call are discarded by the caller)
        done0 = (
            jnp.zeros((B,), bool) if skip is None
            else jnp.broadcast_to(jnp.asarray(skip, bool), (B,))
        )
        init = (
            jnp.int32(0),
            M0,
            done0,  # done
            jnp.zeros((B, n), jnp.uint8),  # est
            jnp.full((B,), -1, jnp.int32),  # conv_iter
            llr,  # prior posterior (starts at channel LLRs, spa_decoder.py:95)
            jnp.zeros((B,), dtype),  # norm_llr
        )

        def cond(state):
            it, _, done, *_ = state
            running = it < max_iterations
            if early_exit:
                running = running & ~jnp.all(done)
            return running

        def body(state):
            it, M, done, est, conv, prior, norm_llr = state
            active = ~done

            if quantize_msgs is not None:
                M = quantize_msgs(M)
            if alpha_seq is None:
                a_t = None
            else:
                a_t = alpha_seq[jnp.minimum(it, alpha_seq.shape[0] - 1)]
                if deg_idx is not None:
                    # degree-specific: one weight per check row, broadcast
                    # over the batch and slot axes of excl_min [B, m, dc]
                    a_t = a_t[deg_idx][None, :, None]
            E = check_node_update(M, a_t)
            E = jnp.where(slot_valid, E, jnp.zeros((), dtype))

            # posterior: L = llr + sum of incoming E per variable
            E_flat = E.reshape(B, m * dc)
            E_flat = jnp.pad(E_flat, ((0, 0), (0, 1)))  # sentinel edge -> 0
            E_in = jnp.take(E_flat, var_edge, axis=1)  # [B, n, dv]
            if dv <= SEQ_SUM_MAX_DV:
                # summed left to right from llr in var_edge order (ascending
                # check index): the association of the QC kernel, so the
                # two agree bit for bit on every backend
                L = llr
                for j in range(dv):
                    L = L + E_in[..., j]
            else:  # dense graphs: one reduction
                L = llr + jnp.sum(E_in, axis=-1)

            if rule == "exact":
                est_bit = (L < 0).astype(jnp.uint8)  # log(p0/p1) < 0 <=> bit 1
            else:
                est_bit = (L >= 0).astype(jnp.uint8)  # z ^ 1 (spa_decoder.py:188-192)

            # syndrome on est_bit over the decode graph
            est_pad = jnp.pad(est_bit, ((0, 0), (0, 1)))
            par = jnp.sum(
                jnp.take(est_pad, chk_var, axis=1).astype(jnp.int32), axis=-1
            ) % 2  # [B, m]
            ok_now = jnp.all(par == 0, axis=-1)

            # normalized-LLR bookkeeping on info bits
            L_info = jnp.take(L, info_pos, axis=1)
            prior_info = jnp.take(prior, info_pos, axis=1)
            flips = (jnp.abs(L_info) <= LLR_WINDOW) & (prior_info * L_info < 0)
            nl = jnp.sum(flips, axis=-1).astype(dtype) / max(k, 1)

            # freeze outputs of codewords that were already done
            est = jnp.where(active[:, None], est_bit, est)
            conv = jnp.where(active & ok_now, it, conv)
            norm_llr = jnp.where(active, nl, norm_llr)
            done = done | ok_now

            # variable-node update for the next iteration
            L_pad = jnp.pad(L, ((0, 0), (0, 1)))
            M_next = jnp.take(L_pad, chk_var, axis=1) - E
            M = jnp.where(active[:, None, None], M_next, M)
            prior = jnp.where(active[:, None], L, prior)

            return (it + 1, M, done, est, conv, prior, norm_llr)

        it, _, done, est, conv, _, norm_llr = jax.lax.while_loop(cond, body, init)
        return DecodeResult(
            ok=done, est=est, conv_iter=conv, norm_llr=norm_llr, iters_run=it
        )

    return decode


def make_bitflip_decoder(layout, info_pos: np.ndarray, max_iterations: int):
    """Gallager-B hard-decision bit-flipping decoder.

    The reference exposes --decoder bitflipping but unconditionally constructs
    the SPA (`main.py:464` vs `main.py:78`); this is a real implementation:
    each iteration flips every bit for which more than half of its parity
    checks are unsatisfied, until the syndrome clears.
    """
    n, m, dc = layout.n, layout.m, layout.dc
    chk_var = jnp.asarray(layout.chk_var)
    var_deg = jnp.asarray(layout.var_deg)
    # check id per variable slot; padding slots point at sentinel check m
    edge_chk = np.arange(m * dc, dtype=np.int32) // dc
    var_chk_np = np.full_like(layout.var_edge, m)
    valid = layout.var_edge < m * dc
    var_chk_np[valid] = edge_chk[layout.var_edge[valid]]
    var_chk = jnp.asarray(var_chk_np)  # [n, dv]

    def decode(llr: jax.Array, skip: jax.Array | None = None) -> DecodeResult:
        B = llr.shape[0]
        est0 = (llr >= 0).astype(jnp.uint8)

        def parity_of(est):
            est_pad = jnp.pad(est, ((0, 0), (0, 1)))
            return (
                jnp.sum(jnp.take(est_pad, chk_var, axis=1).astype(jnp.int32), axis=-1)
                % 2
            )

        done0 = (
            jnp.zeros((B,), bool) if skip is None
            else jnp.broadcast_to(jnp.asarray(skip, bool), (B,))
        )
        init = (
            jnp.int32(0),
            est0,
            done0,
            jnp.full((B,), -1, jnp.int32),
        )

        def cond(state):
            it, _, done, _ = state
            return (it < max_iterations) & ~jnp.all(done)

        def body(state):
            it, est, done, conv = state
            par = parity_of(est)  # [B, m]
            ok_now = jnp.all(par == 0, axis=-1)
            conv = jnp.where(~done & ok_now, it, conv)
            done_next = done | ok_now

            # unsatisfied-check count per variable; flip the argmax set
            # (classic Gallager bit-flipping: majority rules oscillate on
            # degree-1/2 variables of short codes)
            par_pad = jnp.pad(par, ((0, 0), (0, 1)))  # sentinel check -> 0
            unsat = jnp.sum(jnp.take(par_pad, var_chk, axis=1), axis=-1)  # [B, n]
            mu = jnp.max(unsat, axis=-1, keepdims=True)
            flip = (unsat == mu) & (mu > 0)
            est_next = jnp.where(flip, est ^ 1, est)
            est = jnp.where((done_next)[:, None], est, est_next)
            return (it + 1, est, done_next, conv)

        it, est, done, conv = jax.lax.while_loop(cond, body, init)
        # final syndrome check for codewords that flipped on the last
        # iteration: est has been through `it` flip rounds, so a clear
        # syndrome here converged at round `it` (the in-loop check records
        # `conv = r` for a syndrome clear entering round r)
        par = parity_of(est)
        ok_final = jnp.all(par == 0, axis=-1)
        conv = jnp.where(~done & ok_final, it, conv)
        done = done | ok_final
        B = llr.shape[0]
        return DecodeResult(
            ok=done,
            est=est,
            conv_iter=conv,
            norm_llr=jnp.zeros((B,), jnp.float32),
            iters_run=it,
        )

    return decode
