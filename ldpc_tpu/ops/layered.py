"""Layered (serial-C / row-layered) QC-LDPC decoding in pure jnp.

The reference implements only the flooding schedule (`spa_decoder.py:63-280`).
Layered decoding sweeps check-node layers sequentially within one iteration,
updating the posterior in place after each layer, so information propagates
across the graph within a single pass -- it reaches a given FER in roughly
half the iterations of flooding (standard result; measured in
tests/test_layered.py).

For a quasi-cyclic code each BASE ROW is a natural layer, and the layer sweep
is a static Python loop over ``mb`` base rows of roll + elementwise math --
the same TPU-friendly structure as the flooding kernel
(ldpc_tpu.ops.spa_pallas). Single-circulant layers update the posterior by
overwrite (L := roll(m + E')); layers with multi-diagonal blocks (one base
row touching a base column at two shifts, e.g. CCSDS '0+7') use the
algebraically-equivalent additive form L += roll(E' - E) so both circulants'
extrinsic deltas accumulate instead of the second overwriting the first.

Update per layer bi, slot j (variable block c(bi,j), shift s):
    m_j   = roll(L[c], s) - E[bi, j]          # extrinsic prior
    E'    = check_update(m_1..m_d)            # same SPA/min-sum rules
    L[c] := roll_inv(m_j + E'_j);  E[bi, j] := E'_j

This module is the executable specification: a vmapped jnp implementation
used directly on CPU/TPU and as the bit-exactness reference for the fused
Pallas kernel's layered schedule.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.models.qc import QCLayout
from ldpc_tpu.ops.spa import (
    LLR_WINDOW,
    PROD_CLIP_F32,
    TANH_IN_CLIP,
    DecodeResult,
    _signs,
    exclusive_combine,
    resolve_alpha_schedule,
)


def check_update_list(msgs, variant, alpha, beta):
    """Leave-one-out check update over a static list of equal-shape arrays.

    Shared with the QC kernel (ldpc_tpu.ops.spa_pallas), so both evaluate
    the same float expressions in the same association order
    (``exclusive_combine``) -- the precondition for their bit-identity.
    ``alpha`` may be a traced scalar (per-iteration schedules).
    """
    if variant == "spa":
        ts = [
            jnp.clip(
                jnp.tanh(jnp.clip(m * 0.5, -TANH_IN_CLIP, TANH_IN_CLIP)),
                -PROD_CLIP_F32,
                PROD_CLIP_F32,
            )
            for m in msgs
        ]
        out = []
        for j, prod in enumerate(exclusive_combine(ts, lambda a, b: a * b)):
            if prod is None:
                prod = jnp.ones_like(msgs[j])
            prod = jnp.clip(prod, -PROD_CLIP_F32, PROD_CLIP_F32)
            out.append(jnp.log((1.0 + prod) / (1.0 - prod)))
        return out
    # min-sum family
    sgns = [_signs(m) for m in msgs]
    mags = [jnp.abs(m) for m in msgs]
    excl_sgn = exclusive_combine(sgns, lambda a, b: a * b)
    excl_mag = exclusive_combine(mags, jnp.minimum)
    out = []
    for j, (sgn, mag) in enumerate(zip(excl_sgn, excl_mag)):
        if sgn is None:
            sgn, mag = jnp.ones_like(msgs[j]), jnp.full_like(msgs[j], 1e30)
        if variant == "normalized_minsum":
            mag = alpha * mag
        elif variant == "offset_minsum":
            mag = jnp.maximum(mag - beta, 0.0)
        elif variant != "minsum":
            raise ValueError(f"Unknown decoder variant: {variant}")
        out.append(sgn * mag)
    return out


def make_qc_layered_decoder(
    qc: QCLayout,
    info_pos: np.ndarray,
    max_iterations: int,
    variant: str = "spa",
    *,
    alpha: float = 0.75,
    beta: float = 0.15,
    layer_order: list[int] | None = None,
):
    """Build ``decode(llr: f32 [B, n]) -> DecodeResult`` (layered schedule).

    LLR convention and outputs match the flooding decoders: input LLR > 0 <=>
    bit 1, exact parity rule, conv_iter is the 0-based iteration (one
    iteration = one full sweep over all layers) whose post-sweep syndrome
    cleared.

    ``layer_order`` permutes the serial sweep over base rows (default
    0..mb-1). The Pallas kernel's paired-layer schedule
    (models.qc.paired_layer_groups) is arithmetic-identical to the serial
    sweep in its FLATTENED group order, so passing that order here pins
    bit-parity with the paired kernel (tests/test_pallas.py).
    """
    variant = variant.lower().replace("-", "_")
    n, Z, nb, mb = qc.n, qc.Z, qc.nb, qc.mb
    order = list(range(mb)) if layer_order is None else list(layer_order)
    if sorted(order) != list(range(mb)):
        raise ValueError(
            f"layer_order must permute base rows 0..{mb - 1}: {order!r}"
        )
    row_slots = qc.row_slots()
    info_pos = jnp.asarray(np.asarray(info_pos, dtype=np.int32))
    k = max(int(info_pos.shape[0]), 1)
    dcb = max((len(r) for r in row_slots), default=1)

    # per-iteration / degree-specific normalized-min-sum schedules ([T] or
    # [T, D] alpha) -- same semantics as ldpc_tpu.ops.spa.make_decoder and
    # the Pallas layered kernel (bit-identity: tests/test_pallas.py)
    alpha_arr, alpha_class = resolve_alpha_schedule(alpha, variant, row_slots)
    alpha_seq = (
        None if alpha_arr is None else jnp.asarray(alpha_arr, jnp.float32)
    )

    def roll(x, s):  # y[r] = x[(r + s) % Z] along the last axis
        return jnp.roll(x, -s, axis=-1)

    def unroll(x, s):
        return jnp.roll(x, s, axis=-1)

    def decode(llr: jax.Array, skip: jax.Array | None = None) -> DecodeResult:
        llr = -llr.astype(jnp.float32)  # exact rule: log(p0/p1) domain
        B = llr.shape[0]
        L0 = llr.reshape(B, nb, Z)

        # skip=True starts every codeword done: the while loop exits before
        # iteration 0 (see ldpc_tpu.ops.spa.make_decoder)
        done0 = (
            jnp.zeros((B,), bool) if skip is None
            else jnp.broadcast_to(jnp.asarray(skip, bool), (B,))
        )
        init = (
            jnp.int32(0),
            L0,
            jnp.zeros((B, mb, dcb, Z), jnp.float32),  # E
            done0,  # done
            jnp.zeros((B, n), jnp.uint8),  # est
            jnp.full((B,), -1, jnp.int32),  # conv_iter
            L0,  # prior posterior
            jnp.zeros((B,), jnp.float32),  # norm_llr
        )

        def cond(state):
            it, _, _, done, *_ = state
            return (it < max_iterations) & ~jnp.all(done)

        def body(state):
            it, L, E, done, est, conv, prior, norm = state
            active = ~done

            if alpha_seq is None:
                a_of = lambda bi: alpha  # noqa: E731
            else:
                a_row = alpha_seq[jnp.minimum(it, alpha_seq.shape[0] - 1)]
                if alpha_seq.ndim == 1:
                    a_of = lambda bi: a_row  # noqa: E731
                else:
                    a_of = lambda bi: a_row[alpha_class[bi]]  # noqa: E731

            for bi in order:
                slots = row_slots[bi]
                msgs = [
                    roll(L[:, bj], s) - E[:, bi, j]
                    for j, (bj, s) in enumerate(slots)
                ]
                e_new = check_update_list(msgs, variant, a_of(bi), beta)
                dup = len({bj for bj, _ in slots}) < len(slots)
                if dup:
                    # multi-diagonal layer (e.g. CCSDS '0+7'): a base row
                    # touches one base column at two shifts, so both
                    # circulants' extrinsic deltas must accumulate -- the
                    # overwrite form below would drop the first one. Delta
                    # order mirrors the Pallas kernel for bit-identity.
                    deltas: dict[int, jax.Array] = {}
                    for j, (bj, s) in enumerate(slots):
                        d = unroll(e_new[j] - E[:, bi, j], s)
                        deltas[bj] = d if bj not in deltas else deltas[bj] + d
                    for bj, d in deltas.items():
                        L = L.at[:, bj].set(
                            jnp.where(active[:, None], L[:, bj] + d, L[:, bj])
                        )
                else:
                    for j, (bj, s) in enumerate(slots):
                        l_new = unroll(msgs[j] + e_new[j], s)
                        L = L.at[:, bj].set(
                            jnp.where(active[:, None], l_new, L[:, bj])
                        )
                for j in range(len(slots)):
                    E = E.at[:, bi, j].set(
                        jnp.where(active[:, None], e_new[j], E[:, bi, j])
                    )

            L_flat = L.reshape(B, n)
            est_bit = (L_flat < 0).astype(jnp.uint8)

            # syndrome over the QC graph
            ok_now = jnp.ones((B,), bool)
            est_blk = est_bit.reshape(B, nb, Z)
            for bi in range(mb):
                parity = None
                for bj, s in row_slots[bi]:
                    b = roll(est_blk[:, bj], s).astype(jnp.int32)
                    parity = b if parity is None else parity ^ b
                if parity is None:
                    continue  # empty base row: trivially satisfied
                ok_now = ok_now & jnp.all(parity == 0, axis=-1)

            L_info = jnp.take(L_flat, info_pos, axis=1)
            prior_info = jnp.take(prior.reshape(B, n), info_pos, axis=1)
            flips = (jnp.abs(L_info) <= LLR_WINDOW) & (prior_info * L_info < 0)
            nl = jnp.sum(flips, axis=-1).astype(jnp.float32) / k

            est = jnp.where(active[:, None], est_bit, est)
            conv = jnp.where(active & ok_now, it, conv)
            norm = jnp.where(active, nl, norm)
            prior = jnp.where(active[:, None, None], L, prior)
            done = done | ok_now
            return (it + 1, L, E, done, est, conv, prior, norm)

        it, _, _, done, est, conv, _, norm = jax.lax.while_loop(cond, body, init)
        return DecodeResult(
            ok=done, est=est, conv_iter=conv, norm_llr=norm, iters_run=it
        )

    return decode
