"""Quasi-cyclic SPA/min-sum decoder as a Pallas kernel for the GPU.

Route: Pallas with ``backend="triton"``. One program owns a tile of ``TB``
codewords and runs their whole decode -- every iteration, every layer, the
syndrome check and the early exit -- so a tile stops as soon as its own
codewords pass the syndrome, instead of waiting for the whole batch as the
XLA decoders (ldpc_tpu.ops.spa, ldpc_tpu.ops.layered) do.

Layout. Codewords are the minor axis. Channel LLRs, posteriors ``L`` and
extrinsics ``E`` live in device memory in a padded block layout
``[blocks, Zp, B]``: block ``j`` holds the ``Z`` rows of base column ``j``
(of base edge slot ``j`` for ``E``), padded to ``Zp``, the next power of two
(Triton block shapes are powers of two). Padding rows are masked out of
every load and store. A program's slice of ``L`` (``nb * Zp * TB * 4``
bytes) stays resident in L1/L2; ``E`` streams once per iteration.

Rolls. The QC message permutation factorizes into cyclic shifts of
``Z``-row circulants. Row ``z`` of ``roll(L[j], s)`` is row ``(z + s) % Z``
of ``L[j]``: a row-permuted load of contiguous ``TB``-float runs, so it
stays coalesced. The inverse roll is the same permutation applied to the
store. Rows written by other threads of the program are read only after a
barrier (``debug_barrier``); the interpreter runs a program sequentially,
so there the barrier is a no-op.

Arithmetic. The check update is ops.layered's own (``check_update_list``:
exclusive prefix/suffix combines, the reference's clipping constants), and
the update forms are the same (overwrite
``L := roll_inv(m + E')`` for single-diagonal layers, additive deltas for
multi-diagonal ones such as CCSDS '0+7'). Min-sum variants therefore agree
with ``ops.layered`` bit for bit; SPA's tanh and log lower through libdevice
here and through XLA's own approximations there, so SPA agrees only to the
last bits.

The kernel implements the 'exact' check-node rule (input LLRs are negated
into the log(p0/p1) domain outside); the reference's 'legacy' rule stays on
the XLA path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ldpc_tpu.models.qc import QCLayout
from ldpc_tpu.ops.layered import check_update_list
from ldpc_tpu.ops.spa import LLR_WINDOW, DecodeResult, resolve_alpha_schedule

VARIANTS = ("spa", "minsum", "normalized_minsum", "offset_minsum")

# Codewords per program. Row degrees of at least WIDE_ROW_DC run 16 warps,
# narrower rows 8. On an H100, layered SPA-12 decode alone per batch of
# 4096 (PERF.md): WiMAX (1152, 576), degree 7, best at 8x8; the n=9216
# Z=384 lift, degree 7, 8x8 59.1 ms against 8x16 78.3 and 8x32 95.4; WiMAX
# (2304, rate 5/6), degree 20, 8x16 5.3 ms against 8x8 6.8 and 16x8 10.0.
# Degrees 8-19 were not measured; the boundary splits the difference.
TILE_B = 8
WIDE_ROW_DC = 14


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclass(frozen=True)
class TilePlan:
    tile_b: int  # codewords per program (power of two)
    num_warps: int


def pick_tile(qc: QCLayout) -> TilePlan:
    """The kernel's tile for ``qc`` on the card (see :data:`WIDE_ROW_DC`)."""
    dc = max((len(r) for r in qc.row_slots()), default=1)
    return TilePlan(TILE_B, 16 if dc >= WIDE_ROW_DC else 8)


def _sched_at(vec: np.ndarray, it):
    """``vec[min(it, T-1)]`` as a traced f32 scalar via a select chain (the
    clamp-to-last default matches the XLA decoders' ``alpha[min(it, T-1)]``)."""
    a = jnp.float32(vec[-1])
    for t in range(len(vec) - 1):
        a = jnp.where(it == t, jnp.float32(vec[t]), a)
    return a


def check_layer_groups(layer_groups, schedule: str, row_slots, mb: int):
    """Validate paired layer groups; None means the serial order 0..mb-1.

    Rows of one group share no base column, so the kernel needs no barrier
    between them: one barrier per group instead of one per row."""
    if layer_groups is None:
        return [[bi] for bi in range(mb)]
    if schedule != "layered":
        raise ValueError("layer_groups requires schedule='layered'")
    flat = sorted(bi for g in layer_groups for bi in g)
    if flat != list(range(mb)):
        raise ValueError(
            f"layer_groups must partition base rows 0..{mb - 1}: "
            f"{layer_groups!r}"
        )
    for g in layer_groups:
        seen: set[int] = set()
        for bi in g:
            bjs = {bj for bj, _ in row_slots[bi]}
            if seen & bjs:
                raise ValueError(
                    f"layer group {g} rows share base columns "
                    f"{sorted(seen & bjs)} -- grouped rows must be disjoint "
                    "for serial-order equivalence"
                )
            seen |= bjs
    return [list(g) for g in layer_groups]


def make_qc_decoder(
    qc: QCLayout,
    info_pos: np.ndarray,
    max_iterations: int,
    variant: str = "spa",
    *,
    alpha: float = 0.75,
    beta: float = 0.15,
    schedule: str = "flooding",
    track_norm: bool = True,
    layer_groups: list[list[int]] | None = None,
    tile_b: int | None = None,
    interpret: bool = False,
    mesh: jax.sharding.Mesh | None = None,
    batch_axes: tuple[str, ...] = (),
):
    """Build ``decode(llr: f32 [B, n], skip=None) -> DecodeResult``.

    ``llr`` follows the channel convention (LLR > 0 <=> bit 1). Outputs
    match the XLA decoders: ``conv_iter`` is the 0-based iteration whose
    post-iteration syndrome cleared, converged codewords are frozen, and
    ``iters_run`` is the largest trip count over the batch's tiles.

    ``schedule``: 'flooding' or 'layered' (serial-C over base rows);
    ``layer_groups`` (layered only) are disjoint-support row groups whose
    flattened order is the sweep order (models.qc.paired_layer_groups).
    ``track_norm=False`` elides the normalized-LLR bookkeeping and its
    ``prior`` buffer (``norm_llr`` is then zeros). ``tile_b`` overrides
    the codewords per program of :func:`pick_tile` (interpreter tests run
    small tiles); the warps stay the plan's. ``interpret=True`` runs the
    Pallas interpreter (for tests on the CPU; nothing selects it from the
    backend). With ``mesh``, each device decodes its shard of the batch
    under ``jax.shard_map`` over ``batch_axes`` (``pallas_call`` is opaque
    to the SPMD partitioner).
    """
    variant = variant.lower().replace("-", "_")
    if variant not in VARIANTS:
        raise ValueError(f"QC kernel does not support variant {variant!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"Unknown schedule: {schedule!r}")

    n, Z, nb, mb = qc.n, qc.Z, qc.nb, qc.mb
    Zp = next_pow2(Z)
    row_slots = qc.row_slots()
    col_slots = qc.col_slots()
    groups = check_layer_groups(layer_groups, schedule, row_slots, mb)
    alpha_arr, alpha_class = resolve_alpha_schedule(alpha, variant, row_slots)
    # per base column: its circulants grouped by base row (a multi-diagonal
    # block puts several on one column)
    by_row = []
    for entries in col_slots:
        grps: dict[int, list[tuple[int, int, int]]] = {}
        for e in entries:
            grps.setdefault(e[0], []).append(e)
        by_row.append(list(grps.values()))
    row_off = np.concatenate([[0], np.cumsum([len(r) for r in row_slots])])
    e_slots = int(row_off[-1])
    # multi-diagonal layers accumulate their deltas through a one-block
    # buffer (layered only: flooding sums every circulant in the posterior)
    need_delta = schedule == "layered" and any(
        len({bj for bj, _ in r}) < len(r) for r in row_slots
    )
    plan = pick_tile(qc)
    TB = int(tile_b or plan.tile_b)
    if TB < 1 or TB & (TB - 1):
        raise ValueError(f"tile_b must be a power of two: {TB}")
    k = int(np.asarray(info_pos).shape[0])
    info_mask = np.zeros((nb, Zp), np.float32)
    ip = np.asarray(info_pos, np.int64)
    info_mask[ip // Z, ip % Z] = 1.0
    mask_const = info_mask.reshape(-1)
    barrier = (lambda: None) if interpret else plgpu.debug_barrier

    def alpha_of(it):
        """bi -> the normalized-min-sum weight at iteration ``it``."""
        if alpha_arr is None:
            return lambda bi: alpha
        if alpha_arr.ndim == 1:
            a = _sched_at(alpha_arr, it)
            return lambda bi: a
        cols = [_sched_at(alpha_arr[:, c], it)
                for c in range(alpha_arr.shape[1])]
        return lambda bi: cols[alpha_class[bi]]

    def kernel(done0_ref, llr_ref, mask_ref, L_ref, E_ref, ok_ref, conv_ref,
               norm_ref, iters_ref, *extra):
        prior_ref = extra[0] if track_norm else None
        D_ref = extra[-1] if need_delta else None
        Bp = llr_ref.shape[0] // (nb * Zp)
        z = jnp.arange(Zp, dtype=jnp.int32)[:, None]  # [Zp, 1]
        lane = (pl.program_id(0) * TB
                + jnp.arange(TB, dtype=jnp.int32))[None, :]  # [1, TB]
        rows = jnp.broadcast_to(z < Z, (Zp, TB))

        def off(block: int, s: int = 0):
            """Offsets of rows (z + s) % Z of ``block`` for this tile."""
            s %= Z
            r = z
            if s:
                r = jnp.where(z < Z - s, z + s, jnp.where(z < Z, z + s - Z, z))
            return (block * Zp + r) * Bp + lane

        def ld(ref, block, s=0):
            return plgpu.load(ref.at[off(block, s)], mask=rows, other=0.0)

        def st(ref, block, val, s=0, where=None):
            m = rows if where is None else rows & where
            plgpu.store(ref.at[off(block, s)], val, mask=m)

        def check_phase_flooding(a_of, active):
            for bi in range(mb):
                slots = row_slots[bi]
                msgs = [ld(L_ref, bj, s) - ld(E_ref, row_off[bi] + j)
                        for j, (bj, s) in enumerate(slots)]
                for j, e in enumerate(
                        check_update_list(msgs, variant, a_of(bi), beta)):
                    st(E_ref, row_off[bi] + j, e, where=active)
            barrier()
            for bj in range(nb):
                acc = ld(llr_ref, bj)
                for grp in by_row[bj]:
                    vals = [ld(E_ref, row_off[bi] + j, -s) for bi, j, s in grp]
                    for v in in_check_order(vals, [s for _, _, s in grp]):
                        acc = acc + v
                st(L_ref, bj, acc)
            barrier()

        def in_check_order(vals, shifts):
            """Order the circulants one base row puts on a column by their
            check row (z - s) % Z, per row z -- the order in which ops.spa
            sums a variable's messages (one circulant: nothing to do)."""
            keys = [jnp.where(z >= s % Z, z - s % Z, z - s % Z + Z)
                    for s in shifts]
            vals = list(vals)
            for i in range(len(vals)):
                for j in range(len(vals) - 1 - i):
                    swap = keys[j] > keys[j + 1]
                    vals[j], vals[j + 1] = (jnp.where(swap, vals[j + 1], vals[j]),
                                            jnp.where(swap, vals[j], vals[j + 1]))
                    keys[j], keys[j + 1] = (jnp.where(swap, keys[j + 1], keys[j]),
                                            jnp.where(swap, keys[j], keys[j + 1]))
            return vals

        def write_delta_layer(bi, slots, e_old, e_new, active):
            """Multi-diagonal layer: L[bj] += sum of the rolled deltas of
            every circulant on bj, summed in slot order like ops.layered."""
            by_col: dict[int, list[tuple[int, int]]] = {}
            for j, (bj, s) in enumerate(slots):
                by_col.setdefault(bj, []).append((j, s))
            for bj, lst in by_col.items():
                if len(lst) == 1:
                    j, s = lst[0]
                    st(L_ref, bj, ld(L_ref, bj, s) + (e_new[j] - e_old[j]), s,
                       where=active)
                    continue
                j, s = lst[0]
                st(D_ref, 0, e_new[j] - e_old[j], s)
                for j, s in lst[1:]:
                    barrier()
                    st(D_ref, 0, ld(D_ref, 0, s) + (e_new[j] - e_old[j]), s)
                barrier()
                st(L_ref, bj, ld(L_ref, bj) + ld(D_ref, 0), where=active)
                barrier()

        def sweep_layered(a_of, active):
            for group in groups:
                work = []
                for bi in group:
                    slots = row_slots[bi]
                    e_old = [ld(E_ref, row_off[bi] + j)
                             for j in range(len(slots))]
                    msgs = [ld(L_ref, bj, s) - e_old[j]
                            for j, (bj, s) in enumerate(slots)]
                    e_new = check_update_list(msgs, variant, a_of(bi), beta)
                    work.append((bi, slots, e_old, msgs, e_new))
                barrier()  # every read of this group precedes its writes
                for bi, slots, e_old, msgs, e_new in work:
                    if len({bj for bj, _ in slots}) < len(slots):
                        write_delta_layer(bi, slots, e_old, e_new, active)
                    else:
                        for j, (bj, s) in enumerate(slots):
                            st(L_ref, bj, msgs[j] + e_new[j], s, where=active)
                    for j in range(len(slots)):
                        st(E_ref, row_off[bi] + j, e_new[j], where=active)
                barrier()

        def syndrome_ok():
            unsat = jnp.zeros((1, TB), jnp.float32)
            for bi in range(mb):
                parity = None
                for bj, s in row_slots[bi]:
                    bit = ld(L_ref, bj, s) < 0
                    parity = bit if parity is None else parity ^ bit
                if parity is not None:
                    unsat = jnp.maximum(unsat, jnp.max(
                        parity.astype(jnp.float32), axis=0, keepdims=True))
            return unsat < 0.5

        def flip_fraction():
            flips = jnp.zeros((1, TB), jnp.float32)
            for bj in range(nb):
                Lv = ld(L_ref, bj)
                f = (jnp.abs(Lv) <= LLR_WINDOW) & (ld(prior_ref, bj) * Lv < 0)
                m = plgpu.load(mask_ref.at[bj * Zp + z])
                flips = flips + jnp.sum(f.astype(jnp.float32) * m, axis=0,
                                        keepdims=True)
                st(prior_ref, bj, Lv)
            return flips / max(k, 1)

        # init: posterior = channel LLRs, extrinsics = 0
        for bj in range(nb):
            v = ld(llr_ref, bj)
            st(L_ref, bj, v)
            if track_norm:
                st(prior_ref, bj, v)
        zero = jnp.zeros((Zp, TB), jnp.float32)
        for e in range(e_slots):
            st(E_ref, e, zero)
        barrier()

        def body(carry):
            it, done_f, conv, norm = carry
            active = done_f < 0.5
            barrier()  # the last iteration's syndrome reads precede writes
            a_of = alpha_of(it)
            if schedule == "flooding":
                check_phase_flooding(a_of, active)
            else:
                sweep_layered(a_of, active)
            ok_now = syndrome_ok()
            if track_norm:
                norm = jnp.where(active, flip_fraction(), norm)
            conv = jnp.where(active & ok_now, it, conv)
            done_f = jnp.maximum(done_f, ok_now.astype(jnp.float32))
            return it + 1, done_f, conv, norm

        def cond(carry):
            it, done_f, _, _ = carry
            return (it < max_iterations) & (jnp.min(done_f) < 0.5)

        done0 = plgpu.load(done0_ref.at[lane])
        init = (
            jnp.int32(0),
            done0,
            jnp.full((1, TB), -1, jnp.int32),
            jnp.zeros((1, TB), jnp.float32),
        )
        it, done_f, conv, norm = jax.lax.while_loop(cond, body, init)
        plgpu.store(ok_ref.at[lane], done_f)
        plgpu.store(conv_ref.at[lane], conv)
        plgpu.store(norm_ref.at[lane], norm)
        # a lane's trip count is its tile's, or 0 if it started done (a
        # skipped SNR point sharing the tile ran no iteration of its own)
        plgpu.store(iters_ref.at[lane], jnp.where(done0 < 0.5, it, 0))

    def decode_lanes_impl(llr, done0):
        """llr f32 [B, n], done0 f32 [B] -> per-codeword
        (est u8 [B, n], ok bool, conv i32, norm f32, iters i32)."""
        B = llr.shape[0]
        Bp = -(-B // TB) * TB
        if max(e_slots, nb) * Zp * Bp >= 2**31:
            raise ValueError("QC kernel: batch too large for int32 offsets")
        x = -llr.astype(jnp.float32).reshape(B, nb, Z)
        x = jnp.pad(x, ((0, Bp - B), (0, 0), (0, Zp - Z)))
        x = x.transpose(1, 2, 0).reshape(-1)
        # padding codewords start done: they never hold a tile's loop open
        d0 = jnp.pad(done0.astype(jnp.float32), (0, Bp - B),
                     constant_values=1.0)
        f32 = jnp.float32
        out_shape = [
            jax.ShapeDtypeStruct((nb * Zp * Bp,), f32),  # L (posteriors)
            jax.ShapeDtypeStruct((e_slots * Zp * Bp,), f32),  # E
            jax.ShapeDtypeStruct((Bp,), f32),  # ok
            jax.ShapeDtypeStruct((Bp,), jnp.int32),  # conv
            jax.ShapeDtypeStruct((Bp,), f32),  # norm
            jax.ShapeDtypeStruct((Bp,), jnp.int32),  # trips per lane
        ]
        if track_norm:
            out_shape.append(jax.ShapeDtypeStruct((nb * Zp * Bp,), f32))
        if need_delta:
            out_shape.append(jax.ShapeDtypeStruct((Zp * Bp,), f32))
        outs = pl.pallas_call(
            kernel,
            out_shape=out_shape,
            grid=(Bp // TB,),
            in_specs=[pl.BlockSpec()] * 3,
            out_specs=[pl.BlockSpec()] * len(out_shape),
            compiler_params=plgpu.CompilerParams(
                num_warps=plan.num_warps, num_stages=1
            ),
            backend="triton",
            interpret=interpret,
            name="qc_decode",
        )(d0, x, jnp.asarray(mask_const))
        L, _, ok, conv, norm, iters = outs[:6]
        L = L.reshape(nb, Zp, Bp)[:, :Z, :B].transpose(2, 0, 1)
        est = (L.reshape(B, n) < 0).astype(jnp.uint8)
        return est, ok[:B] > 0.5, conv[:B], norm[:B], iters[:B]

    lanes_cv = jax.custom_batching.custom_vmap(decode_lanes_impl)

    @lanes_cv.def_vmap
    def _decode_lanes_vmap(axis_size, in_batched, llr, done0):
        # a vmapped call (the parallel SNR sweep) is one flat batch of
        # axis_size * B codewords: each codeword's decode is independent of
        # which tile it shares
        llr_b, done_b = in_batched
        if not llr_b:
            llr = jnp.broadcast_to(llr, (axis_size,) + llr.shape)
        if not done_b:
            done0 = jnp.broadcast_to(done0, (axis_size,) + done0.shape)
        S, B = llr.shape[:2]
        outs = lanes_cv(llr.reshape(S * B, n), done0.reshape(S * B))
        return (tuple(o.reshape((S, B) + o.shape[1:]) for o in outs),
                (True,) * 5)

    decode_lanes = lanes_cv
    if mesh is not None and batch_axes:
        PS = jax.sharding.PartitionSpec
        spec = PS(batch_axes)
        decode_lanes = jax.shard_map(
            decode_lanes, mesh=mesh, in_specs=(spec, spec),
            out_specs=(spec,) * 5, check_vma=False,
        )

    def decode(llr: jax.Array, skip: jax.Array | None = None) -> DecodeResult:
        B = llr.shape[0]
        done0 = (
            jnp.zeros((B,), jnp.float32) if skip is None
            else jnp.broadcast_to(jnp.asarray(skip, jnp.float32), (B,))
        )
        est, ok, conv, norm, iters = decode_lanes(llr, done0)
        return DecodeResult(ok=ok, est=est, conv_iter=conv, norm_llr=norm,
                            iters_run=jnp.max(iters))

    return decode
