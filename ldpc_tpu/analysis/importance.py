"""Importance-sampled FER estimation for the deep error-floor regime.

Plain Monte-Carlo needs ~100/FER frames per point: FER 1e-9 costs 1e11
frames (~10 hours of chip time at 2.7 M frames/s) and 1e-10 is out of
reach. This module estimates FER at those depths in minutes by biasing the
channel noise toward the KNOWN dominant error events -- the trapping-set
supports and minimum-distance codeword orbits surfaced by the census
machinery (ldpc_tpu.analysis.failures, examples/error_floor) -- and
unbiasing with likelihood-ratio weights.

Estimator: DEFENSIVE MIXTURE importance sampling. The proposal is

    q(n) = pi0 * p(n) + (1 - pi0)/M * sum_j N(n; D_j, sigma^2 I)

where p is the true AWGN density and each D_j is a mean shift that drags
the received word toward one error event: for a support T (bit positions,
original graph), D_j flips the transmitted symbols on T by
``shift * 2 * amp`` (shift = 0.5 lands exactly on the pairwise decision
boundary, the classic choice for codeword-distance events). Every cyclic
lift of every support is its own component (QC codes fail equivariantly
under the Z-fold shift automorphism), so the mixture covers each orbit
exactly rather than relying on one arbitrary representative.

Because the estimate is E_q[w * 1{fail}] with w = p/q for the FULL mixture,
it is unbiased for the TOTAL failure probability -- no per-event
bookkeeping, no double counting when one frame sits in two events' basins,
and the defensive p-component (pi0) bounds w <= 1/pi0 so failures outside
every known event cannot blow up the variance.

WHAT THE VARIANCE STATEMENT COVERS (read this before quoting a CI): the
shifted components give the KNOWN-EVENT failure contribution -- the error
FLOOR -- with tight CIs at any SNR. Failures outside every known event
(the waterfall "bulk") are sampled only by the defensive component at
plain-MC power: at sample sizes where the bulk produces zero defensive
hits, the estimate and its CI describe the floor component alone, and the
estimator is a rigorous LOWER bound on total FER. That is the intended
regime split: in the waterfall (<= 4.5 dB) plain MC measures the total
cheaply and IS isolates the floor beneath it; past the floor-takeover SNR
the two coincide. Cross-validation (scripts/importance_floor.py): the
UNDETECTED-error rate is a pure floor quantity plain MC can measure at
3.5-3.75 dB (examples/error_floor failure profiles), and the IS estimate
must continue that curve; the IS total must also stay <= plain MC's in the
overlap. Payoff region: 5-6.5 dB, floor FER 1e-8..1e-13.

Weight computation never forms q directly: with n = sigma*z + D_sel,

    w(n) = 1 / (pi0 + (1 - pi0)/M * sum_j exp((n . D_j - |D_j|^2 / 2) / sigma^2))

and the M dot products are one [B, n] x [n, M] matmul.

The IS step builds its own biased channel in XLA around the same decoder
the runner would pick (:func:`ldpc_tpu.sim.runner._select_decoder`). The
IS draws use jax.random.normal, which is tail-exact.

The reference simulator has no counterpart to any of this: at ~363 info
bits/s its 50-300-block sweeps resolve FER ~2e-2 (SURVEY.md section 6).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.models.code import LDPCCode
from ldpc_tpu.ops.channel import ChannelParams
from ldpc_tpu.ops.encode import make_encoder, random_info_bits
from ldpc_tpu.ops.metrics import block_stats
from ldpc_tpu.sim.config import SimOptions
from ldpc_tpu.sim.runner import _select_decoder


def orbit_supports(supports: list[list[int]], Z: int, n: int,
                   max_components: int | None = None) -> np.ndarray:
    """Expand base supports by the QC lift automorphism.

    Each support (original-graph bit indices) yields Z components: index
    (bj, r) -> (bj, (r + t) % Z) for t in [0, Z). Duplicate components
    (supports invariant under some shift) are dropped. Returns a dense
    [M, n] float32 matrix of 0/1 masks.
    """
    seen: set[tuple[int, ...]] = set()
    rows: list[np.ndarray] = []
    for sup in supports:
        sup = np.asarray(sorted(sup), np.int64)
        if sup.size == 0:
            continue
        bj, r = sup // Z, sup % Z
        for t in range(Z):
            shifted = tuple(sorted(bj * Z + (r + t) % Z))
            if shifted in seen:
                continue
            seen.add(shifted)
            mask = np.zeros(n, np.float32)
            mask[list(shifted)] = 1.0
            rows.append(mask)
            if max_components and len(rows) >= max_components:
                return np.stack(rows)
    if not rows:
        raise ValueError("no non-empty supports given")
    return np.stack(rows)


def census_supports(census_path: str, min_count: int = 2,
                    max_size: int = 16) -> list[list[int]]:
    """Pull shift targets out of a trapping-census / undetected-codewords
    JSON (examples/error_floor): every recorded exact support with
    ``count >= min_count`` or size <= max_size."""
    data = json.loads(open(census_path).read())
    out: list[list[int]] = []
    for entry in data.get("recurring_supports", []):
        sup = entry["support"] if isinstance(entry, dict) else entry
        if len(sup) <= max_size:
            out.append(list(sup))
    for entry in data.get("patterns", []):
        sup = entry.get("support") if isinstance(entry, dict) else entry
        if sup and len(sup) <= max_size:
            out.append(list(sup))
    return out


@dataclass
class ISResult:
    """One SNR point's importance-sampled estimates (all per-frame rates)."""

    snr_db: float
    frames: int
    fer: float  # detected failures (syndrome unsatisfied at max iters)
    fer_std: float
    wer: float  # any wrong delivery: detected OR undetected (exact)
    wer_std: float
    undetected: float  # syndrome-passing wrong codewords only
    undetected_std: float
    mean_weight: float  # E_q[w] ~ 1.0 is a consistency diagnostic
    max_weight: float
    fail_frames: int  # raw (unweighted) failing frames observed under q

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def make_is_step(code: LDPCCode, opts: SimOptions, shifts: np.ndarray,
                 *, pi0: float = 0.2, shift: float = 0.5,
                 return_resid: bool = False):
    """Build ``step(key, consts) -> per-frame (w, detected, wrong)``.

    ``shifts``: [M, n] 0/1 support masks (orbit_supports). Mode-1 BPSK
    exact-noise channel only -- the regime of the error-floor study.

    ``return_resid=True`` appends the residual error vectors
    ``est XOR transmitted`` (uint8 [B, n]) -- the depth-harvest hook: the
    failures the BIASED sampler produces at deep SNR are exactly the events
    a fixed-SNR plain-MC capture cannot see, so feeding their supports back
    into the dictionary closes the completeness loop
    (:func:`harvest_failures`).
    """
    opts = opts.resolved()
    if opts.mode != 1 or opts.modulation != 1:
        raise ValueError("importance sampling supports mode 1 / BPSK")
    if opts.noise_model != "exact":
        raise ValueError("importance sampling requires noise_model='exact'")
    if not 0.0 < pi0 < 1.0:
        raise ValueError("pi0 must be in (0, 1)")

    layout = code.layout(opts.decode_graph)
    spec = code.encode_spec(opts.encoding_method, opts.ru_gap)
    info_pos = np.asarray(spec.info_pos(opts.decode_graph)[: code.k],
                          np.int32)
    decode, kernel_used = _select_decoder(
        code, opts, layout, info_pos, opts.iterations
    )
    encode = make_encoder(spec, opts.decode_graph)

    M, n = shifts.shape
    assert n == code.n
    batch = opts.batch
    k = code.k
    # delta magnitude per shifted bit, in symbol units (amp = 1 for BPSK):
    # shift=0.5 moves the mean to the pairwise decision boundary
    delta_amp = 2.0 * shift
    shifts_T = jnp.asarray(shifts.T)  # [n, M]
    sup_sizes = jnp.asarray(shifts.sum(axis=1))  # [M]
    info_pos_j = jnp.asarray(info_pos)

    def step(key: jax.Array, consts):
        k_u, k_z, k_m = jax.random.split(key, 3)
        u = random_info_bits(k_u, batch, k)
        w_bits = encode(u).astype(jnp.float32)  # 0/1 [B, n]
        sym = 2.0 * w_bits - 1.0
        sigma = consts.noise1_std

        z = jax.random.normal(k_z, (batch, n), jnp.float32)
        # component selection: comp = -1 -> defensive unshifted draw
        r = jax.random.uniform(k_m, (batch,))
        comp = jnp.where(
            r < pi0,
            -1,
            jax.random.randint(jax.random.fold_in(k_m, 1), (batch,), 0, M),
        )
        sel = jax.nn.one_hot(jnp.maximum(comp, 0), M, dtype=jnp.float32)
        sel = sel * (comp >= 0)[:, None]  # zero row for defensive draws
        # shift drags the SUPPORT bits toward the flipped symbol
        d_sel = -(delta_amp) * sym * (sel @ shifts_T.T)  # [B, n]

        noise = sigma * z + d_sel
        y = sym + noise
        llr = consts.llr_scale * y

        # mixture weight: dot(n, D_j) for every component via one matmul.
        # D_j(frame) = -delta_amp * sym * mask_j (depends on the frame's
        # transmitted word), |D_j|^2 = delta_amp^2 * |T_j|
        nd = (noise * (-(delta_amp) * sym)) @ shifts_T  # [B, M]
        expo = (nd - 0.5 * delta_amp**2 * sup_sizes[None, :]) / (sigma**2)
        # log-sum-exp for stability: exponents reach +-50 at deep SNR
        m_max = jnp.max(expo, axis=1, keepdims=True)
        lse = m_max[:, 0] + jnp.log(jnp.sum(jnp.exp(expo - m_max), axis=1))
        q_over_p = pi0 + (1.0 - pi0) / M * jnp.exp(lse)
        w = 1.0 / q_over_p

        res = decode(llr)
        stats = block_stats(u, res, info_pos_j, exact=True)
        detected = ~res.ok
        wrong = detected | (stats.error_bits > 0)
        if return_resid:
            resid = res.est ^ w_bits.astype(res.est.dtype)
            return w, detected, wrong, resid
        return w, detected, wrong

    return jax.jit(step), kernel_used


def harvest_failures(code: LDPCCode, opts: SimOptions, shifts: np.ndarray,
                     snr_db: float, *, frames: int, pi0: float = 0.2,
                     shift: float = 0.5, max_support: int = 24,
                     min_count: int = 2, top: int | None = 64,
                     seed: int = 23, say=print) -> list[list[int]]:
    """Failure-residual supports harvested FROM the IS sampler itself.

    A dictionary captured at one plain-MC SNR misses events that only
    dominate deeper (larger supports with smaller pseudo-distance). The IS
    proposal at a deep SNR produces failures at usable rates, and each
    failing frame's residual support is a candidate event REGARDLESS of the
    component that proposed it (the decoder, not the proposal, decides what
    fails).

    Most biased-draw failures are one-off bulk residuals (a shifted draw
    that failed messily), not structural events; folding tens of thousands
    of singletons would dilute the mixture and force arbitrary component
    caps. The filter is RECURRENCE after QC-orbit canonicalization: an
    event family that matters at depth is hit through many shifts, so its
    canonical support recurs. Returns up to ``top`` supports (orbit
    representatives, ``0 < |support| <= max_support``) seen at least
    ``min_count`` times, most-recurrent first; drops are logged, never
    silent.
    """
    opts = opts.resolved()
    Z = code.qc.Z if code.qc is not None else 1
    step, _ = make_is_step(code, opts, shifts, pi0=pi0, shift=shift,
                           return_resid=True)
    consts = ChannelParams(
        mode=opts.mode, modulation=opts.modulation, speed=opts.speed,
        snr_db=snr_db, interference_snr_db=opts.interference_snr,
        p=opts.p, noise_model=opts.noise_model,
    ).consts()
    batch = opts.batch
    n_batches = -(-frames // batch)
    key = jax.random.fold_in(jax.random.key(seed), int(snr_db * 1000))

    from ldpc_tpu.models.qc import qc_orbit_canonical

    def canon(sup: np.ndarray) -> tuple[int, ...]:
        return qc_orbit_canonical(sup, Z)

    counts: dict[tuple[int, ...], int] = {}
    fails = 0
    oversize = 0
    empty = 0  # detected-only failures with est == transmitted
    for b in range(n_batches):
        _, _, wrong, resid = step(jax.random.fold_in(key, b), consts)
        wrong = np.asarray(wrong)
        if not wrong.any():
            continue
        fails += int(wrong.sum())
        for e in np.asarray(resid)[wrong]:
            sup = np.flatnonzero(e)
            if len(sup) == 0:
                empty += 1
                continue
            if len(sup) > max_support:
                oversize += 1
                continue
            c = canon(sup)
            counts[c] = counts.get(c, 0) + 1
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    keep = [list(s) for s, n in ranked if n >= min_count]
    dropped_single = len(ranked) - len(keep)
    if top is not None and len(keep) > top:
        dropped_tail = len(keep) - top
        keep = keep[:top]
    else:
        dropped_tail = 0
    say(f"  harvested {len(keep)} recurrent orbit supports at {snr_db:g} dB "
        f"({fails} failures / {n_batches * batch} IS frames; "
        f"{len(ranked)} distinct orbits, {dropped_single} below "
        f"min_count={min_count}, {dropped_tail} beyond top={top}, "
        f"{oversize} residuals over max_support={max_support}, "
        f"{empty} empty)")
    return keep


def estimate_point(
    code: LDPCCode,
    opts: SimOptions,
    snr_db: float,
    shifts: np.ndarray,
    *,
    frames: int,
    pi0: float = 0.2,
    shift: float = 0.5,
    seed: int = 0,
    step=None,
) -> ISResult:
    """Importance-sampled FER/WER at one SNR point over ``frames`` draws."""
    opts = opts.resolved()
    if step is None:
        step, _ = make_is_step(code, opts, shifts, pi0=pi0, shift=shift)
    consts = ChannelParams(
        mode=opts.mode, modulation=opts.modulation, speed=opts.speed,
        snr_db=snr_db, interference_snr_db=opts.interference_snr,
        p=opts.p, noise_model=opts.noise_model,
    ).consts()

    batch = opts.batch
    n_batches = -(-frames // batch)
    key = jax.random.fold_in(jax.random.key(seed), int(snr_db * 1000))

    tot = np.zeros(3)  # sum w*det, sum w*wrong, sum w*undet
    tot_sq = np.zeros(3)
    w_sum = 0.0
    w_max = 0.0
    fails = 0
    for b in range(n_batches):
        w, det, wrong = step(jax.random.fold_in(key, b), consts)
        w = np.asarray(w, np.float64)
        det = np.asarray(det)
        wrong = np.asarray(wrong)
        undet = wrong & ~det
        for i, mask in enumerate((det, wrong, undet)):
            x = w * mask
            tot[i] += x.sum()
            tot_sq[i] += (x * x).sum()
        w_sum += w.sum()
        w_max = max(w_max, w.max())
        fails += int(wrong.sum())

    N = n_batches * batch
    mean = tot / N
    # standard error of the mean of w*1{...}
    var = np.maximum(tot_sq / N - mean**2, 0.0)
    std = np.sqrt(var / N)
    return ISResult(
        snr_db=snr_db, frames=N,
        fer=float(mean[0]), fer_std=float(std[0]),
        wer=float(mean[1]), wer_std=float(std[1]),
        undetected=float(mean[2]), undetected_std=float(std[2]),
        mean_weight=float(w_sum / N), max_weight=float(w_max),
        fail_frames=fails,
    )
