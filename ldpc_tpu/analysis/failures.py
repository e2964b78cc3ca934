"""Failure-structure profiling: error-weight histograms of failing frames.

The simulation pipeline reduces each batch to scalar counters; this module
keeps one more moment of the failure distribution -- a histogram over the
*info-bit error weight* of every frame the decoder got wrong -- computed
on-device inside a jitted scan (one host fetch per dispatch group), split:

* **detected** failures (syndrome check fails): the weight structure
  separates near-codeword / trapping-set events (small, repeatable weights,
  the error-floor mechanism) from channel noise overwhelming the decoder
  (weights near the uncoded error mass). Weight 0 is possible: all info
  bits right, residual errors confined to parity positions.
* **undetected** errors (syndrome passes, info bits wrong): the decoder
  converged to a DIFFERENT codeword; weights are bounded below by the
  minimum distance projected on the info positions. The reference's
  failed-frames-only BER accounting scores these frames as error-free
  (main.py:124-146) -- this profile measures what that convention hides.

Driven by scripts/error_floor.py; tested in tests/test_failures.py.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np


def make_profiler(executor, k_active: int):
    """Jitted scan of MC steps -> on-device failure-weight histograms.

    Returns ``chunk(key_point, start, consts, n_steps) ->
    (hist_detected, hist_undetected, frames)`` where the histograms are
    f32[k_active+1] counts over info-bit error weight. Key folding matches
    PointExecutor.run_point, so (for the same point index) the profiled
    stream IS the stream a normal run at this point would decode. Requires
    exact_ber=True, without which metrics.block_stats zeroes the
    error bits of syndrome-passing frames and the undetected-error
    histogram would be silently empty.
    """
    if not executor.opts.exact_ber:
        raise ValueError(
            "failure profiling needs exact_ber=True: without it the "
            "undetected-error histogram is silently empty "
            "(metrics.block_stats zeroes error bits of accepted frames)"
        )
    step = executor._step
    nbins = k_active + 1

    @functools.partial(jax.jit, static_argnames="n_steps")
    def chunk(key_point, start, consts, n_steps: int):
        def body(carry, i):
            hd, hu, frames = carry
            key = jax.random.fold_in(key_point, start + i)
            stats, _ = step(key, consts)
            w = jnp.clip(stats.error_bits, 0, k_active)
            det = (~stats.ok).astype(jnp.float32)
            undet = (stats.ok & (stats.error_bits > 0)).astype(jnp.float32)
            hd = hd.at[w].add(det)
            hu = hu.at[w].add(undet)
            return (hd, hu, frames + np.float32(stats.ok.shape[0])), None

        init = (
            jnp.zeros(nbins, jnp.float32),
            jnp.zeros(nbins, jnp.float32),
            jnp.float32(0.0),
        )
        (hd, hu, frames), _ = jax.lax.scan(body, init, jnp.arange(n_steps))
        return hd, hu, frames

    return chunk


def profile_point(code, opts, snr_db: float, min_failures: int,
                  max_blocks: int, say=print, executor=None,
                  point_index: int = 0):
    """Decode until ``min_failures`` detected failures (or ``max_blocks``
    frames), histogramming failure weights on-device.

    ``opts`` must carry ``exact_ber=True``; see :func:`make_profiler`. Pass
    ``executor`` to reuse one compiled step across SNR points and
    ``point_index`` (the point's index in the sweep grid) to profile the
    exact frame stream ``run_point`` would decode at that point -- it also
    decorrelates the noise draws of different SNR points. Returns
    ``(hist_detected, hist_undetected, frames)`` as numpy arrays / int.
    """
    from ldpc_tpu.ops.channel import ChannelParams
    from ldpc_tpu.sim.runner import PointExecutor

    ex = executor if executor is not None else PointExecutor(code, opts)
    # cache the jitted scan on the executor: jax.jit keys its compile cache
    # on the function object, so rebuilding it per point would recompile
    prof = getattr(ex, "_failure_profiler", None)
    if prof is None:
        prof = ex._failure_profiler = make_profiler(ex, ex.k_active)
    opts = opts.resolved()  # fidelity presets -> concrete noise_model etc.
    consts = ChannelParams(
        mode=opts.mode, modulation=opts.modulation, speed=opts.speed,
        snr_db=snr_db, interference_snr_db=opts.interference_snr, p=opts.p,
        noise_model=opts.noise_model,
    ).consts()
    key_point = jax.random.fold_in(jax.random.key(opts.seed), point_index)
    hd = np.zeros(ex.k_active + 1)
    hu = np.zeros(ex.k_active + 1)
    frames = 0
    start = 0
    n_steps = 8
    t0 = time.time()
    while hd.sum() < min_failures and frames < max_blocks:
        d, u, f = prof(key_point, jnp.int32(start), consts, n_steps)
        hd += np.asarray(d)
        hu += np.asarray(u)
        frames += int(np.asarray(f))
        start += n_steps
        n_steps = min(n_steps * 2, 64)  # grow groups as the point gets deep
    say(
        f"  profiled {frames:,} frames in {time.time() - t0:.1f}s: "
        f"{int(hd.sum())} detected failures, {int(hu.sum())} undetected"
    )
    return hd, hu, frames


def make_pattern_profiler(executor, max_patterns: int = 256,
                          kind: str = "detected"):
    """Jitted scan capturing residual error vectors of failing frames.

    Returns ``chunk(key_point, start, consts, n_steps) -> (buf, count)``:
    ``buf`` is uint8 [max_patterns, n] holding the first ``max_patterns``
    residuals e = est XOR w of the selected frames; ``count`` is the total
    number seen (may exceed the buffer). ``kind``:

    * ``'detected'`` -- syndrome check failed: H@e = H@est != 0 (w is a
      valid codeword); supports are trapping-set candidates.
    * ``'undetected'`` -- syndrome passed but info bits are wrong: the
      residual is itself a NONZERO CODEWORD (H@e = 0), so every captured
      pattern's weight is an upper bound on the code's minimum distance
      and its support is an explicit minimum-weight-neighborhood codeword.
      Requires exact_ber=True (otherwise error_bits is zeroed for accepted
      frames and no frame ever selects).

    The buffer is filled on-device -- host traffic per dispatch group is
    one [K, n] fetch regardless of batch count.
    """
    if kind not in ("detected", "undetected"):
        raise ValueError(f"kind must be 'detected' or 'undetected': {kind!r}")
    if kind == "undetected" and not executor.opts.exact_ber:
        raise ValueError(
            "undetected-error capture needs exact_ber=True: without it "
            "error_bits is zeroed for syndrome-passing frames"
        )
    pstep = getattr(executor, "_pattern_step", None)
    if pstep is None:
        pstep = executor._pattern_step = executor._pattern_step_builder()
    K = max_patterns
    n = executor.code.n

    @functools.partial(jax.jit, static_argnames="n_steps")
    def chunk(key_point, start, consts, n_steps: int):
        def body(carry, i):
            buf, cnt = carry
            key = jax.random.fold_in(key_point, start + i)
            stats, _, resid = pstep(key, consts)
            if kind == "detected":
                failed = ~stats.ok  # bool [B]
            else:
                failed = stats.ok & (stats.error_bits > 0)
            # pack failed rows first (argsort is stable: batch order kept)
            order = jnp.argsort(jnp.logical_not(failed))
            # fixed accumulator dtype: under x64, sum() would promote the
            # carry to int64 and break the scan's carry-type invariance
            nf = jnp.sum(failed, dtype=jnp.int32).astype(jnp.int32)
            take = min(failed.shape[0], K)
            resid_f = resid[order[:take]].astype(jnp.uint8)
            pos = cnt + jnp.arange(take)
            valid = (jnp.arange(take) < nf) & (pos < K)
            pos = jnp.where(valid, pos, K)  # K is out of bounds -> dropped
            buf = buf.at[pos].set(resid_f, mode="drop")
            return (buf, cnt + nf), None

        init = (jnp.zeros((K, n), jnp.uint8), jnp.int32(0))
        (buf, cnt), _ = jax.lax.scan(body, init, jnp.arange(n_steps))
        return buf, cnt

    return chunk


def collect_failure_patterns(code, opts, snr_db: float, min_patterns: int,
                             max_blocks: int, max_patterns: int = 256,
                             say=print, executor=None, point_index: int = 0,
                             kind: str = "detected"):
    """Residual error vectors of failing frames at one SNR point.

    Returns ``(patterns, failures_seen, frames)`` with ``patterns`` a uint8
    [min(failures_seen, max_patterns), n] numpy array. ``executor`` /
    ``point_index`` as in :func:`profile_point`; ``kind`` as in
    :func:`make_pattern_profiler`.
    """
    from ldpc_tpu.ops.channel import ChannelParams
    from ldpc_tpu.sim.runner import PointExecutor

    ex = executor if executor is not None else PointExecutor(code, opts)
    # same compile-cache consideration as profile_point, keyed by config
    cache = getattr(ex, "_pattern_profilers", None)
    if cache is None:
        cache = ex._pattern_profilers = {}
    prof = cache.get((max_patterns, kind))
    if prof is None:
        prof = cache[(max_patterns, kind)] = make_pattern_profiler(
            ex, max_patterns, kind
        )
    opts = opts.resolved()  # fidelity presets -> concrete noise_model etc.
    consts = ChannelParams(
        mode=opts.mode, modulation=opts.modulation, speed=opts.speed,
        snr_db=snr_db, interference_snr_db=opts.interference_snr, p=opts.p,
        noise_model=opts.noise_model,
    ).consts()
    key_point = jax.random.fold_in(jax.random.key(opts.seed), point_index)
    buf = np.zeros((max_patterns, code.n), np.uint8)
    seen = 0
    frames = 0
    start = 0
    n_steps = 8
    t0 = time.time()
    while seen < min(min_patterns, max_patterns) and frames < max_blocks:
        # each chunk restarts an empty device buffer; copy the fresh rows out
        b, c = prof(key_point, jnp.int32(start), consts, n_steps)
        c = int(np.asarray(c))
        room = max_patterns - seen
        fresh = np.asarray(b[: min(c, room)])
        buf[seen: seen + len(fresh)] = fresh
        seen += c
        frames += n_steps * ex.batch
        start += n_steps
        n_steps = min(n_steps * 2, 64)
    say(
        f"  captured {min(seen, max_patterns)} failure patterns "
        f"({seen} failures / {frames:,} frames) in {time.time() - t0:.1f}s"
    )
    return buf[: min(seen, max_patterns)], seen, frames


def trapping_census(patterns: np.ndarray, code, graph: str = "orig",
                    top: int = 10) -> dict:
    """Classify residual error vectors into (a, b) trapping-set classes.

    ``a`` = residual support size (variable nodes in error), ``b`` = number
    of unsatisfied checks (weight of H @ e mod 2). Small recurring (a, b)
    classes with b << a*dv are near-codeword / trapping-set events -- the
    error-floor mechanism; ``classes`` maps "a,b" -> count (all classes,
    most frequent first) and ``recurring_supports`` lists the ``top`` exact
    supports captured more than once.
    """
    H = (code._h_std_dense if graph in ("std", "standard")
         else code.H.to_dense()).astype(np.int64)
    classes: dict[str, int] = {}
    supports: dict[tuple, int] = {}
    for e in np.asarray(patterns):
        sup = np.flatnonzero(e)
        if sup.size == 0:
            continue  # not a detected failure (defensive)
        b = int((H[:, sup].sum(axis=1) & 1).sum())
        key = f"{sup.size},{b}"
        classes[key] = classes.get(key, 0) + 1
        skey = tuple(int(v) for v in sup)
        supports[skey] = supports.get(skey, 0) + 1
    recurring = sorted(
        ((list(s), c) for s, c in supports.items() if c > 1),
        key=lambda sc: -sc[1],
    )[:top]
    return {
        "patterns": int(len(patterns)),
        "classes": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        "recurring_supports": [
            {"support": s, "count": c, "a": len(s)} for s, c in recurring
        ],
    }


def profile_sweep(code, opts, snrs, min_failures: int, max_blocks: int,
                  say=print) -> dict:
    """Failure profile at each SNR in ``snrs`` with ONE compiled step.

    Returns ``{snr: {frames, detected, undetected, hist_detected,
    hist_undetected}}`` (JSON-ready; histograms as weight->count dicts).
    Used by scripts/error_floor.py and the CLI's ``--failure-profile``.
    """
    from ldpc_tpu.sim.runner import PointExecutor

    ex = PointExecutor(code, opts)
    out = {}
    for idx, snr in enumerate(snrs):
        say(f"profiling failures at {snr:g} dB")
        hd, hu, frames = profile_point(
            code, opts, snr, min_failures, max_blocks, say=say, executor=ex,
            point_index=idx,
        )
        out[snr] = {
            "frames": frames,
            "detected": weight_summary(hd),
            "undetected": weight_summary(hu),
            "hist_detected": {int(w): int(c) for w, c in enumerate(hd) if c},
            "hist_undetected": {int(w): int(c) for w, c in enumerate(hu) if c},
        }
    return out


def weight_summary(hist: np.ndarray) -> dict:
    """Percentile summary of a weight histogram (counts indexed by weight)."""
    total = hist.sum()
    if total == 0:
        return {"count": 0}
    w = np.arange(hist.size)
    cum = np.cumsum(hist)

    def pct(q):
        return int(w[np.searchsorted(cum, q * total)])

    return {
        "count": int(total),
        "min_weight": int(w[hist > 0][0]),
        "max_weight": int(w[hist > 0][-1]),
        "p10": pct(0.10),
        "median": pct(0.50),
        "p90": pct(0.90),
        "mean": float((hist * w).sum() / total),
    }
