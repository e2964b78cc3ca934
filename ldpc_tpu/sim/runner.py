"""SNR-sweep simulation runner.

Accelerator re-design of the reference's main loop
(`python_ldpc_app/main.py:178-442`): instead of a Python loop spawning one
process per codeword, a whole batch of codewords runs the full
encode -> interleave -> channel -> deinterleave ->
decode -> count pipeline as ONE jitted program; the SNR sweep reuses a single
compiled step (channel scale factors are runtime scalars), and Monte-Carlo
batches stream until the requested block count is reached. Error counters are
reduced on device; only seven scalars come back to the host per batch.

With a `jax.sharding.Mesh`, the codeword batch axis is sharded across
devices (the equivalent of the reference's ProcessPoolExecutor fan-out,
main.py:241-292) and the counter reductions become cross-device sums.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from datetime import datetime
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.models.code import LDPCCode
from ldpc_tpu.ops.channel import ChannelConsts, ChannelParams, make_channel_fn
from ldpc_tpu.ops.encode import make_encoder, random_info_bits
from ldpc_tpu.ops.interleave import make_interleaver
from ldpc_tpu.ops.metrics import (
    BlockCounters,
    block_stats,
    pack_counters,
    reduce_block_stats,
    unpack_counters,
)
from ldpc_tpu.ops.spa import make_decoder
from ldpc_tpu.sim.config import SimOptions
from ldpc_tpu.sim.results import SimulationConfig, SimulationResult, SNRPointResult


@lru_cache(maxsize=16)
def load_code(path: str) -> LDPCCode:
    """Load a code from a file path, database basename, or built-in name
    (see ldpc_tpu.utils.db.resolve_matrix)."""
    from ldpc_tpu.utils.db import resolve_matrix

    resolved = resolve_matrix(path)
    if resolved.startswith("builtin:"):
        from ldpc_tpu.models import standards

        name = resolved[len("builtin:"):]
        return LDPCCode(alist=standards.make_builtin(name), name=name)
    return LDPCCode(resolved)


def resolve_layer_groups(qc, opts, schedule: str) -> list[list[int]] | None:
    """Layer groups for the paired layered sweep, or None for serial.

    ``--layer-order paired`` groups disjoint-support base rows
    (models.qc.paired_layer_groups) so each layered step carries two
    independent dependence chains. Returns None when pairing is off, the
    schedule is not layered, the code is not QC, or no disjoint pair exists
    (then the greedy grouping IS the serial order).
    """
    if getattr(opts, "layer_order", "serial") != "paired":
        return None
    if schedule != "layered" or qc is None:
        return None
    from ldpc_tpu.models.qc import paired_layer_groups

    groups = paired_layer_groups(qc)
    if all(len(g) == 1 for g in groups):
        return None
    return groups


def choose_kernel(want: str, backend: str, eligible: bool, *,
                  interpret: bool = False) -> bool:
    """True for the QC Pallas kernel, False for the XLA decoder.

    'auto' takes the kernel on a GPU for an eligible code; 'xla' never
    does; 'pallas' always does, and raises where the kernel cannot run: an
    ineligible configuration, or a backend that is not a GPU unless
    ``interpret`` is asked for."""
    if want == "xla":
        return False
    if want == "auto":
        return backend == "gpu" and eligible
    if want != "pallas":
        raise ValueError(f"kernel must be 'auto', 'pallas' or 'xla': {want!r}")
    if not eligible:
        raise ValueError(
            "kernel='pallas' requires a quasi-cyclic code, check_rule='exact', "
            "decode_graph='orig' and an SPA/min-sum variant"
        )
    if backend != "gpu" and not interpret:
        raise ValueError(
            f"kernel='pallas' runs on a GPU; this backend is {backend!r}"
        )
    return True


def _select_decoder(code, opts, layout, info_pos, max_iterations, *,
                    mesh=None, batch_axes=(), interpret=False):
    """Pick the decode kernel: the QC Pallas kernel (ops.spa_pallas) when
    the code and configuration are eligible and the card is a GPU; else the
    XLA decoder. Returns ``(decode, kind)``.

    ``kernel='pallas'`` forces the kernel and raises where it cannot run:
    an ineligible configuration, or a backend that is not a GPU -- unless ``interpret`` (tests only; no CLI flag reaches it)
    runs the Pallas interpreter instead."""
    from ldpc_tpu.ops.spa_pallas import VARIANTS, pick_tile

    variant = opts.decoder_variant
    want = opts.kernel
    schedule = opts.schedule or "flooding"
    # per-iteration / degree-specific --minsum-alpha schedules run on every
    # decode path: alpha[min(it, T-1)] per iteration
    if np.ndim(opts.minsum_alpha) > 0 and variant != "normalized_minsum":
        raise ValueError(
            "a per-iteration --minsum-alpha schedule requires "
            "--decoder normalized-minsum"
        )
    eligible = (
        variant in VARIANTS
        and opts.check_rule == "exact"
        and opts.decode_graph in ("orig", "original")
        and code.qc is not None
    )
    if schedule == "layered" and not eligible:
        raise ValueError(
            "schedule='layered' requires a quasi-cyclic code, "
            "check_rule='exact', decode_graph='orig' and an SPA/min-sum "
            "variant (base rows are the layers)"
        )
    use_pallas = choose_kernel(want, jax.default_backend(), eligible,
                               interpret=interpret)
    layer_groups = resolve_layer_groups(code.qc, opts, schedule)

    if use_pallas:
        from ldpc_tpu.ops.spa_pallas import make_qc_decoder

        decode = make_qc_decoder(
            code.qc, info_pos, max_iterations, variant,
            alpha=opts.minsum_alpha, beta=opts.minsum_beta,
            schedule=schedule,
            # elide the per-iteration normalized-LLR bookkeeping (and its
            # buffer) when the metric is not requested
            track_norm=opts.normalized_llr,
            layer_groups=layer_groups,
            interpret=interpret,
            mesh=mesh, batch_axes=batch_axes,
        )
    elif schedule == "layered":
        from ldpc_tpu.ops.layered import make_qc_layered_decoder

        decode = make_qc_layered_decoder(
            code.qc, info_pos, max_iterations, variant,
            alpha=opts.minsum_alpha, beta=opts.minsum_beta,
            # the XLA layered decoder expresses the paired schedule as its
            # flattened serial order (arithmetic-identical)
            layer_order=(
                None if layer_groups is None
                else [bi for g in layer_groups for bi in g]
            ),
        )
    else:
        decode = make_decoder(
            layout, info_pos, max_iterations, variant,
            rule=opts.check_rule, alpha=opts.minsum_alpha,
            beta=opts.minsum_beta,
        )

    kind = "pallas" if use_pallas else "xla"
    if schedule == "layered":
        kind += "+layered"
    if layer_groups is not None:
        kind += "+paired"
    if use_pallas:
        tile = pick_tile(code.qc)
        kind += f"+tb{tile.tile_b}w{tile.num_warps}"
    return decode, kind


@dataclass
class PointStats:
    """Host-side aggregate for one SNR point."""

    blocks: int = 0
    ok_blocks: int = 0
    error_bits: int = 0
    fer_frames: int = 0
    norm_llr_sum: float = 0.0
    conv_iters_sum: int = 0
    conv_count: int = 0

    def add(self, c: BlockCounters) -> None:
        self.blocks += int(c.blocks)
        self.ok_blocks += int(c.ok_blocks)
        self.error_bits += int(c.error_bits)
        self.fer_frames += int(c.fer_frames)
        self.norm_llr_sum += float(c.norm_llr_sum)
        self.conv_iters_sum += int(c.conv_iters_sum)
        self.conv_count += int(c.conv_count)


class PointExecutor:
    """One compiled Monte-Carlo step, reusable across every SNR point that
    shares (code, iterations, interleaver, modulation, decoder config).

    ``interpret`` runs a forced Pallas kernel in the interpreter (tests on
    the CPU); it is an argument of the API only."""

    def __init__(
        self,
        code: LDPCCode,
        opts: SimOptions,
        *,
        max_iterations: int | None = None,
        interleaver: str | None = None,
        modulation: int | None = None,
        mesh: jax.sharding.Mesh | None = None,
        batch_axes: tuple[str, ...] = ("batch",),
        interpret: bool = False,
    ):
        opts = opts.resolved()
        self.code = code
        self.opts = opts
        self.graph = opts.decode_graph
        self.max_iterations = max_iterations or opts.iterations
        il_kind = interleaver if interleaver is not None else opts.interleaver
        self.modulation = modulation or opts.modulation
        if self.modulation in (4, 16, 64) and opts.noise_model == "legacy":
            raise ValueError(
                "QAM modulations require noise_model='exact' (use --fidelity "
                "exact or --noise-model exact): the legacy sigma^2-as-stddev "
                "quirk is BPSK-specific and would make the SNR axis "
                "incomparable"
            )
        self.batch = opts.auto_batch(code.n)
        self.mesh = mesh
        if mesh is not None:
            # only axes the mesh actually has shard the batch (an snr-only
            # mesh leaves the codeword batch unsharded)
            batch_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
            if batch_axes:
                # round the batch up to a multiple of the sharded axis size
                axis = int(np.prod([mesh.shape[a] for a in batch_axes]))
                self.batch = int(-(-self.batch // axis) * axis)
        else:
            batch_axes = ()

        spec = code.encode_spec(opts.encoding_method, opts.ru_gap)
        self.spec = spec
        layout = code.layout(self.graph)
        info_pos = spec.info_pos(self.graph)

        # rate adaptation: shorten the LAST S info bits (known zeros at the
        # receiver), puncture the LAST P parity positions (erasures)
        S, P = opts.shorten, opts.puncture
        n_parity = code.n - code.k
        if not 0 <= S < code.k:
            raise ValueError(f"shorten={S} out of range [0, k={code.k})")
        if not 0 <= P < n_parity:
            raise ValueError(f"puncture={P} out of range [0, n-k={n_parity})")
        self.k_active = code.k - S
        self.effective_rate = self.k_active / max(code.n - S - P, 1)
        if (S or P) and abs(opts.speed - self.effective_rate) > 1e-9 and not opts.quiet:
            print(
                f"Note: shorten/puncture give an effective rate of "
                f"{self.effective_rate:.4f} but the Eb/N0 scaling uses "
                f"--speed {opts.speed:g}; pass --speed "
                f"{self.effective_rate:.6g} if the SNR axis should be "
                f"per-info-bit of the adapted code"
            )
        short_pos = np.asarray(info_pos[self.k_active:], dtype=np.int64)
        parity_pos = np.setdiff1d(
            np.arange(code.n, dtype=np.int64), np.asarray(info_pos, np.int64)
        )
        punct_pos = parity_pos[n_parity - P:] if P else np.empty(0, np.int64)
        # decoder/metrics see only the active info bits
        info_pos = np.asarray(info_pos[: self.k_active], dtype=np.int32)
        self._info_pos = jnp.asarray(info_pos)
        u_mask = np.ones((1, code.k), np.float32)
        u_mask[0, self.k_active:] = 0.0
        llr_short = np.zeros((1, code.n), np.float32)
        llr_short[0, short_pos] = 1.0
        llr_punct = np.ones((1, code.n), np.float32)
        llr_punct[0, punct_pos] = 0.0
        _u_mask = jnp.asarray(u_mask)
        _llr_short = jnp.asarray(llr_short)
        _llr_punct = jnp.asarray(llr_punct)
        KNOWN_LLR = 60.0  # |LLR| of a known bit; channel convention: 0 -> negative

        k = code.k
        batch = self.batch
        exact_ber = opts.exact_ber
        k_active = self.k_active
        sharding = (
            jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(batch_axes)
            ) if batch_axes else None
        )

        encode = make_encoder(spec, self.graph)
        interleave, deinterleave = make_interleaver(
            il_kind, code.n, s_param=opts.s_param, seed=opts.seed
        )
        channel = make_channel_fn(opts.mode, self.modulation, n=code.n)
        decode, self.kernel_used = _select_decoder(
            code, opts, layout, info_pos, self.max_iterations,
            mesh=mesh, batch_axes=batch_axes, interpret=interpret,
        )

        def make_step(dec, patterns: bool = False):
            def step(key: jax.Array, consts: ChannelConsts,
                     skip: jax.Array | None = None):
                k_u, k_il, k_ch = jax.random.split(key, 3)
                u = random_info_bits(k_u, batch, k)
                if S:
                    u = (u.astype(jnp.float32) * _u_mask).astype(u.dtype)
                if sharding is not None:
                    u = jax.lax.with_sharding_constraint(u, sharding)
                w = encode(u)
                w_int, il_state = interleave(k_il, w)
                llr = channel(k_ch, w_int, consts)
                llr = deinterleave(il_state, llr)
                if P:  # punctured parity bits arrive as erasures
                    llr = llr * _llr_punct
                if S:  # shortened info bits are known zeros
                    llr = llr * (1.0 - _llr_short) - KNOWN_LLR * _llr_short
                res = dec(llr, skip=skip)
                # NOTE: per-codeword stats stay unreduced here -- reducing
                # while-loop outputs to scalars in the same XLA program costs
                # minutes of compile time; the reduction runs in _reduce below.
                stats = block_stats(
                    u[:, :k_active], res, self._info_pos, exact=exact_ber
                )
                if patterns:
                    # residual error vector over the whole codeword: w is a
                    # valid codeword, so H @ resid == H @ est -- the support
                    # of a detected failure is a trapping-set candidate
                    # (ldpc_tpu.analysis.failures.trapping_census)
                    resid = res.est ^ w.astype(res.est.dtype)
                    return stats, res.iters_run, resid
                return stats, res.iters_run

            return step

        self._step = jax.jit(make_step(decode))
        # residual-pattern step for failure analysis, compiled only if used
        self._pattern_step_builder = lambda: jax.jit(make_step(decode, True))

        def reduce(stats, valid_count: jax.Array) -> BlockCounters:
            valid = jnp.arange(batch) < valid_count
            return reduce_block_stats(stats, valid)

        self._reduce = jax.jit(reduce)
        self._reduce_packed = jax.jit(
            lambda stats, valid_count, iters: pack_counters(
                reduce(stats, valid_count), iters
            )
        )
        self._consts_cache: dict[float, ChannelConsts] = {}
        self.total_iters_run = 0

    def run_point(
        self, snr_db: float, blocks: int, base_key: jax.Array, point_index: int
    ) -> PointStats:
        """Stream Monte-Carlo batches for one SNR point."""
        opts = self.opts
        consts = self._consts_cache.get(snr_db)
        if consts is None:
            # one host->device transfer set per SNR point, cached across
            # revisits (the adaptive sweep returns to points)
            consts = ChannelParams(
                mode=opts.mode,
                modulation=self.modulation,
                speed=opts.speed,
                snr_db=snr_db,
                interference_snr_db=opts.interference_snr,
                p=opts.p,
                noise_model=opts.noise_model,
            ).consts()
            self._consts_cache[snr_db] = consts
        key_point = jax.random.fold_in(base_key, point_index)

        stats = PointStats()
        remaining = blocks
        batch_idx = 0
        target_errors = opts.target_errors
        while remaining > 0:
            take = min(remaining, self.batch)
            key = jax.random.fold_in(key_point, batch_idx)
            block, iters_run = self._step(key, consts)
            counters, iters = unpack_counters(
                self._reduce_packed(block, jnp.int32(take), iters_run)
            )
            stats.add(counters)
            self.total_iters_run += iters
            remaining -= take
            batch_idx += 1
            # sequential MC early stop: the FER/BER estimators' precision is
            # set by the error count, so once enough frame errors are in,
            # further blocks at this point add nothing
            if target_errors and stats.fer_frames >= target_errors:
                break
        return stats


def snr_steps(initial: float, end: float, step: float) -> list[float]:
    """SNR grid with the reference's stepping (main.py:193, 206-209).

    Validated (step > 0, end >= initial) and de-duplicated: the reference's
    ceil + clamp construction repeats the end point when (end-initial)/step
    is an exact multiple that float division rounds up.
    """
    if step <= 0:
        raise ValueError(f"step_snr must be positive, got {step}")
    if end < initial:
        raise ValueError(
            f"end_snr ({end}) must be >= initial_snr ({initial})"
        )
    num_steps = int(math.ceil((end - initial) / step)) + 1
    values: list[float] = []
    for i in range(num_steps):
        snr = min(initial + i * step, end)
        if not values or snr != values[-1]:
            values.append(snr)
    return values


def build_point_result(
    snr_db: float,
    stats: PointStats,
    opts: SimOptions,
    k: int,
    *,
    matrix_path: str | None = None,
    modulation: int | None = None,
    max_iterations: int | None = None,
    interleaver: str | None = None,
) -> SNRPointResult:
    """Aggregate counters into an SNRPointResult with the reference's
    averaging semantics (main.py:346-389)."""
    blocks = stats.blocks
    avg_ber = 0.0
    avg_fer = 0.0
    avg_llr = 0.0
    if opts.ber and blocks > 0 and k > 0:
        avg_ber = stats.error_bits / (k * blocks)
    if opts.fer and blocks > 0:
        avg_fer = stats.fer_frames / blocks
    if opts.normalized_llr and blocks > 0:
        avg_llr = stats.norm_llr_sum / blocks
    avg_conv = stats.conv_iters_sum / stats.conv_count if stats.conv_count else 0.0
    return SNRPointResult(
        snr_db=snr_db,
        ber=avg_ber,
        fer=avg_fer,
        avg_normalized_llr=avg_llr,
        total_blocks=blocks,
        successful_blocks=stats.ok_blocks,
        failed_blocks=blocks - stats.ok_blocks,
        avg_convergence_iterations=avg_conv,
        matrix_path=matrix_path if matrix_path is not None else opts.matrix,
        modulation=modulation if modulation is not None else opts.modulation,
        max_iterations=max_iterations if max_iterations is not None else opts.iterations,
        interleaver=interleaver if interleaver is not None else opts.interleaver,
        encoding_method=opts.encoding_method,
    )


def make_sim_config(opts: SimOptions, code: LDPCCode) -> SimulationConfig:
    dev = jax.devices()[0]
    return SimulationConfig(
        matrix_path=opts.matrix,
        n=code.n,
        m=code.m,
        k=code.k,
        rate=code.rate,
        blocks=opts.blocks,
        max_iterations=opts.iterations,
        encoding_method=opts.encoding_method,
        interleaver_type=opts.interleaver,
        decoder_type=opts.decoder,
        channel_mode=opts.mode,
        modulation=opts.modulation,
        speed=opts.speed,
        snr_range=(opts.initial_snr, opts.end_snr, opts.step_snr),
        threads=opts.threads,
        timestamp=datetime.now().isoformat(),
        interference_snr=opts.interference_snr,
        p=opts.p,
        fidelity=opts.fidelity,
        decode_graph=opts.decode_graph or "",
        check_rule=opts.check_rule or "",
        noise_model=opts.noise_model or "",
        batch=opts.batch,
        seed=opts.seed,
        device=f"{dev.platform}:{getattr(dev, 'device_kind', '')}x{jax.device_count()}",
        shorten=opts.shorten,
        puncture=opts.puncture,
        schedule=opts.schedule,
        s_param=opts.s_param,
        exact_ber=opts.exact_ber,
        adaptive=opts.adaptive,
        layer_order=opts.layer_order,
    )


def sweep_fingerprint(config: SimulationConfig) -> tuple:
    """Sweep-defining identity of a run: a checkpoint resumes only a sweep
    with identical code / stats / decoder configuration (timestamp, device,
    and wall clock are excluded)."""
    return (
        config.matrix_path, config.n, config.m, config.k,
        config.blocks, config.max_iterations, config.encoding_method,
        config.interleaver_type, config.decoder_type, config.channel_mode,
        config.modulation, config.speed, tuple(config.snr_range),
        config.interference_snr, config.p, config.fidelity,
        config.decode_graph, config.check_rule, config.noise_model,
        config.seed, config.shorten, config.puncture, config.schedule,
        config.s_param, config.exact_ber, config.adaptive,
        # a reordered layered sweep is a different decode schedule with
        # different statistics
        config.layer_order,
        # batch shapes the key->codeword stream (keys fold per batch index),
        # so a different batch size is a DIFFERENT sweep, not a resumable one
        config.batch,
    )


def load_checkpoint(
    opts: SimOptions, config: SimulationConfig, say
) -> SimulationResult | None:
    """Prior partial result from opts.checkpoint, or None when absent/foreign."""
    import os

    if not (opts.checkpoint and opts.resume and os.path.exists(opts.checkpoint)):
        return None
    prior = SimulationResult.from_json(opts.checkpoint)
    if sweep_fingerprint(prior.config) != sweep_fingerprint(config):
        say(
            f"Checkpoint {opts.checkpoint} belongs to a different sweep "
            f"configuration; starting fresh."
        )
        return None
    say(f"Resuming from {opts.checkpoint}: {len(prior.snr_points)} points done")
    return prior


def _parallel_ckpt_save(
    path: str, fp, batch_idx: int, remaining: int, stats_list, total_iters: int,
    device_batch: int,
) -> None:
    """Atomic mid-sweep checkpoint for the parallel runner: raw per-point
    counters + stream position. PRNG keys fold by (point, batch) index, so a
    resumed sweep is BIT-IDENTICAL to an uninterrupted one -- provided the
    RESOLVED device batch matches (batch=0 auto-resolves per device count),
    hence it is recorded and checked alongside the fingerprint."""
    import json

    payload = {
        "parallel_sweep": 1,
        "fingerprint": fp,
        "device_batch": device_batch,
        "batch_idx": batch_idx,
        "remaining": remaining,
        "total_iters_run": total_iters,
        "counters": [
            [s.blocks, s.ok_blocks, s.error_bits, s.fer_frames,
             s.norm_llr_sum, s.conv_iters_sum, s.conv_count]
            for s in stats_list
        ],
    }
    import os

    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _parallel_ckpt_load(path: str, fp, n_points: int, say, device_batch: int):
    """Load a parallel-sweep checkpoint; None when absent/foreign."""
    import json
    import os

    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    if not d.get("parallel_sweep"):
        say(f"Checkpoint {path} is not a parallel-sweep checkpoint; "
            "starting fresh.")
        return None
    if (d["fingerprint"] != fp or len(d["counters"]) != n_points
            or d.get("device_batch") != device_batch):
        say(f"Checkpoint {path} belongs to a different sweep configuration; "
            "starting fresh.")
        return None
    stats_list = []
    for row in d["counters"]:
        s = PointStats()
        (s.blocks, s.ok_blocks, s.error_bits, s.fer_frames,
         s.norm_llr_sum, s.conv_iters_sum, s.conv_count) = row
        stats_list.append(s)
    say(f"Resuming parallel sweep from {path}: batch {d['batch_idx']}, "
        f"{d['remaining']} blocks/point remaining")
    return d["batch_idx"], d["remaining"], d["total_iters_run"], stats_list


def _profiled_sweep(profile_dir: str | None):
    """jax.profiler trace around the sweep when --profile is set."""
    import contextlib

    if profile_dir:
        return jax.profiler.trace(profile_dir)
    return contextlib.nullcontext()


def run_simulation(
    opts: SimOptions,
    code: LDPCCode | None = None,
    mesh: jax.sharding.Mesh | None = None,
    *,
    interpret: bool = False,
) -> SimulationResult:
    """Full SNR sweep; returns a SimulationResult (main.py:178-442 analogue).

    ``interpret``: see :class:`PointExecutor` (tests only)."""
    opts = opts.resolved()
    start_time = time.time()
    if code is None:
        code = load_code(opts.matrix)

    base_key = jax.random.key(opts.seed)
    say = (lambda *a, **kw: None) if opts.quiet else print
    config = make_sim_config(opts, code)
    prior = load_checkpoint(opts, config, say)
    snr_points: list[SNRPointResult] = list(prior.snr_points) if prior else []

    # executor construction (GF(2) elimination, decoder build) is deferred:
    # a checkpoint that already covers the whole sweep skips it entirely
    executor: PointExecutor | None = None

    say("Processing blocks across SNR points...")
    say("-" * 60)

    with _profiled_sweep(opts.profile):
        for idx, snr in enumerate(
            snr_steps(opts.initial_snr, opts.end_snr, opts.step_snr)
        ):
            if idx < len(snr_points):
                continue  # completed before resume
            if executor is None:
                executor = PointExecutor(code, opts, mesh=mesh,
                                         interpret=interpret)
            say(f"\nSNR: {snr:.2f} dB")
            t_point = time.time()
            stats = executor.run_point(snr, opts.blocks, base_key, idx)
            point_s = time.time() - t_point
            point = build_point_result(snr, stats, opts, executor.k_active)
            snr_points.append(point)
            if opts.normalized_llr:
                say(f"  Normalized LLR: {point.avg_normalized_llr:.6f}")
            if opts.fer:
                say(f"  FER: {point.fer:.6f}")
            if opts.ber:
                say(f"  BER: {point.ber:.6f}")
            say(
                f"  Decoded OK: {point.successful_blocks}/{point.total_blocks} "
                f"({100.0 * point.successful_blocks / max(point.total_blocks, 1):.2f}%)"
            )
            say(
                f"  Throughput: {stats.blocks / point_s:,.0f} codewords/s "
                f"({stats.blocks * code.k / point_s:,.0f} info bits/s)"
            )
            if opts.checkpoint:
                SimulationResult(
                    config=config,
                    snr_points=snr_points,
                    wall_clock_seconds=time.time() - start_time,
                ).to_json(opts.checkpoint)

    say()
    say("=" * 60)
    if opts.ber:
        say("SNR -> BER:")
        for p in snr_points:
            say(f"  {p.snr_db:.2f} dB -> {p.ber:.6f}")
    if opts.fer:
        say("SNR -> FER:")
        for p in snr_points:
            say(f"  {p.snr_db:.2f} dB -> {p.fer:.6f}")
    if opts.normalized_llr:
        say("SNR -> Normalized LLR:")
        for p in snr_points:
            say(f"  {p.snr_db:.2f} dB -> {p.avg_normalized_llr:.6f}")
    say("=" * 60)

    return SimulationResult(
        config=config,
        snr_points=snr_points,
        wall_clock_seconds=time.time() - start_time,
    )


def run_simulation_parallel(
    opts: SimOptions,
    code: LDPCCode | None = None,
    mesh: jax.sharding.Mesh | None = None,
    snr_axis: str = "snr",
    *,
    interpret: bool = False,
) -> SimulationResult:
    """SNR sweep with every point evaluated SIMULTANEOUSLY on the mesh.

    The mesh carries ('snr', 'batch'): independent SNR points vectorize over
    the 'snr' axis (vmap over stacked ChannelConsts) while each point's
    codeword batch stays data-parallel over 'batch'. One jitted program
    evaluates S points x B codewords per dispatch; counters psum on device.

    PRNG keys fold exactly as the sequential runner's
    (fold(fold(base, point_index), batch_index)), so this produces the SAME
    SimulationResult as run_simulation -- the vectorized answer to the
    reference's sequential SNR loop (main.py:206).
    """
    from ldpc_tpu.parallel.mesh import make_mesh, sharded_sweep_step

    opts = opts.resolved()
    start_time = time.time()
    if code is None:
        code = load_code(opts.matrix)
    if mesh is None:
        mesh = make_mesh()  # all devices on 'batch'
    say = (lambda *a, **kw: None) if opts.quiet else print

    snrs = snr_steps(opts.initial_snr, opts.end_snr, opts.step_snr)
    S = len(snrs)
    s_shard = int(mesh.shape[snr_axis]) if snr_axis in mesh.axis_names else 1
    Sp = -(-S // s_shard) * s_shard  # pad points to the snr-axis size

    batch_axes = tuple(a for a in mesh.axis_names if a != snr_axis)
    executor = PointExecutor(
        code, opts, mesh=mesh, batch_axes=batch_axes or ("batch",),
        interpret=interpret,
    )
    base_key = jax.random.key(opts.seed)

    def consts_for(snr_db: float) -> ChannelConsts:
        return ChannelParams(
            mode=opts.mode,
            modulation=opts.modulation,
            speed=opts.speed,
            snr_db=snr_db,
            interference_snr_db=opts.interference_snr,
            p=opts.p,
            noise_model=opts.noise_model,
        ).consts()

    padded = snrs + [snrs[-1]] * (Sp - S)
    consts_stack = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[consts_for(s) for s in padded]
    )
    point_keys = jnp.stack(
        [jax.random.fold_in(base_key, i) for i in range(Sp)]
    )

    if snr_axis in mesh.axis_names:
        sweep = sharded_sweep_step(
            lambda k, c, s: executor._step(k, c, s), mesh, snr_axis
        )
    else:
        sweep = jax.jit(jax.vmap(lambda k, c, s: executor._step(k, c, s)))
    reduce_v = jax.jit(jax.vmap(executor._reduce, in_axes=(0, None)))

    say(f"Evaluating {S} SNR points in parallel on mesh "
        f"{dict(zip(mesh.axis_names, mesh.devices.shape))}...")

    stats_list = [PointStats() for _ in range(Sp)]
    remaining = opts.blocks
    batch_idx = 0
    ckpt_fp = None
    if opts.checkpoint:
        import json as _json

        # JSON-normalized so a reloaded fingerprint compares equal
        ckpt_fp = _json.loads(
            _json.dumps(sweep_fingerprint(make_sim_config(opts, code)))
        )
        if opts.resume:
            prior = _parallel_ckpt_load(opts.checkpoint, ckpt_fp, Sp, say,
                                        executor.batch)
            if prior is not None:
                batch_idx, remaining, executor.total_iters_run, stats_list = prior
    def finished_mask() -> np.ndarray:
        """Points that stop decoding: padding replicas always; real points
        once they reach the --target-errors frame quota (the sequential
        runner's per-point early stop, applied per point here instead of
        letting finished points burn iterations until the slowest one is
        done). Derived from stats_list, so checkpoint resume recomputes it.
        """
        f = np.zeros(Sp, dtype=bool)
        f[S:] = True
        if opts.target_errors:
            for s in range(S):
                f[s] = stats_list[s].fer_frames >= opts.target_errors
        return f

    with _profiled_sweep(opts.profile):
        while remaining > 0:
            finished = finished_mask()
            # stop once EVERY real point has its frame-error quota (also
            # catches a resume from an already-finished checkpoint)
            if opts.target_errors and finished[:S].all():
                break
            take = min(remaining, executor.batch)
            keys = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
                point_keys, batch_idx
            )
            skips = jnp.asarray(finished.astype(np.int32))
            stats, iters_run = sweep(keys, consts_stack, skips)
            counters = reduce_v(stats, jnp.int32(take))
            host = jax.tree.map(np.asarray, counters)
            for s in range(Sp):
                if not finished[s]:
                    stats_list[s].add(jax.tree.map(lambda x: x[s], host))
            # sum per-point iteration counts over the points still decoding
            # (same meaning as the sequential runner's accumulation, one
            # count per dispatched SNR point)
            executor.total_iters_run += int(
                np.sum(np.asarray(iters_run)[~finished])
            )
            remaining -= take
            batch_idx += 1
            if opts.checkpoint:
                _parallel_ckpt_save(
                    opts.checkpoint, ckpt_fp, batch_idx, remaining,
                    stats_list, executor.total_iters_run, executor.batch,
                )

    snr_points = [
        build_point_result(snrs[s], stats_list[s], opts, executor.k_active)
        for s in range(S)
    ]
    for p in snr_points:
        say(f"SNR {p.snr_db:.2f} dB: BER={p.ber:.6f} FER={p.fer:.6f} "
            f"ok={p.successful_blocks}/{p.total_blocks}")

    return SimulationResult(
        config=make_sim_config(opts, code),
        snr_points=snr_points,
        wall_clock_seconds=time.time() - start_time,
    )
