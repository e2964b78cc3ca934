"""Smoke test of the simulator's main path on NVIDIA GPUs.

    python chip_smoke.py            # one card, about 13 minutes cold
    python chip_smoke.py --cards 4  # the multi-card path only, on four cards

One card, in order: the device; a full-width encode of the WiMAX (1152, 576)
code checked on the host; the QC decode kernel against the plain decoders
(ops.layered, ops.spa) on the same [4096, 1152] LLRs for four variants and
both schedules; the tests marked ``gpu`` (tests/test_gpu.py: the kernel at
the fit rule's other tiles), in a child pytest; the waterfall sweep
1.0-2.5 dB, 2^20 codewords per point, through ``ldpc_tpu.cli.main``; one
reference-fidelity point. Four cards: the
2 dB point on ``--mesh batch=4`` and two points on ``--mesh snr=2,batch=2``,
each against a one-card run of the same seeds in the same process; the
integer counters must be equal.

Any failed check raises: the script exits non-zero with a traceback and
prints no result line. Without a GPU it fails at once. Otherwise the last
line of stdout is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
Every rate is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "smoke_out")  # result JSONs of the CLI runs
FLAGSHIP = "builtin:wimax_1152_0.5.alist.txt"
REF_CODE = "builtin:wimax_576_0.5.alist.txt"
BATCH = 4096
FRAMES = 1 << 20  # per sweep point: 256 batches
REF_FRAMES = 1 << 16
SEED = 0
FER_BAND_2DB = (3e-3, 1.2e-2)  # code statistics (bench history), not a chip's
VARIANTS = ("spa", "minsum", "normalized_minsum", "offset_minsum")
MIN_AGREE = {"spa": 0.999}  # tanh/log lower differently in Triton and XLA
MIN_AGREE_MINSUM = 0.9999
SWEEP_ARGS = [
    "--matrix", FLAGSHIP, "--fidelity", "exact", "--schedule", "layered",
    "--layer-order", "paired", "--iterations", "12", "--speed", "0.5",
    "--batch", str(BATCH), "--ber", "--fer", "--seed", str(SEED),
]


# ---------------------------------------------------------------- helpers


def require_gpus(devices, count: int = 1) -> None:
    """Raise unless the first ``count`` JAX devices are GPUs."""
    if len(devices) < count or any(d.platform != "gpu" for d in devices):
        found = sorted({d.platform for d in devices}) or ["none"]
        raise RuntimeError(
            f"chip_smoke needs {count} GPU(s); JAX found {len(devices)} "
            f"device(s) on {', '.join(found)}"
        )


def parse_card(text: str) -> str:
    """First card of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` output, as 'name, limit'."""
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and all(parts):
            return f"{parts[0]}, {parts[1]}"
    raise ValueError(f"unexpected nvidia-smi output: {text!r}")


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return parse_card(out)


def syndromes_zero(H, words):
    """Per-word boolean: H @ w = 0 over GF(2) (host numpy)."""
    import numpy as np

    return ~((np.asarray(words, np.int64) @ np.asarray(H, np.int64).T) % 2
             ).astype(bool).any(axis=1)


def wilson(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    """95% Wilson score interval of a binomial proportion k/n."""
    if n <= 0:
        raise ValueError("empty sample")
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return max(mid - half, 0.0), min(mid + half, 1.0)


def check_parity(variant: str, agree: float, fails_ref: int,
                 fails_ker: int, n: int) -> None:
    """Kernel-vs-reference tolerances: min-sum frames agree to 99.99%; SPA
    to 99.9% with each FER inside the other's 95% interval."""
    need = MIN_AGREE.get(variant, MIN_AGREE_MINSUM)
    if agree < need:
        raise RuntimeError(
            f"{variant}: frame agreement {agree:.6f} below {need}"
        )
    if variant == "spa":
        lo_r, hi_r = wilson(fails_ref, n)
        lo_k, hi_k = wilson(fails_ker, n)
        if not (lo_r <= fails_ker / n <= hi_r and lo_k <= fails_ref / n <= hi_k):
            raise RuntimeError(
                f"spa: FERs {fails_ref / n:.3e} (xla) and {fails_ker / n:.3e} "
                "(kernel) lie outside each other's 95% interval"
            )


def check_sweep(points, band=None, at_snr: float = 2.0) -> None:
    """``points``: [(snr_db, fer)] ascending. FER must not rise with SNR,
    and FER at ``at_snr`` must lie in ``band`` (default FER_BAND_2DB)."""
    band = FER_BAND_2DB if band is None else band
    for (s0, f0), (s1, f1) in zip(points, points[1:]):
        if f1 > f0:
            raise RuntimeError(f"FER rises from {f0:.3e} at {s0} dB to "
                               f"{f1:.3e} at {s1} dB")
    at = [f for s, f in points if abs(s - at_snr) < 1e-9]
    if len(at) != 1:
        raise RuntimeError(f"no sweep point at {at_snr} dB")
    if not band[0] <= at[0] <= band[1]:
        raise RuntimeError(
            f"FER at {at_snr} dB is {at[0]:.3e}, outside [{band[0]:g}, "
            f"{band[1]:g}]"
        )


def point_counters(point: dict, k: int) -> dict:
    """Integer counters of one SNR point of a result JSON."""
    blocks = point["total_blocks"]
    ok = point["successful_blocks"]
    return {
        "blocks": blocks,
        "ok_blocks": ok,
        "fer_frames": round(point["fer"] * blocks),
        "error_bits": round(point["ber"] * k * blocks),
        # conv_count == ok_blocks (a frame converges iff it decodes)
        "conv_iters_sum": round(point["avg_convergence_iterations"] * ok),
    }


def parse_throughput(log: str) -> list[tuple[float, float, float]]:
    """(snr_db, codewords/s, info bits/s) per point from the runner's log."""
    out, snr = [], None
    for line in log.splitlines():
        m = re.match(r"\s*SNR: ([-\d.]+) dB", line)
        if m:
            snr = float(m.group(1))
        m = re.match(r"\s*Throughput: ([\d,]+) codewords/s \(([\d,]+) info", line)
        if m and snr is not None:
            out.append((snr, float(m.group(1).replace(",", "")),
                        float(m.group(2).replace(",", ""))))
    return out


class CompileLog:
    """Backend compile seconds and persistent-cache hits, from JAX's
    monitoring events."""

    def __init__(self):
        import jax.monitoring as mon

        self.seconds = 0.0
        self.hits = 0
        mon.register_event_duration_secs_listener(self._on_duration)
        mon.register_event_listener(self._on_event)

    def _on_duration(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration

    def _on_event(self, event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def snapshot(self) -> tuple[float, int]:
        return self.seconds, self.hits


COMPILES: CompileLog | None = None


def run_cli(argv: list[str]) -> tuple[dict, str, float]:
    """``ldpc_tpu.cli.main(argv)`` with its log captured; returns the
    result JSON, the log and the wall seconds. Raises on a non-zero rc."""
    from ldpc_tpu import cli

    buf = io.StringIO()
    s0, h0 = COMPILES.snapshot() if COMPILES else (0.0, 0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    log = buf.getvalue()
    if rc != 0:
        print(log)
        raise RuntimeError(f"cli.main{argv} returned {rc}")
    if COMPILES:
        s1, h1 = COMPILES.snapshot()
        print(f"set-up: {s1 - s0:.1f} s compiling inside the cli run, "
              f"{h1 - h0} persistent-cache hits")
    out = argv[argv.index("--output-json") + 1]
    with open(out) as f:
        return json.load(f), log, wall


# ----------------------------------------------------------------- phases


def phase_encode(jax, code) -> None:
    import numpy as np

    from ldpc_tpu.ops.encode import make_encoder, random_info_bits

    spec = code.standard_encode_spec
    enc = jax.jit(make_encoder(spec, "orig"))
    u = random_info_bits(jax.random.key(SEED), BATCH, code.k)
    w = np.asarray(enc(u))
    if not np.isin(w, (0.0, 1.0)).all():
        raise RuntimeError("encode produced values other than 0/1")
    ok = syndromes_zero(code.H.to_dense(), w.astype(np.uint8))
    if not ok.all():
        raise RuntimeError(f"encode: {int((~ok).sum())} of {BATCH} syndromes "
                           "are nonzero")
    info = np.asarray(spec.info_pos("orig"))
    if not (w[:, info].astype(np.uint8) == np.asarray(u)).all():
        raise RuntimeError("encode: info bits not systematic")
    print(f"encode: {BATCH} codewords of {code.name} on the card, all "
          f"{BATCH} syndromes H.w mod 2 zero, info bits systematic")


def phase_parity(jax, code, card: str) -> None:
    import numpy as np

    from ldpc_tpu.models.qc import paired_layer_groups
    from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
    from ldpc_tpu.ops.encode import make_encoder, random_info_bits
    from ldpc_tpu.ops.layered import make_qc_layered_decoder
    from ldpc_tpu.ops.spa import make_decoder
    from ldpc_tpu.ops.spa_pallas import make_qc_decoder, pick_tile

    spec = code.standard_encode_spec
    info = spec.info_pos("orig")
    key = jax.random.key(SEED + 1)
    w = jax.jit(make_encoder(spec, "orig"))(
        random_info_bits(key, BATCH, code.k))
    consts = ChannelParams(snr_db=2.0, speed=0.5, noise_model="exact").consts()
    llr = jax.jit(make_channel_fn(1, 1))(jax.random.fold_in(key, 1), w, consts)
    groups = paired_layer_groups(code.qc)
    flat = [bi for g in groups for bi in g]
    plan = pick_tile(code.qc)
    print(f"parity: {code.name} [{BATCH}, {code.n}] LLRs at 2 dB, 12 "
          f"iterations, kernel tile {plan.tile_b} codewords x "
          f"{plan.num_warps} warps")

    def timed(f):
        r = jax.block_until_ready(f(llr))
        t0 = time.perf_counter()
        for _ in range(3):
            r = jax.block_until_ready(f(llr))
        return r, (time.perf_counter() - t0) / 3

    for schedule in ("flooding", "layered"):
        for variant in VARIANTS:
            if schedule == "layered":
                ref = make_qc_layered_decoder(code.qc, info, 12, variant,
                                              layer_order=flat)
            else:
                ref = make_decoder(code.layout("orig"), info, 12, variant,
                                   rule="exact")
            ker = make_qc_decoder(
                code.qc, info, 12, variant, schedule=schedule,
                track_norm=False,
                layer_groups=groups if schedule == "layered" else None,
            )
            r1, t_ref = timed(jax.jit(ref))
            r2, t_ker = timed(jax.jit(ker))
            ok1, ok2 = np.asarray(r1.ok), np.asarray(r2.ok)
            same = ((ok1 == ok2)
                    & (np.asarray(r1.est) == np.asarray(r2.est)).all(axis=1)
                    & (np.asarray(r1.conv_iter) == np.asarray(r2.conv_iter)))
            agree = float(same.mean())
            f1, f2 = int((~ok1).sum()), int((~ok2).sum())
            print(f"parity {schedule}/{variant}: frames agree {agree:.6f} "
                  f"({int(same.sum())}/{BATCH}); FER xla {f1 / BATCH:.3e} "
                  f"kernel {f2 / BATCH:.3e}; decode alone xla "
                  f"{t_ref * 1e3:.3f} ms, kernel {t_ker * 1e3:.3f} ms per "
                  f"batch [{card}]")
            check_parity(variant, agree, f1, f2, BATCH)


def phase_gpu_tests(card: str) -> None:
    """``pytest -m gpu tests/test_gpu.py`` in a child process. This
    process already holds most of the card's memory, so the child
    allocates on demand within a small share; its default backend is the
    CPU (the test harness's), the tests put their work on the GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu,cuda",
               XLA_PYTHON_CLIENT_PREALLOCATE="false",
               XLA_PYTHON_CLIENT_MEM_FRACTION="0.15")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", "tests/test_gpu.py"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    lines = r.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    if r.returncode != 0 or "skipped" in summary or "passed" not in summary:
        print(r.stdout[-8000:])
        print(r.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"gpu tests: rc {r.returncode}: {summary}")
    print(f"gpu tests: {summary.strip('= ')} in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def executor_kind(code, argv) -> str:
    """``kernel_used`` of the executor the CLI builds for ``argv`` (built,
    not compiled)."""
    from ldpc_tpu.cli import build_parser, options_from_args
    from ldpc_tpu.sim.runner import PointExecutor

    opts = options_from_args(build_parser().parse_args(argv)).resolved()
    return PointExecutor(code, opts).kernel_used


def phase_sweep(code, card: str) -> None:
    argv = SWEEP_ARGS + [
        "--blocks", str(FRAMES), "--initial-snr", "1.0", "--end-snr", "2.5",
        "--step-snr", "0.5",
        "--output-json", os.path.join(OUT_DIR, "sweep.json"),
    ]
    print(f"sweep: kernel_used={executor_kind(code, argv)}")
    res, log, wall = run_cli(argv)
    pts = [(p["snr_db"], p["fer"]) for p in res["snr_points"]]
    for p in res["snr_points"]:
        print(f"sweep {p['snr_db']:.1f} dB: FER {p['fer']:.4e} BER "
              f"{p['ber']:.4e} over {p['total_blocks']} codewords, avg conv "
              f"iter {p['avg_convergence_iterations']:.3f}")
    for snr, cw, bits in parse_throughput(log):
        print(f"rate {snr:.1f} dB: {cw:,.0f} codewords/s, {bits:,.0f} info "
              f"bits/s [{card}]")
    print(f"sweep wall {wall:.1f} s for {len(pts)} points x {FRAMES} "
          f"codewords (the first point includes compiling the step)")
    check_sweep(pts)
    print(f"sweep: FER falls with SNR; FER(2 dB) in {list(FER_BAND_2DB)}")


def phase_reference(card: str) -> None:
    from ldpc_tpu.sim.runner import load_code

    code = load_code(REF_CODE)
    argv = [
        "--matrix", REF_CODE, "--fidelity", "reference", "--iterations",
        "20", "--initial-snr", "2", "--end-snr", "2", "--step-snr", "1",
        "--blocks", str(REF_FRAMES), "--ber", "--fer", "--seed", str(SEED),
        "--output-json", os.path.join(OUT_DIR, "reference.json"),
    ]
    print(f"reference: kernel_used={executor_kind(code, argv)}")
    res, log, wall = run_cli(argv)
    p = res["snr_points"][0]
    if p["total_blocks"] != REF_FRAMES or not 0.0 < p["fer"] <= 1.0:
        raise RuntimeError(f"reference point: {p}")
    if not math.isfinite(p["ber"]):
        raise RuntimeError("reference point: BER not finite")
    for snr, cw, bits in parse_throughput(log):
        print(f"reference {code.name} flooding SPA-20 {snr:.1f} dB: FER "
              f"{p['fer']:.4e} BER {p['ber']:.4e}; {cw:,.0f} codewords/s, "
              f"{bits:,.0f} info bits/s [{card}]")


def phase_cards(code, card: str, ndev: int) -> None:
    """The multi-card path against one card, same seeds and SNRs."""
    runs = [
        ("2 dB point", f"batch={ndev}",
         ["--blocks", str(FRAMES), "--initial-snr", "2.0", "--end-snr",
          "2.0", "--step-snr", "1.0"]),
        ("1.5/2.0 dB", f"snr=2,batch={ndev // 2}",
         ["--blocks", str(FRAMES // 4), "--initial-snr", "1.5",
          "--end-snr", "2.0", "--step-snr", "0.5"]),
    ]
    for label, mesh, extra in runs:
        tag = mesh.replace("=", "").replace(",", "_")
        res = {}
        for name, mesh_args in (("mesh", ["--mesh", mesh]), ("one", [])):
            argv = SWEEP_ARGS + extra + mesh_args + [
                "--output-json", os.path.join(OUT_DIR, f"{tag}_{name}.json")]
            res[name], _, wall = run_cli(argv)
            frames = sum(p["total_blocks"] for p in res[name]["snr_points"])
            print(f"cards {label} on {mesh if name == 'mesh' else 'one card'}"
                  f": {frames / wall:,.0f} codewords/s over {wall:.1f} s wall "
                  f"(compile included) [{card}]")
        for pm, p1 in zip(res["mesh"]["snr_points"], res["one"]["snr_points"]):
            cm, c1 = point_counters(pm, code.k), point_counters(p1, code.k)
            print(f"cards {label} {pm['snr_db']:.1f} dB: mesh {cm} one {c1}")
            if cm != c1:
                raise RuntimeError(f"counters differ on --mesh {mesh}")
        print(f"cards {label}: --mesh {mesh} counters equal the one-card run")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card path and its one-card "
                         "comparison")
    args = ap.parse_args(argv)

    import jax

    from ldpc_tpu.utils.cache import enable_compile_cache

    global COMPILES
    t_start = time.perf_counter()
    devices = jax.devices()
    require_gpus(devices, args.cards)
    enable_compile_cache()
    COMPILES = CompileLog()
    d = devices[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devices)}")
    card = card_label()
    print(f"card: {card}")
    os.makedirs(OUT_DIR, exist_ok=True)

    from ldpc_tpu.sim.runner import load_code

    code = load_code(FLAGSHIP)
    if args.cards == 4:
        phase_cards(code, card, 4)
    else:
        phase_encode(jax, code)
        phase_parity(jax, code, card)
        phase_gpu_tests(card)
        phase_sweep(code, card)
        phase_reference(card)
    stats = d.memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')} on "
          f"{d.device_kind}")
    print(f"total wall {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
