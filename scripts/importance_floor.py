"""Deep error-floor FER via importance sampling — WiMAX (576, 288).

Extends examples/error_floor beyond plain Monte-Carlo's reach (the curve
stops at FER 1.25e-7 / 200 M frames at 4.5 dB):

1. **Capture shift targets on-device**: undetected-error residuals at
   2.5 dB are verified minimum-distance-neighborhood CODEWORDS (the
   weight-13 orbit, examples/error_floor README); recurring trapping-set
   supports come from the committed census. Both expand to full QC orbits.
2. **Cross-validate** the defensive-mixture IS estimator
   (ldpc_tpu.analysis.importance): its UNDETECTED-error rate must continue
   the plain-MC-measured curve (24 events/17.8M frames at 3.5 dB,
   26/60.3M at 3.75 — the failure profiles), and its total must stay at or
   below plain MC's in the 4.0–4.5 dB overlap (IS isolates the floor
   component; MC's total there still contains waterfall bulk).
3. **Estimate the floor at 5.0–6.5 dB** (FER ~1e-8..1e-13) with CIs, in
   minutes of chip time. The estimate covers the DISCOVERED event set
   (minimum-distance orbits + census trapping sets); an undiscovered event
   class would appear as a gap in the validation overlap.

Usage (from the repository root, on a GPU):
  python scripts/importance_floor.py
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import jax
import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="builtin:wimax_576_0.5.alist.txt")
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--census",
                    default="examples/error_floor/trapping_census.json",
                    help="trapping census JSON for shift targets ('' = none)")
    ap.add_argument("--capture-kind", default="undetected",
                    choices=["undetected", "detected", "none"],
                    help="residual kind to capture on-device as shift "
                         "targets (undetected = codeword events; detected "
                         "= trapping supports, for codes whose floor is "
                         "trapping-driven, e.g. girth-4 WRAN)")
    ap.add_argument("--capture-snr", type=float, default=2.5)
    ap.add_argument("--capture-min", type=int, default=8)
    ap.add_argument("--capture-max-blocks", type=int, default=2_000_000)
    ap.add_argument("--validate-snrs", default="3.5,3.75,4.0,4.25,4.5")
    ap.add_argument("--deep-snrs", default="5.0,5.5,6.0,6.5")
    ap.add_argument("--validate-frames", type=int, default=2_000_000)
    ap.add_argument("--deep-frames", type=int, default=4_000_000)
    ap.add_argument("--pi0", type=float, default=0.2)
    ap.add_argument("--shift", type=float, default=0.5)
    ap.add_argument("--max-support", type=int, default=16)
    ap.add_argument("--out", default="examples/error_floor/importance")
    args = ap.parse_args()

    from ldpc_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu.analysis.failures import collect_failure_patterns
    from ldpc_tpu.analysis.importance import (
        estimate_point,
        make_is_step,
        orbit_supports,
    )
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import load_code

    code = load_code(args.code)
    Z = code.qc.Z
    rate = code.k / code.n
    base = dict(
        matrix=args.code, iterations=args.iterations, ber=True, fer=True,
        fidelity="exact", exact_ber=True, speed=rate,
        schedule=args.schedule, seed=0, quiet=True,
        blocks=args.batch, batch=args.batch,
    )
    opts = SimOptions(**base)
    print(f"# device={jax.devices()[0].device_kind} code={code.name} Z={Z}",
          flush=True)

    # ---- 1. shift targets ----
    cw_supports: list[list[int]] = []
    if args.capture_kind != "none":
        print(f"# capturing {args.capture_kind} residuals at "
              f"{args.capture_snr:g} dB...", flush=True)
        pats, seen, frames = collect_failure_patterns(
            code, opts, args.capture_snr, min_patterns=args.capture_min,
            max_blocks=args.capture_max_blocks,
            max_patterns=2 * args.capture_min,
            kind=args.capture_kind,
        )
        for p in np.asarray(pats):
            sup = np.flatnonzero(p).tolist()
            if 0 < len(sup) <= args.max_support:
                cw_supports.append(sup)
        # dedup identical supports from repeat captures
        cw_supports = [list(s) for s in
                       {tuple(s) for s in cw_supports}]
        print(f"#   {len(cw_supports)} captured supports "
              f"(sizes {sorted(len(s) for s in cw_supports)}) "
              f"from {seen} events / {frames} frames", flush=True)

    ts_supports: list[list[int]] = []
    if args.census and Path(args.census).exists():
        census = json.loads(Path(args.census).read_text())
        ts_supports = [
            r["support"] for r in census.get("recurring_supports", [])
            if 0 < len(r["support"]) <= args.max_support
        ]
    print(f"#   {len(ts_supports)} recurring trapping supports from census",
          flush=True)

    shifts = orbit_supports(cw_supports + ts_supports, Z, code.n,
                            max_components=1024)
    print(f"#   {shifts.shape[0]} mixture components after orbit expansion",
          flush=True)

    step, kernel = make_is_step(code, opts, shifts, pi0=args.pi0,
                                shift=args.shift)
    print(f"# decode kernel: {kernel}", flush=True)

    def run_points(snrs, frames):
        out = []
        for snr in snrs:
            r = estimate_point(
                code, opts, snr, shifts, frames=frames, pi0=args.pi0,
                shift=args.shift, seed=11, step=step,
            )
            print(
                f"  {snr:4.2f} dB: FER {r.fer:.3e} +- {r.fer_std:.1e}  "
                f"WER {r.wer:.3e} +- {r.wer_std:.1e}  "
                f"undet {r.undetected:.3e}  "
                f"(fails {r.fail_frames}, E[w] {r.mean_weight:.3f}, "
                f"max w {r.max_weight:.2f}, {r.frames} frames)",
                flush=True,
            )
            out.append(r.to_dict())
        return out

    # ---- 2. cross-validation vs plain MC ----
    print("# cross-validation against plain MC (examples/error_floor):",
          flush=True)
    val = run_points([float(s) for s in args.validate_snrs.split(",")],
                     args.validate_frames)

    # ---- 3. the deep points ----
    print("# deep points (beyond MC reach):", flush=True)
    deep = run_points([float(s) for s in args.deep_snrs.split(",")],
                      args.deep_frames)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(
        {
            "device": jax.devices()[0].device_kind,
            "code": code.name,
            "kernel": kernel,
            "pi0": args.pi0,
            "shift": args.shift,
            "components": int(shifts.shape[0]),
            "codeword_supports": cw_supports,
            "trapping_supports": ts_supports,
            "validation": val,
            "deep": deep,
        },
        indent=1,
    ))
    print(f"# wrote {out}/results.json", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
