"""Deep-waterfall FER curve + failure-structure profile on one GPU.

Two phases, both far beyond what the reference simulator can reach (it
decodes ~363 info bits/s, so one 1e-7-FER point would take years; see
BASELINE.md):

1. **Curve**: an SNR sweep with per-point early stop (``--target-errors``)
   and a large per-point frame cap, pushing the FER estimate orders of
   magnitude below the reference's ~50-block studies (main.py runs 50-300
   blocks/point; FER resolution ~2e-2).
2. **Profile**: at chosen SNR points, a jitted scan decodes batches and
   histograms the *info-bit error weight* of every failing frame on-device
   (one host fetch per dispatch group), split into
   - detected failures (syndrome check fails): weight structure separates
     near-codeword / trapping-set events (small, repeatable weights) from
     channel noise still overwhelming the decoder (weights concentrated
     near the uncoded error mass), and
   - undetected errors (syndrome passes, bits wrong): decoder converged to
     a DIFFERENT codeword; their weight is bounded below by the minimum
     distance projected on the info positions. The reference's
     failed-frames-only BER accounting scores these as error-free
     (main.py:124-146) -- this profile measures what that convention hides.

Usage (from the repository root, on a GPU):
  python scripts/error_floor.py \
      [--code wimax_576_0.5.alist.txt] [--snr 2.0:4.5:0.25]
      [--target-errors 100] [--max-blocks 200000000]
      [--profile-snrs 3.0,3.5] [--profile-errors 300] [--out examples/error_floor]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import jax

from ldpc_tpu.analysis.failures import (
    collect_failure_patterns,
    profile_sweep,
    trapping_census,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="builtin:wimax_576_0.5.alist.txt")
    ap.add_argument("--snr", default="2.0:4.5:0.25",
                    help="curve grid lo:hi:step (Eb/N0 dB; speed=rate)")
    ap.add_argument("--target-errors", type=int, default=100)
    ap.add_argument("--max-blocks", type=int, default=200_000_000,
                    help="per-point frame cap for the curve")
    ap.add_argument("--profile-snrs", default="3.0,3.5",
                    help="comma list of SNRs for the failure profile")
    ap.add_argument("--profile-errors", type=int, default=300)
    ap.add_argument("--profile-max-blocks", type=int, default=50_000_000)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--out", default="examples/error_floor")
    ap.add_argument("--skip-curve", action="store_true")
    ap.add_argument("--skip-profile", action="store_true",
                    help="curve only (e.g. tail-point re-measurement)")
    ap.add_argument("--census-snr", type=float, default=None,
                    help="Also capture residual patterns at this SNR and "
                         "classify (a,b) trapping-set classes")
    ap.add_argument("--census-patterns", type=int, default=256)
    args = ap.parse_args()

    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import load_code, run_simulation

    code = load_code(args.code)
    rate = code.k / code.n
    lo, hi, step = (float(x) for x in args.snr.split(":"))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    base = dict(
        matrix=args.code,
        iterations=args.iterations,
        ber=True,
        fer=True,
        fidelity="exact",
        exact_ber=True,
        speed=rate,
        schedule=args.schedule,
        seed=0,
    )

    print(f"# device={jax.devices()[0].device_kind} code={code.name} "
          f"k={code.k} rate={rate:g}", flush=True)

    result = None
    if not args.skip_curve:
        opts = SimOptions(
            blocks=args.max_blocks,
            initial_snr=lo, end_snr=hi, step_snr=step,
            target_errors=args.target_errors,
            checkpoint=str(out / "curve.json"),
            resume=True,
            **base,
        )
        result = run_simulation(opts, code)
        result.to_json(str(out / "curve.json"))

    if args.skip_profile:
        return 0

    popts = SimOptions(blocks=4096, batch=4096, **base)
    profiles = profile_sweep(
        code, popts, [float(s) for s in args.profile_snrs.split(",")],
        args.profile_errors, args.profile_max_blocks,
    )

    (out / "failure_profile.json").write_text(json.dumps(profiles, indent=1))
    print(json.dumps(profiles, indent=1))

    if args.census_snr is not None:
        print(f"\ntrapping-set census at {args.census_snr:g} dB", flush=True)
        pats, seen, frames = collect_failure_patterns(
            code, popts, args.census_snr,
            min_patterns=args.census_patterns,
            max_blocks=args.profile_max_blocks,
            max_patterns=args.census_patterns,
        )
        census = trapping_census(pats, code, graph="orig")
        census["snr_db"] = args.census_snr
        census["failures_seen"] = seen
        census["frames"] = frames
        (out / "trapping_census.json").write_text(json.dumps(census, indent=1))
        print(json.dumps(census, indent=1))
    return 0


if __name__ == "__main__":
    main()
