"""Close the IS dictionary loop at depth.

The committed WRAN study's dictionary was harvested at a single plain-MC
SNR (4.25 dB); events that only dominate deeper are invisible to that
capture. This script harvests failure residuals FROM the IS sampler itself
at deep SNRs (ldpc_tpu.analysis.importance.harvest_failures), folds the new
supports into the dictionary, and re-estimates the deep points -- the
stationarity of the estimates under depth-harvested events is the
convergence evidence the study's own argument assumes.

Reads the committed dictionary from a prior importance results.json
(codeword_supports + trapping_supports), so the baseline column is exactly
the committed study's.

Usage (from the repository root, on a GPU):
  python scripts/is_depth_harvest.py \
      --code builtin:WRAN_N384_K192_P16_R05.txt \
      --base examples/error_floor/wran384/importance/results_dict114.json \
      --harvest-snrs 5.5,6.0 --eval-snrs 5.0,5.5,6.0 \
      --out examples/error_floor/wran384/importance/results_depth.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import jax

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="builtin:WRAN_N384_K192_P16_R05.txt")
    ap.add_argument("--base",
                    default="examples/error_floor/wran384/importance/"
                            "results_dict114.json")
    ap.add_argument("--harvest-snrs", default="5.5,6.0")
    ap.add_argument("--harvest-frames", type=int, default=2_000_000)
    ap.add_argument("--eval-snrs", default="5.0,5.5,6.0")
    ap.add_argument("--eval-frames", type=int, default=4_000_000)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--max-support", type=int, default=24)
    ap.add_argument("--max-components", type=int, default=4096)
    ap.add_argument("--out",
                    default="examples/error_floor/wran384/importance/"
                            "results_depth.json")
    args = ap.parse_args()

    from ldpc_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu.analysis.importance import (
        estimate_point,
        harvest_failures,
        make_is_step,
        orbit_supports,
    )
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import load_code

    base = json.loads(Path(args.base).read_text())
    base_supports = [list(s) for s in base["codeword_supports"]] + \
        [list(s) for s in base["trapping_supports"]]
    pi0 = base["pi0"]
    shift = base["shift"]

    code = load_code(args.code)
    Z = code.qc.Z
    opts = SimOptions(
        matrix=args.code, iterations=args.iterations, ber=True, fer=True,
        fidelity="exact", exact_ber=True, speed=code.k / code.n,
        schedule=args.schedule, seed=0, quiet=True,
        blocks=args.batch, batch=args.batch,
    )
    print(f"# device={jax.devices()[0].device_kind} code={code.name} Z={Z}; "
          f"base dictionary: {len(base_supports)} supports "
          f"({base['components']} components, pi0={pi0}, shift={shift})",
          flush=True)

    shifts0 = orbit_supports(base_supports, Z, code.n,
                             max_components=args.max_components)
    print(f"# rebuilt base mixture: {shifts0.shape[0]} components",
          flush=True)

    # ---- harvest at depth, from the biased sampler's own failures ----
    harvested: list[list[int]] = []
    for snr in (float(s) for s in args.harvest_snrs.split(",")):
        harvested += harvest_failures(
            code, opts, shifts0, snr, frames=args.harvest_frames,
            pi0=pi0, shift=shift, max_support=args.max_support,
            min_count=2, top=64,
        )
    harvested = [list(s) for s in {tuple(s) for s in harvested}]
    print(f"# {len(harvested)} distinct harvested supports", flush=True)

    shifts1 = orbit_supports(base_supports + harvested, Z, code.n,
                             max_components=args.max_components)
    new_components = shifts1.shape[0] - shifts0.shape[0]
    print(f"# folded mixture: {shifts1.shape[0]} components "
          f"(+{new_components} new; orbit-deduped)", flush=True)

    # ---- re-estimate the deep points under BOTH dictionaries ----
    # (the committed study capped orbit expansion at 1024 components; the
    # uncapped base here isolates the harvest's contribution from the
    # cap-lift's, so the stationarity claim compares like with like)
    snrs = [float(s) for s in args.eval_snrs.split(",")]
    step0, kernel = make_is_step(code, opts, shifts0, pi0=pi0, shift=shift)
    base_rows = []
    for snr in snrs:
        r = estimate_point(code, opts, snr, shifts0,
                           frames=args.eval_frames, pi0=pi0, shift=shift,
                           seed=11, step=step0)
        base_rows.append(r.to_dict())
        print(f"  base-dict  {snr:4.2f} dB: FER {r.fer:.3e} +- {r.fer_std:.1e} "
              f"(fails {r.fail_frames}, max w {r.max_weight:.2f})",
              flush=True)
    step1, _ = make_is_step(code, opts, shifts1, pi0=pi0, shift=shift)
    rows = []
    for snr in snrs:
        r = estimate_point(code, opts, snr, shifts1,
                           frames=args.eval_frames, pi0=pi0, shift=shift,
                           seed=11, step=step1)
        rows.append(r.to_dict())
        print(f"  depth-dict {snr:4.2f} dB: FER {r.fer:.3e} +- {r.fer_std:.1e} "
              f"(fails {r.fail_frames}, max w {r.max_weight:.2f})",
              flush=True)

    Path(args.out).write_text(json.dumps({
        "device": jax.devices()[0].device_kind,
        "code": code.name,
        "kernel": kernel,
        "base_results": args.base,
        "pi0": pi0, "shift": shift,
        "base_components": int(shifts0.shape[0]),
        "harvest_snrs": args.harvest_snrs,
        "harvest_frames": args.harvest_frames,
        "harvested_supports": harvested,
        "components": int(shifts1.shape[0]),
        "deep_base_uncapped": base_rows,
        "deep": rows,
    }, indent=1))
    print(f"# wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
