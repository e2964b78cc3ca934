"""Capture undetected-error residuals and verify them as d_min witnesses.

An undetected error is a frame whose syndrome passes but whose info bits are
wrong: the decoder converged to a DIFFERENT codeword, so the residual
e = est XOR transmitted is itself a nonzero codeword and wt(e) is an upper
bound on the code's minimum distance. The reference's failed-frames-only BER
accounting scores these frames as error-free (main.py:124-146) and cannot
produce this analysis; here the capture runs on-device
(ldpc_tpu.analysis.failures.collect_failure_patterns, kind='undetected')
and the verification is exact GF(2) arithmetic on the host:

  1. every captured residual is checked against the ORIGINAL H
     (code.syndrome_orig(e) == 0  ->  e is a codeword);
  2. residuals are grouped into QC orbits: for a quasi-cyclic code with
     lift Z, simultaneously cyclically shifting every length-Z block of a
     codeword by the same s yields another codeword, so distinct events
     that are block-shifts of one another are ONE structural object.

Usage (from the repository root, on a GPU):
  python scripts/undetected_witness.py \
      --code builtin:wimax_1152_0.5.alist.txt --snrs 2.75,3.0 \
      --min-patterns 6 --max-blocks 80000000 \
      --out examples/error_floor/wimax1152/undetected_codewords.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ldpc_tpu.analysis.failures import collect_failure_patterns


def qc_orbit_canonical(support, Z):
    """Alias of models.qc.qc_orbit_canonical (shared with the IS depth
    harvest so both studies' orbit keys are identical by construction)."""
    from ldpc_tpu.models.qc import qc_orbit_canonical as canon

    return canon(support, Z)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="builtin:wimax_1152_0.5.alist.txt")
    ap.add_argument("--snrs", default="2.75,3.0")
    ap.add_argument("--min-patterns", type=int, default=6,
                    help="target events per SNR point")
    ap.add_argument("--max-blocks", type=int, default=80_000_000,
                    help="frame cap per SNR point")
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out",
                    default="examples/error_floor/wimax1152/"
                            "undetected_codewords.json")
    args = ap.parse_args()

    import jax

    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor, load_code

    code = load_code(args.code)
    qc = code.qc
    Z = qc.Z if qc is not None else 0
    opts = SimOptions(
        matrix=args.code,
        blocks=args.batch, batch=args.batch,
        iterations=args.iterations,
        schedule=args.schedule,
        ber=True, fer=True,
        fidelity="exact",
        exact_ber=True,           # required: undetected frames keep error_bits
        speed=code.k / code.n,
        seed=0,
    )
    ex = PointExecutor(code, opts)
    print(f"# device={jax.devices()[0].device_kind} code={code.name} "
          f"n={code.n} k={code.k} Z={Z}", flush=True)

    out: dict = {
        "code": code.name, "n": code.n, "k": code.k, "Z": Z,
        "iterations": args.iterations, "schedule": args.schedule,
        "points": [],
    }
    all_weights: list[int] = []
    orbits: dict[tuple, dict] = {}
    for i, s in enumerate(float(x) for x in args.snrs.split(",")):
        pats, seen, frames = collect_failure_patterns(
            code, opts, s, min_patterns=args.min_patterns,
            max_blocks=args.max_blocks, max_patterns=64,
            executor=ex, point_index=i, kind="undetected",
        )
        events = []
        for e in pats:
            w = int(e.sum())
            syn = int(code.syndrome_orig(e).sum())
            support = np.flatnonzero(e)
            events.append({
                "weight": w,
                "is_codeword": bool(w > 0 and syn == 0),
                "unsatisfied_checks": syn,
                "support": [int(p) for p in support],
            })
            all_weights.append(w)
            if Z:
                canon = qc_orbit_canonical(support, Z)
                rec = orbits.setdefault(
                    canon, {"weight": w, "count": 0, "snrs": []}
                )
                rec["count"] += 1
                rec["snrs"].append(s)
        out["points"].append({
            "snr_db": s, "frames": frames, "events_seen": seen,
            "events_captured": len(events),
            "undetected_rate": seen / frames if frames else None,
            "events": events,
        })
        print(f"  {s:g} dB: {seen} events / {frames:,} frames; "
              f"weights {sorted(e['weight'] for e in events)}", flush=True)

    if all_weights:
        out["min_weight"] = int(min(all_weights))
        out["d_min_upper_bound"] = int(min(all_weights))
    out["all_codewords"] = all(
        e["is_codeword"] for p in out["points"] for e in p["events"]
    )
    if Z:
        out["qc_orbits"] = [
            {"weight": v["weight"], "count": v["count"], "snrs": v["snrs"],
             "canonical_support": list(k)}
            for k, v in sorted(orbits.items(), key=lambda kv: kv[1]["weight"])
        ]
        print(f"# {len(orbits)} distinct QC orbits among "
              f"{len(all_weights)} events", flush=True)

    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"# wrote {path}; d_min <= {out.get('d_min_upper_bound')}",
          flush=True)
    return 0


if __name__ == "__main__":
    main()
