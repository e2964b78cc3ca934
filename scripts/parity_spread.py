"""Empirical sampling spread for the reference's small-N parity estimates.

The reference's mode-2/3/QPSK parity runs (parity_runs/ref_*.json) use only
150-200 blocks per SNR point, so their BER/FER estimates carry large
Monte-Carlo error -- and for failed-frames-only BER the error is dominated
by the handful of failed frames, which plain binomial bars understate.

This script reruns OUR simulator at the reference's exact settings
(fidelity=reference) for ``--reps`` independent seeds at the reference's own
block count, yielding the empirical sampling distribution of an N-block
estimate under our channel/decoder model. If the reference's observed value
falls inside the central 95% of that distribution, the two simulators are
statistically indistinguishable at the reference's own precision.

Usage (from the repository root, on a GPU):
    python scripts/parity_spread.py [--reps 30] [--out parity_runs/spread.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


SCENARIOS = {
    # tag -> (ref json, extra SimOptions fields)
    "mode2": ("parity_runs/ref_mode2.json",
              dict(mode=2, p=0.05, interference_snr=10.0)),
    "mode2_deep": ("parity_runs/ref_mode2_deep.json",
                   dict(mode=2, p=0.05, interference_snr=10.0)),
    "mode3": ("parity_runs/ref_mode3.json",
              dict(mode=3, p=0.1, interference_snr=6.0)),
    "qpsk": ("parity_runs/ref_qpsk.json", dict(mode=1, modulation=2)),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default="parity_runs/spread.json")
    ap.add_argument("--scenarios", default=None,
                    help="comma list (default: all whose ref json exists)")
    args = ap.parse_args()

    import jax

    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor, load_code

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    out = {}
    wanted = set(args.scenarios.split(",")) if args.scenarios else None
    for tag, (ref_path, extra) in SCENARIOS.items():
        if wanted is not None and tag not in wanted:
            continue
        if wanted is None and not os.path.exists(ref_path):
            continue  # optional scenario whose reference run is absent
        ref = json.load(open(ref_path))
        n_ref = ref["config"]["blocks"]
        opts = SimOptions(
            matrix="wimax_576_0.5", blocks=n_ref, iterations=5, ber=True,
            fer=True, fidelity="reference", batch=n_ref, quiet=True, **extra
        )
        ex = PointExecutor(code, opts)
        out[tag] = []
        for pt in ref["snr_points"]:
            snr = pt["snr_db"]
            bers, fers = [], []
            for rep in range(args.reps):
                s = ex.run_point(snr, n_ref, jax.random.key(1000 + rep), 0)
                # reference BER convention: failed-frame bits / all info bits
                bers.append(s.error_bits / (s.blocks * code.k))
                fers.append(s.fer_frames / s.blocks)
            bers, fers = np.array(bers), np.array(fers)

            def pctile(x, v):
                return float(np.mean(x <= v))

            row = {
                "snr_db": snr, "n_blocks": n_ref, "reps": args.reps,
                "ref_ber": pt["ber"], "ref_fer": pt["fer"],
                "ber_mean": float(bers.mean()), "ber_sd": float(bers.std()),
                "ber_lo": float(np.quantile(bers, 0.025)),
                "ber_hi": float(np.quantile(bers, 0.975)),
                "fer_mean": float(fers.mean()), "fer_sd": float(fers.std()),
                "fer_lo": float(np.quantile(fers, 0.025)),
                "fer_hi": float(np.quantile(fers, 0.975)),
                "ref_ber_pct": pctile(bers, pt["ber"]),
                "ref_fer_pct": pctile(fers, pt["fer"]),
            }
            out[tag].append(row)
            print(
                f"{tag} snr={snr:5.1f}: ref BER {pt['ber']:.5g} in "
                f"[{row['ber_lo']:.5g}, {row['ber_hi']:.5g}] "
                f"(pct {row['ref_ber_pct']:.2f}); ref FER {pt['fer']:.4g} in "
                f"[{row['fer_lo']:.4g}, {row['fer_hi']:.4g}] "
                f"(pct {row['ref_fer_pct']:.2f})",
                flush=True,
            )

    json.dump(out, open(args.out, "w"), indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
