"""Waterfall atlas: FER/BER curves for every builtin code family.

The reference ships one 50-block demo sweep; its database spans 119 codes
across 9 families that nobody can afford to sweep at 85 bits/s. Here a
20k-block, 6-point waterfall per code is quick, so this script sweeps EVERY
builtin QC code at exact physics (Eb/N0 axis) and renders one FER plot per
family plus a CSV of all points.

Output: examples/family_atlas/{atlas.csv, <family>.png, RESULTS.md}

Usage (from the repository root, on a GPU):
    python scripts/family_atlas.py [--blocks 20000]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from collections import defaultdict


def family_of(name: str) -> str:
    low = name.lower()
    for key in ("wimax", "wifi", "wigig", "wran", "ccsds", "tanner", "bch",
                "itu", "dvb"):
        if key in low:
            return key
    return "other"


def snr_grid(rate: float) -> list[float]:
    """6-point Eb/N0 grid straddling the waterfall for this rate.

    BP thresholds for the builtin families run ~0.8-1 dB at rate 1/2 and
    climb with rate; start slightly below and span ~2.5 dB."""
    base = 0.5 + 4.5 * max(rate - 0.45, 0.0)
    return [round(base + 0.5 * i, 2) for i in range(6)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=20000)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--out-dir", default="examples/family_atlas")
    args = ap.parse_args()

    import jax
    import numpy as np

    from ldpc_tpu.models.standards import builtin_names
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor, load_code

    os.makedirs(args.out_dir, exist_ok=True)
    rows = []
    t0 = time.time()
    names = builtin_names()
    for i, name in enumerate(names):
        code = load_code(f"builtin:{name}")
        if code.qc is None:
            print(f"[{i + 1}/{len(names)}] {name}: not QC, skipped",
                  flush=True)
            continue
        snrs = snr_grid(code.rate)
        batch = min(args.blocks, 8192)
        opts = SimOptions(
            matrix=name, blocks=args.blocks, iterations=args.iterations,
            ber=True, fer=True, fidelity="exact", batch=batch, seed=0,
            speed=code.rate,  # Eb/N0 axis
            schedule="layered" if code.qc.single_diagonal else "flooding",
            quiet=True,
        )
        ex = PointExecutor(code, opts)
        t1 = time.time()
        for p_idx, snr in enumerate(snrs):
            s = ex.run_point(snr, args.blocks, jax.random.key(17), p_idx)
            rows.append({
                "code": name, "family": family_of(name), "n": code.n,
                "k": code.k, "rate": round(code.rate, 4), "snr_db": snr,
                "fer": s.fer_frames / max(s.blocks, 1),
                "ber": s.error_bits / max(s.blocks * code.k, 1),
                "blocks": s.blocks,
            })
        fers = [r["fer"] for r in rows[-len(snrs):]]
        print(f"[{i + 1}/{len(names)}] {name}: rate {code.rate:.2f} "
              f"FER {fers[0]:.3g} -> {fers[-1]:.3g} "
              f"({time.time() - t1:.1f}s)", flush=True)

    with open(os.path.join(args.out_dir, "atlas.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)

    # one FER plot per family
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_family = defaultdict(lambda: defaultdict(list))
    for r in rows:
        by_family[r["family"]][r["code"]].append(r)
    for family, codes in sorted(by_family.items()):
        fig, ax = plt.subplots(figsize=(9, 6))
        for cname, pts in sorted(codes.items()):
            pts = sorted(pts, key=lambda r: r["snr_db"])
            xs = [p["snr_db"] for p in pts]
            # zero-FER points (no failures observed) clamp to the one-failure
            # floor 1/blocks so semilogy keeps the tail visible instead of
            # silently dropping non-positive values
            ys = [max(p["fer"], 1.0 / max(p["blocks"], 1)) for p in pts]
            ax.semilogy(xs, ys, marker="o", markersize=3, linewidth=1,
                        label=cname.replace(".alist.txt", ""))
        ax.set_xlabel("Eb/N0 (dB)")
        ax.set_ylabel("FER")
        ax.set_title(f"{family}: FER waterfalls "
                     f"({args.blocks} blocks/point, layered/flooding SPA-"
                     f"{args.iterations}, exact physics)")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=6, ncol=2)
        fig.tight_layout()
        fig.savefig(os.path.join(args.out_dir, f"{family}.png"), dpi=120)
        plt.close(fig)

    total_min = (time.time() - t0) / 60
    n_codes = len({r["code"] for r in rows})
    n_points = len(rows)
    total_blocks = sum(r["blocks"] for r in rows)
    with open(os.path.join(args.out_dir, "RESULTS.md"), "w") as f:
        f.write(
            "# Builtin-family waterfall atlas\n\n"
            f"{n_codes} QC codes, {n_points} SNR points, "
            f"{total_blocks:,} decoded blocks total, generated in "
            f"{total_min:.1f} min on one {jax.devices()[0].device_kind} "
            "by `scripts/family_atlas.py` (exact physics, Eb/N0 axis via "
            "speed=rate; layered SPA-12 for "
            "single-diagonal codes, flooding for multi-diagonal).\n\n"
            "For scale: the reference simulator at its measured 85 info "
            "bits/s (8 worker processes) would need "
            f"~{total_blocks * 500 / 85 / 86400 / 365:.1f} YEARS for the "
            "same sweep.\n\n"
            "Per-family FER plots: "
            + ", ".join(f"`{fam}.png`" for fam in sorted(by_family))
            + ". Raw points: `atlas.csv`.\n"
        )
    print(f"done: {n_codes} codes, {n_points} points, {total_min:.1f} min")
    return 0


if __name__ == "__main__":
    sys.exit(main())
