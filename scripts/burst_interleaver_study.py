"""Interleaving doing PHYSICAL work: mode-2 symbol jamming x 16-QAM.

Motivation: every committed study ran interleaving where it
provably cannot matter (AWGN is i.i.d. per bit, so any permutation leaves
the LLR distribution unchanged -- PARITY.md). The one reference-chain
setting where interleaving CAN change FER is mode-2 partial-band
interference over multi-bit QAM symbols (`channel.py:85-95` +
`interleavers.py:109-174`): a jam draw hits a WHOLE complex symbol
(ops/modem.py jams both I and Q -- all bps bits), so adjacent coded bits
fail together, and Gray mapping gives the bits within a symbol unequal
reliability (MSB > LSB) in a fixed periodic pattern. Interleaving between
the encoder and the symbol mapper decorrelates both structures from the
code's graph.

The study: WiMAX (576, 288), 16-QAM (4 bits/symbol), mode 2 at fixed
(p, interference depth), FER vs Eb/N0 for interleaver in
{none, regular, random, srandom} plus an S-parameter sweep for srandom --
each point to a fixed frame-error target so CIs are comparable. The
reference cannot run this at all: its SRANDOM dispatch silently no-ops
(`data_buffer.py:508-519`) and its channel jams per BIT, which destroys
the very correlation structure interleaving exists to break.

Writes examples/burst_interleaver/{results.json,README.md}.

Usage (from the repository root, on a GPU): python scripts/burst_interleaver_study.py
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path


def adversarial_permutation(code, bps: int, seed: int = 0):
    """pi concentrating each transmitted symbol's bits onto ONE check.

    interleave semantics: out[i] = bits[pi[i]], so transmitted symbol t
    carries code bits pi[bps*t .. bps*t+bps-1]. Assigning those from a
    single check row's variable neighborhood makes every jammed symbol
    wipe ``bps`` inputs of one check simultaneously -- the burst-damage
    concentration that standard interleavers exist to prevent and that
    the QC lift already prevents for the identity order. This is the
    study's positive control: if FER degrades here while none/regular/
    random/s-random agree, the mechanism (symbol bursts x check
    neighborhoods) is real and the null result for standard interleavers
    is a property of the code structure, not a dead channel model.
    """
    import numpy as np

    H = code.H.to_dense()
    m, n = H.shape
    rng = np.random.default_rng(seed)
    neigh = [np.nonzero(H[r])[0].tolist() for r in range(m)]
    for r in range(m):
        rng.shuffle(neigh[r])
    assigned = np.zeros(n, bool)
    pi = []
    order = rng.permutation(m)
    # cycle checks, taking bps unassigned neighbors at a time
    progress = True
    while len(pi) + bps <= n and progress:
        progress = False
        for r in order:
            take = [v for v in neigh[r] if not assigned[v]][:bps]
            if len(take) == bps and len(pi) + bps <= n:
                pi.extend(take)
                assigned[np.asarray(take)] = True
                progress = True
    rest = np.nonzero(~assigned)[0]
    pi.extend(rest.tolist())
    return np.asarray(pi, np.int32)


def wilson(err: int, n: int, z: float = 1.96) -> tuple[float, float]:
    if n == 0:
        return 0.0, 1.0
    p = err / n
    d = 1 + z * z / n
    c = p + z * z / (2 * n)
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (c - h) / d, (c + h) / d


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="examples/burst_interleaver")
    ap.add_argument("--code", default="builtin:wimax_576_0.5.alist.txt")
    ap.add_argument("--snr", default="5.5,5.75,6.0,6.25,6.5",
                    help="Eb/N0 points (dB), speed=rate; CPU probe: FER "
                         "~6e-2 at 6.0 dB, <2e-3 at 7.0 (waterfall)")
    ap.add_argument("--p", type=float, default=0.15,
                    help="per-symbol jam probability")
    ap.add_argument("--interference-snr", type=float, default=-3.0,
                    help="jammer SNR (dB): deep bursts")
    ap.add_argument("--target-errors", type=int, default=800)
    ap.add_argument("--max-blocks", type=int, default=400_000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--s-sweep", default="2,6,10,16")
    args = ap.parse_args()

    from ldpc_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor, load_code

    code = load_code(args.code)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    snrs = [float(s) for s in args.snr.split(",")]
    dev = jax.devices()[0].device_kind
    print(f"# device={dev} code={code.name} 16-QAM mode-2 "
          f"p={args.p} jam_snr={args.interference_snr} dB", flush=True)

    results: dict = {}
    prev = out / "results.json"
    if prev.is_file():
        results = json.loads(prev.read_text()).get("rows", {})

    import numpy as np

    adv_path = out / "adversarial_pi.npy"
    if not adv_path.is_file():
        np.save(adv_path, adversarial_permutation(code, bps=4, seed=7))
    configs = [("none", 2), ("regular", 2), ("random", 2)]
    configs += [("srandom", int(s)) for s in args.s_sweep.split(",")]
    configs += [(f"file:{adv_path}", 2)]

    for il, s_param in configs:
        label = (
            "adversarial" if il.startswith("file:")
            else il if il != "srandom" else f"srandom_S{s_param}"
        )
        if label in results:
            print(f"# {label}: resumed", flush=True)
            continue
        opts = SimOptions(
            matrix=args.code, blocks=args.max_blocks, iterations=12,
            ber=True, fer=True, fidelity="exact", batch=args.batch,
            seed=3, speed=code.k / code.n, schedule="layered",
            mode=2, modulation=16, p=args.p,
            interference_snr=args.interference_snr,
            interleaver=il, s_param=s_param,
            target_errors=args.target_errors, quiet=True,
        )
        ex = PointExecutor(code, opts)
        row = {}
        for i, snr in enumerate(snrs):
            st = ex.run_point(snr, args.max_blocks, jax.random.key(11), i)
            lo, hi = wilson(st.fer_frames, st.blocks)
            row[str(snr)] = {
                "fer": st.fer_frames / st.blocks, "fer_lo": lo,
                "fer_hi": hi, "blocks": st.blocks,
                "errors": st.fer_frames,
            }
            print(f"{label:14s} @ {snr:.2f} dB: FER "
                  f"{st.fer_frames / st.blocks:.3e} "
                  f"[{lo:.3e}, {hi:.3e}] ({st.blocks} blocks, "
                  f"kernel={ex.kernel_used})", flush=True)
        row["kernel"] = ex.kernel_used
        results[label] = row
        (out / "results.json").write_text(json.dumps(
            {"code": code.name, "p": args.p,
             "interference_snr_db": args.interference_snr,
             "modulation": 16, "mode": 2, "device": dev,
             "target_errors": args.target_errors, "rows": results},
            indent=1))
    print(f"# wrote {out}/results.json", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
