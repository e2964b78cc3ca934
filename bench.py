"""Throughput of the Monte-Carlo pipeline at one waterfall point, on a GPU.

The point: WiMAX (1152, 576), exact fidelity (sparse Tanner graph, exact
parity rule, calibrated noise), layered SPA in the paired row order, 12
iterations, Eb/N0 = 2 dB (speed 0.5), batch 4096 -- FER about 6e-3, so
nearly every batch holds a failing frame. The timed path is
``PointExecutor.run_point``, as the CLI drives it: bit generation, encode,
channel, decode, counters back on the host.

    python bench.py          # one JSON line: median-window info bits/s
    python bench.py --ab     # decode kernel A/B: executors with
                             # kernel='xla' and kernel='pallas' timed in
                             # turns (xla, pallas, pallas, xla per round)

Windows are WINDOW batches each, ROUNDS rounds; compile is set-up time,
reported apart. Fails without a GPU. Every number is printed with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

SNR_DB = 2.0
BATCH = 4096
WINDOW = 128  # batches per timed window
ROUNDS = 3  # --ab: 2 windows per kernel each; else windows


def window_stats(times, codewords: int, k: int) -> dict:
    """Median and spread of window times as info bits/s."""
    ts = sorted(times)
    med = statistics.median(ts)
    return {
        "windows": len(ts),
        "median_s": med,
        "min_s": ts[0],
        "max_s": ts[-1],
        "info_bits_per_s": codewords * k / med,
        "info_bits_per_s_range": [codewords * k / ts[-1],
                                  codewords * k / ts[0]],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", action="store_true",
                    help="time kernel='xla' against kernel='pallas'")
    args = ap.parse_args(argv)

    import jax

    from chip_smoke import card_label, require_gpus
    from ldpc_tpu.sim.config import SimOptions
    from ldpc_tpu.sim.runner import PointExecutor, load_code
    from ldpc_tpu.utils.cache import enable_compile_cache

    devices = jax.devices()
    require_gpus(devices)
    enable_compile_cache()
    card = card_label()
    code = load_code("builtin:wimax_1152_0.5.alist.txt")
    codewords = WINDOW * BATCH

    def executor(kernel: str):
        opts = SimOptions(
            matrix="builtin:wimax_1152_0.5.alist.txt", blocks=codewords,
            iterations=12, ber=True, fer=True, fidelity="exact", batch=BATCH,
            seed=0, speed=0.5, schedule="layered", layer_order="paired",
            kernel=kernel, quiet=True,
        )
        ex = PointExecutor(code, opts)
        t0 = time.perf_counter()
        ex.run_point(SNR_DB, BATCH, jax.random.key(99), 0)  # compile
        return ex, time.perf_counter() - t0

    order = ["xla", "pallas", "pallas", "xla"] if args.ab else ["auto"]
    exs = {}
    for kind in dict.fromkeys(order):
        exs[kind], setup = executor(kind)
        print(f"# set-up {kind}: {exs[kind].kernel_used} compiled and "
              f"warmed in {setup:.1f} s", file=sys.stderr)
    times = {kind: [] for kind in exs}
    fails = {kind: 0 for kind in exs}
    w = 0
    for _ in range(ROUNDS if args.ab else 1):
        for kind in (order if args.ab else order * ROUNDS):
            t0 = time.perf_counter()
            s = exs[kind].run_point(SNR_DB, codewords, jax.random.key(0), w)
            times[kind].append(time.perf_counter() - t0)
            fails[kind] += s.fer_frames
            w += 1
    d = devices[0]
    result = {}
    for kind, ts in times.items():
        st = window_stats(ts, codewords, code.k)
        st["fer"] = fails[kind] / (len(ts) * codewords)
        st["kernel_used"] = exs[kind].kernel_used
        result[kind] = st
        print(f"# {kind}: {st['kernel_used']} median {st['median_s']:.4f} s "
              f"per {codewords} codewords, {st['info_bits_per_s']:,.0f} info "
              f"bits/s (windows {st['min_s']:.4f}-{st['max_s']:.4f} s, "
              f"n={st['windows']}), FER {st['fer']:.3e} [{card}]",
              file=sys.stderr)
    head = result["auto"] if "auto" in result else result["pallas"]
    out = {
        "metric": "wimax_1152_576 layered SPA-12 at 2 dB, info bits/s "
                  "(median window, run_point)",
        "value": head["info_bits_per_s"],
        "unit": "info_bits/s",
        "card": card,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
        "runs": result,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
