"""Exact-noise replay parity for channel mode 3 (barrage jamming).

With ``--threads 1`` the reference creates its Channel ONCE per SNR point
(`main.py:214-218`) and the two Park-Miller LCGs (IDUM1/IDUM2,
`constants.py:2-3`) advance continuously across blocks -- so the ENTIRE
noise sequence of a B-block mode-3 run is deterministic: block b consumes
Box-Muller calls [b*n, (b+1)*n) of each stream, with the cos/sin branch
picked by the bit index within the block (`generator.py:24-32`). The only
randomness in the reference run is the data bits.

This script replays that exact noise sequence with
ldpc_tpu.utils.legacy_rng (bit-exact LCG + Box-Muller), decodes ``--reps``
random codewords against EVERY one of the B fixed noise rows with the
fidelity=reference decoder (H_std graph, legacy check rule), and reports
E[FER], E[BER | failed-frames accounting] conditioned on the reference's
own noise realization. Agreement is then limited only by the reference's
info-bit sampling error -- the noise-ensemble component of the Monte-Carlo
variance is eliminated entirely.

(Mode 2 is not exactly replayable: its jam decisions come from a
time-seeded numpy RNG (`channel.py:30,85-89`) and gate the second LCG's
consumption; mode-2 parity evidence is distributional -- see
scripts/parity_spread.py.)

Usage (from the repository root, on a GPU):
    python scripts/parity_fixed_noise.py [--reps 100]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100,
                    help="random codewords per fixed noise row")
    ap.add_argument("--out", default="parity_runs/fixed_noise.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ldpc_tpu.models.code import LDPCCode
    from ldpc_tpu.models.standards import wimax
    from ldpc_tpu.ops.channel import ChannelParams
    from ldpc_tpu.ops.encode import make_encoder, random_info_bits
    from ldpc_tpu.ops.spa import make_decoder
    from ldpc_tpu.utils.legacy_rng import IDUM1, IDUM2, ParkMillerGauss

    code = LDPCCode(alist=wimax(576, "1/2"), name="wimax_576_0.5")
    n, k = code.n, code.k
    spec = code.standard_encode_spec
    info_pos = np.asarray(spec.info_pos("std"))
    encode = jax.jit(make_encoder(spec, "std"))
    dec = jax.jit(make_decoder(code.layout("std"), info_pos, 5, "spa",
                               rule="legacy"))

    ref3 = json.load(open("parity_runs/ref_mode3.json"))
    B = ref3["config"]["blocks"]
    R = args.reps
    results = []
    for pt in ref3["snr_points"]:
        snr = pt["snr_db"]
        prm = ChannelParams(mode=3, snr_db=snr, speed=1.0,
                            interference_snr_db=6.0, p=0.1)
        # continuous streams across all B blocks: call index = b*n + i,
        # branch parity = i % 2 (bit index restarts per block; n is even so
        # the parity pattern aligns)
        g1 = ParkMillerGauss(IDUM1, prm.sigma1)
        g2 = ParkMillerGauss(IDUM2, prm.sigma2)
        n1 = g1.gauss_sequence(B * n).reshape(B, n)
        n2 = g2.gauss_sequence(B * n).reshape(B, n)
        noise = jnp.asarray((n1 + prm.p * n2) * prm.l_c3, jnp.float32)

        fer_num = 0
        err_bits = 0
        for rep in range(R):
            key = jax.random.fold_in(jax.random.key(123), rep)
            u = random_info_bits(key, B, k)
            w = encode(u)
            sym = 2.0 * w.astype(jnp.float32) - 1.0
            llr = sym * np.float32(prm.l_c3) + noise
            r = dec(llr)
            ok = np.asarray(r.ok)
            u_hat = np.asarray(r.est)[:, info_pos]
            fer_num += int((~ok).sum())
            err_bits += int(((u_hat != np.asarray(u)) & ~ok[:, None]).sum())
        fer = fer_num / (B * R)
        ber = err_bits / (B * R * k)
        # residual comparison error: the reference's info-bit sampling only,
        # approximated by the binomial SE of its B-block FER estimate
        se = math.sqrt(max(fer * (1 - fer), 1e-12) / B)
        z = (pt["fer"] - fer) / max(se, 1e-9)
        results.append({"snr_db": snr, "ref_fer": pt["fer"],
                        "ref_ber": pt["ber"], "fer": fer, "ber": ber,
                        "z_fer": z, "reps": R, "blocks": B})
        print(f"mode3 snr={snr:4.1f}: ref FER {pt['fer']:.4g} BER "
              f"{pt['ber']:.5g} | exact-noise replay FER {fer:.4g} BER "
              f"{ber:.5g} (z_FER={z:+.2f})", flush=True)

    json.dump(results, open(args.out, "w"), indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
