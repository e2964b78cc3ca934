"""Same-LLR decoder comparison vs the reference's SPA_Decoder.

The strongest decoder-parity evidence: generate channel-LLR vectors ONCE,
feed the identical floats to the reference's `SPA_Decoder`
(`python_ldpc_app/spa_decoder.py`, float64 scipy) and to our XLA decoder
under the legacy check rule on the same H_std graph, and compare per-frame
convergence decisions and decoded bits. Extends the round-1 CCSDS(32,16)
experiment to the flagship WiMAX code and to a mode-2 (partial-band
interference) LLR stream.

Also asserts, before decoding anything, that the two implementations build
bit-identical H_std matrices (RREF is canonical).

Usage (from the repository root; CPU is fine):
    python scripts/parity_same_llr.py [--blocks 200]
"""

from __future__ import annotations

import argparse
import os
import sys

REF_APP = "/root/reference/python_ldpc_app"
REF_MATRIX = ("/root/reference/Channel_Codes_Database/Wimax LDPC Codes/"
              "wimax_576_0.5.alist.txt")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=200)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--out", default="parity_runs/same_llr_wimax.json")
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import numpy as np

    sys.path.insert(0, REF_APP)
    from data_buffer import DataBuffer  # noqa: E402 (reference, read-only)
    from encoder_decoder_data import EncoderDecoderData  # noqa: E402
    from settings import Settings  # noqa: E402
    from spa_decoder import SPA_Decoder  # noqa: E402

    ed = EncoderDecoderData(REF_MATRIX)  # builds _h_std/_g in __init__
    st = Settings()
    st.set_max_iterations(args.iterations)
    try:
        st.set_normalized_llr_calculate(False)
    except Exception:
        pass
    ref_dec = SPA_Decoder(ed, st)

    import jax
    import jax.numpy as jnp

    from ldpc_tpu.models.code import LDPCCode
    from ldpc_tpu.models.standards import wimax
    from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
    from ldpc_tpu.ops.encode import make_encoder, random_info_bits
    from ldpc_tpu.ops.spa import make_decoder

    code = LDPCCode(alist=wimax(576, "1/2"), name="wimax_576_0.5")
    n, k = code.n, code.k

    # H_std bit-identity between the two constructions
    ref_hstd = np.zeros((code.m, n), dtype=np.int8)
    sp = ed._h_std.get_sparse_matrix().tocoo()
    ref_hstd[sp.row, sp.col] = 1
    ours_hstd = code.h_std_dense().astype(np.int8)
    assert np.array_equal(ref_hstd, ours_hstd), "H_std mismatch!"
    print(f"H_std bit-identical: {code.m}x{n}, {ref_hstd.sum()} ones")

    spec = code.standard_encode_spec
    info_pos = spec.info_pos("std")
    encode = jax.jit(make_encoder(spec, "std"))
    our_dec = jax.jit(make_decoder(code.layout("std"), info_pos,
                                   args.iterations, "spa", rule="legacy"))

    results = {}
    for tag, params in {
        "mode1_legacy_0dB": ChannelParams(mode=1, snr_db=0.0, speed=1.0,
                                          noise_model="legacy"),
        "mode2_2dB": ChannelParams(mode=2, snr_db=2.0, speed=1.0,
                                   interference_snr_db=10.0, p=0.05),
        "mode3_7dB": ChannelParams(mode=3, snr_db=7.0, speed=1.0,
                                   interference_snr_db=6.0, p=0.1),
    }.items():
        B = args.blocks
        key = jax.random.fold_in(jax.random.key(99), hash(tag) % 1000)
        u = random_info_bits(key, B, k)
        w = encode(u)
        channel = make_channel_fn(params.mode, 1)
        llr = np.asarray(
            channel(jax.random.fold_in(key, 1), w.astype(jnp.float32),
                    params.consts()),
            dtype=np.float64,
        )

        ours = our_dec(jnp.asarray(llr, jnp.float32))
        ours_ok = np.asarray(ours.ok)
        ours_est = np.asarray(ours.est)

        ref_ok = np.zeros(B, bool)
        ref_est = np.zeros((B, n), np.uint8)
        for b in range(B):
            buf = DataBuffer(k)
            buf._channel_data = llr[b].tolist()
            res = ref_dec.decode(buf)
            ref_ok[b] = ref_dec.convergence_iteration >= 0
            # reference stores z (inverted bits); est = z ^ 1 (main.py:329)
            ref_est[b] = 1 - np.asarray(buf._decoded_data[:n], np.uint8)

        frame_agree = int((ref_ok == ours_ok).sum())
        both_ok = ref_ok & ours_ok
        bits_differ = int((ref_est[both_ok] != ours_est[both_ok]).sum())
        # failed frames: decoded bits may differ legitimately (no fixed
        # point); compare them too for the record
        both_fail = ~ref_ok & ~ours_ok
        fail_bits_differ = int((ref_est[both_fail] != ours_est[both_fail]).sum())
        results[tag] = {
            "blocks": B, "frame_agree": frame_agree,
            "ref_ok": int(ref_ok.sum()), "ours_ok": int(ours_ok.sum()),
            "bits_differ_on_ok": bits_differ,
            "bits_differ_on_fail": fail_bits_differ,
            "fail_frames": int(both_fail.sum()),
        }
        print(f"{tag}: frame decisions agree {frame_agree}/{B} "
              f"(ref ok {ref_ok.sum()}, ours ok {ours_ok.sum()}); "
              f"decoded bits differ on OK frames: {bits_differ}; "
              f"on failed frames: {fail_bits_differ} "
              f"({int(both_fail.sum())} frames)", flush=True)

    import json

    json.dump(results, open(args.out, "w"), indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
