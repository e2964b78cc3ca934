"""Cases and the comparison for the family parity tests of the QC decode
kernel (test_qc_kernel_families_layered.py, ..._flooding.py: one file per
schedule so the two run on different test workers).

Each code runs both schedules; the variant rotates over the four the kernel
implements, so the set covers every (family, schedule) pair and every
variant several times. Layered runs in the paired order where the code
pairs. The reference is ops.layered (layered) or ops.spa (flooding) on the
same LLRs; est, ok and conv_iter must be identical.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from ldpc_tpu.models.qc import paired_layer_groups
from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
from ldpc_tpu.ops.encode import make_encoder, random_info_bits
from ldpc_tpu.ops.layered import make_qc_layered_decoder
from ldpc_tpu.ops.spa import make_decoder
from ldpc_tpu.ops.spa_pallas import make_qc_decoder
from ldpc_tpu.sim.runner import load_code

VARIANTS = ("spa", "minsum", "normalized_minsum", "offset_minsum")
# (code, Eb/N0 in dB): operating points where some frames fail and some
# converge within 6 iterations
CODES = [
    ("wimax_576_0.5.alist.txt", 2.0),
    ("wimax_576_0.66B.alist.txt", 3.0),
    ("wimax_576_0.75A.alist.txt", 3.5),
    ("wimax_576_0.75B.alist.txt", 3.5),
    ("wimax_576_0.83.alist.txt", 4.0),
    ("wifi_648_r083.alist.txt", 4.0),
    ("wigig_R05_N672_K336.alist.txt", 2.0),
    ("wigig_R063_N672_K420.alist.txt", 3.0),
    ("wigig_R075_N672_K504.alist.txt", 3.5),
    ("ieee_802_11ad_p42_n672_r081.alist.txt", 4.0),
    ("WRAN_N384_K192_P16_R05.txt", 2.0),
    ("CCSDS_ldpc_n128_k64.alist.txt", 3.0),  # multi-diagonal blocks
    ("LDPC_N336_K196_ITU_G.h.alist.txt", 3.0),
    ("Tanner_155_64.alist.txt", 3.0),  # Z=31, not a power of two
]


def cases(schedule: str):
    j = ("layered", "flooding").index(schedule)
    return [
        pytest.param(name, snr, VARIANTS[(i + 2 * j) % 4],
                     id=name.split(".alist")[0])
        for i, (name, snr) in enumerate(CODES)
    ]


def check_kernel_matches_plain_decoder(name, snr, schedule, variant):
    code = load_code("builtin:" + name)
    spec = code.standard_encode_spec
    info = spec.info_pos("orig")
    key = jax.random.key(11)
    w = make_encoder(spec, "orig")(random_info_bits(key, 24, code.k))
    rate = code.k / code.n
    llr = make_channel_fn(1, 1)(
        jax.random.fold_in(key, 1), w,
        ChannelParams(snr_db=snr, speed=rate, noise_model="exact").consts(),
    )
    groups = None
    if schedule == "layered":
        groups = paired_layer_groups(code.qc)
        if all(len(g) == 1 for g in groups):
            groups = None
    if schedule == "layered":
        ref = make_qc_layered_decoder(
            code.qc, info, 6, variant,
            layer_order=None if groups is None else sum(groups, []),
        )
    else:
        ref = make_decoder(code.layout("orig"), info, 6, variant,
                           rule="exact")
    ker = make_qc_decoder(code.qc, info, 6, variant, schedule=schedule,
                          layer_groups=groups, tile_b=8, interpret=True)
    r1 = jax.jit(ref)(llr)
    r2 = jax.jit(ker)(llr)
    assert np.array_equal(np.asarray(r1.ok), np.asarray(r2.ok))
    assert np.array_equal(np.asarray(r1.est), np.asarray(r2.est))
    assert np.array_equal(np.asarray(r1.conv_iter), np.asarray(r2.conv_iter))
    np.testing.assert_allclose(np.asarray(r1.norm_llr),
                               np.asarray(r2.norm_llr), atol=1e-6)
    # the point exercises the decoder: not everything converges at once
    conv = np.asarray(r1.conv_iter)
    assert (conv != 0).any()
