"""Tests that need the card: the QC kernel compiled for the GPU (no
interpreter) on codes beyond the WiMAX (1152, 576) one of chip_smoke.py's
parity phase: a wide-row code on 16 warps, and a Z=384 lift. chip_smoke.py
runs this file on the card (its gpu-tests phase); elsewhere the tests
skip."""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

BATCH = 512
BIG = os.path.join(os.path.dirname(__file__), "..", "examples", "big_code",
                   "wimax_like_n9216_z384.alist.txt")
# name -> (matrix, Eb/N0 near the code's waterfall, pick_tile's tile)
CODES = {
    "wimax_2304_0.83": ("builtin:wimax_2304_0.83.alist.txt", 3.75, (8, 16)),
    "wimax_like_n9216_z384": (BIG, 1.5, (8, 8)),
}


@functools.lru_cache(maxsize=None)
def _code(name):
    from ldpc_tpu.sim.runner import load_code

    return load_code(CODES[name][0])


@pytest.mark.parametrize("name,schedule,variant", [
    ("wimax_2304_0.83", "layered", "spa"),
    ("wimax_2304_0.83", "flooding", "minsum"),
    ("wimax_like_n9216_z384", "layered", "spa"),
])
def test_compiled_kernel_at_fit_rule_tile(gpu_device, name, schedule,
                                          variant):
    from ldpc_tpu.models.qc import paired_layer_groups
    from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
    from ldpc_tpu.ops.layered import make_qc_layered_decoder
    from ldpc_tpu.ops.spa import make_decoder
    from ldpc_tpu.ops.spa_pallas import make_qc_decoder, pick_tile

    code = _code(name)
    plan = pick_tile(code.qc)
    assert (plan.tile_b, plan.num_warps) == CODES[name][2]
    info = np.arange(code.k)  # only the normalized LLR reads it
    consts = ChannelParams(snr_db=CODES[name][1], speed=code.k / code.n,
                           noise_model="exact").consts()
    with jax.default_device(gpu_device):
        # the all-zero codeword: the decoders are symmetric in it
        llr = make_channel_fn(1, 1)(
            jax.random.key(2), jnp.zeros((BATCH, code.n), jnp.float32),
            consts).astype(jnp.float32)
        groups = paired_layer_groups(code.qc) if schedule == "layered" else None
        if schedule == "layered":
            ref = make_qc_layered_decoder(code.qc, info, 12, variant,
                                          layer_order=sum(groups, []))
        else:
            ref = make_decoder(code.layout("orig"), info, 12, variant,
                               rule="exact")
        ker = make_qc_decoder(code.qc, info, 12, variant, schedule=schedule,
                              layer_groups=groups)
        r1, r2 = jax.jit(ref)(llr), jax.jit(ker)(llr)
    ok1, ok2 = np.asarray(r1.ok), np.asarray(r2.ok)
    assert 0 < ok1.sum() < BATCH or variant != "spa"  # a waterfall point
    same = ((ok1 == ok2)
            & (np.asarray(r1.est) == np.asarray(r2.est)).all(axis=1)
            & (np.asarray(r1.conv_iter) == np.asarray(r2.conv_iter)))
    assert same.mean() >= (0.99 if variant == "spa" else 1.0)
