"""Batched GF(2) systematic encoding as one matrix product.

The reference encodes one codeword at a time with a scipy sparse
matrix-vector product (`python_ldpc_app/data_buffer.py:47-82`). Here a whole
batch of info words is encoded with one dense f32 matmul -- ``parity =
(u @ P) mod 2`` is exact for k < 2^24 when the product accumulates in f32,
including on a GPU whose f32 matmul runs in TF32: the operands are 0/1,
which TF32 holds exactly -- followed by a static column gather into the
decode domain. Both the standard generator
(G = [I_k | A^T]) and the Richardson-Urbanke encoder lower to the same form
(see ldpc_tpu.models.code.EncodeSpec).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def make_encoder(spec, graph: str = "orig"):
    """Build ``encode(u: uint8/f32 [B, k]) -> float32 [B, n]`` for an EncodeSpec.

    The returned function is jit-compatible and vmap/pjit friendly; the
    parity-generator and domain map are closed-over constants.
    """
    P = jnp.asarray(np.asarray(spec.P, dtype=np.float32))  # [k, n-k]
    domain_map = jnp.asarray(spec.domain_map(graph))  # int32 [n]

    def encode(u: jax.Array) -> jax.Array:
        u_f = u.astype(jnp.float32)
        # Exact GF(2) matmul: entries of u @ P are integers <= k < 2^24.
        parity = jnp.dot(u_f, P, preferred_element_type=jnp.float32)
        parity = jnp.mod(parity, 2.0)
        x = jnp.concatenate([u_f, parity], axis=-1)  # assembled [u, parity]
        return jnp.take(x, domain_map, axis=-1)

    return encode


def random_info_bits(key: jax.Array, batch: int, k: int) -> jax.Array:
    """Uniform random info bits [batch, k] as uint8 (generator.py:7-9 analogue).

    Bit-packed: one threefry word yields 32 bits (bernoulli would burn a
    whole uint32 per bit).
    """
    words = (k + 31) // 32
    raw = jax.random.bits(key, (batch, words), dtype=jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((raw[..., None] >> shifts) & 1).astype(jnp.uint8)
    return bits.reshape(batch, words * 32)[:, :k]
