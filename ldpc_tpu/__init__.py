"""ldpc_tpu — a TPU-native LDPC link-simulation framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
pure-Python LDPC simulator (omkuprin7/ldpc-simulator): ALIST parity-check
loading, systematic + Richardson-Urbanke encoding, BPSK/QPSK modulation over
AWGN / partial-band / jamming channels, interleaving, iterative sum-product
decoding with syndrome early termination, BER/FER/normalized-LLR statistics,
adaptive rate control, and JSON/CSV/plot export.

Layer map (designed for accelerators, not a port):
  models/   -- code database: ALIST parsing, bit-packed GF(2) linear algebra,
               standard-form + generator construction, Richardson-Urbanke
               decomposition, padded fixed-degree edge layout, matrix catalog.
  ops/      -- batched device compute: GF(2) encode (one matmul), vectorized
               channels + LLR generation, permutation interleavers, flooding
               and layered SPA / min-sum decoders (jnp reference + the QC
               Pallas kernel for GPUs).
  parallel/ -- jax.sharding Mesh construction, sharded Monte-Carlo steps,
               cross-device counter sums for multi-card / multi-host scaling.
  sim/      -- host-side orchestration: SNR sweep runner, adaptive controller,
               results model (JSON/CSV), visualization, CLI.
  utils/    -- PRNG helpers, timing/profiling.
"""

__version__ = "0.1.0"

from ldpc_tpu.models.code import LDPCCode
from ldpc_tpu.models.catalog import MatrixCatalog, MatrixInfo

__all__ = ["LDPCCode", "MatrixCatalog", "MatrixInfo", "__version__"]
