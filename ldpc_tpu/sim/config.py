"""Simulation configuration.

`SimOptions` is the single options bean: it carries the reference's full flag
surface (`python_ldpc_app/main.py:456-523`, `settings.py:4-89`) plus the
knobs of this framework (decode graph, check-node rule, noise model, decoder
variant, device batch size, PRNG seed). `fidelity` presets bundle the compat quirks:

  'reference' -- decode on H_std with the reference's legacy check-node rule
                 and legacy (sigma^2-as-stddev) noise: BER/FER curves match
                 the reference simulator point-for-point in distribution.
  'exact'     -- decode the original sparse Tanner graph with the correct SPA
                 parity rule and physically calibrated noise: proper LDPC
                 performance (and ~40x fewer edges to process per iteration).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import Enum


class Result(Enum):
    OK = "eOk"
    INVALID_INPUT = "eInvalidInput"
    INVALID_PATH = "eInvalidPath"
    DATA_TRANSFER_NOT_OK = "eDataTransferNotOk"


class InterleaverType(Enum):
    NONE = "eNone"
    REGULAR = "eRegular"
    RANDOM = "eRandom"
    SRANDOM = "eSRandom"


class LDPCDecoderType(Enum):
    BIT_FLIPPING = "eBitFlipping"
    SUM_PRODUCT = "eSumProduct"


class EncodingMethod(Enum):
    STANDARD = "standard"
    RICHARDSON_URBANKE = "richardson_urbanke"


@dataclass
class SimOptions:
    # --- reference flag surface (main.py:456-523) ---
    matrix: str = ""
    blocks: int = 100
    iterations: int = 5
    interleaver: str = "none"  # none | regular | random | srandom | file:<perm.npy>
    decoder: str = "sumproduct"  # sumproduct | bitflipping | minsum | normalized-minsum | offset-minsum
    speed: float = 1.0
    initial_snr: float = 0.0
    end_snr: float = 5.0
    step_snr: float = 0.5
    interference_snr: float = 1.0
    mode: int = 1
    p: float = 0.1
    modulation: int = 1
    s_param: int = 2
    ber: bool = False
    fer: bool = False
    normalized_llr: bool = False
    encoding_method: str = "standard"  # standard | richardson-urbanke
    ru_gap: int | None = None
    threads: int = 1  # accepted for CLI compatibility; ignored (device batch rules)

    # --- adaptive mode (main.py:512-522) ---
    adaptive: bool = False
    adaptive_strategy: str = "threshold"
    matrix_dir: str | None = None
    adaptive_high_ber: float = 1e-2
    adaptive_low_ber: float = 1e-5

    # --- export / plots ---
    output_json: str | None = None
    output_csv: str | None = None
    plot: bool = False
    plot_save: str | None = None

    # --- decode graph, kernel and schedule ---
    fidelity: str = "reference"  # preset: 'reference' | 'exact' (see module doc)
    decode_graph: str | None = None  # 'std' | 'orig' (None -> from fidelity)
    check_rule: str | None = None  # 'legacy' | 'exact' (None -> from fidelity)
    noise_model: str | None = None  # 'legacy' | 'exact' (None -> from fidelity)
    batch: int = 0  # device batch of codewords; 0 -> auto
    # decode kernel: 'auto' picks the QC Pallas kernel (ops.spa_pallas) on a
    # GPU whenever the code is eligible, else the XLA decoder; 'pallas' forces the kernel (and raises where it cannot run);
    # 'xla' forces the XLA decoders
    kernel: str = "auto"
    schedule: str = "flooding"  # 'flooding' (reference schedule) | 'layered' (QC serial-C)
    # layered-sweep row order: 'serial' processes base rows 0..mb-1 (the
    # canonical serial-C order); 'paired' processes disjoint-support row
    # PAIRS per step (models.qc.paired_layer_groups) -- arithmetic-identical
    # to the serial sweep in the flattened pair order (the kernel then needs
    # one barrier per pair instead of per row). A reordered sweep is a
    # DIFFERENT (equally valid) decode schedule, so statistics differ from
    # 'serial' at the MC level; layer_order is part of the checkpoint
    # fingerprint.
    layer_order: str = "serial"  # 'serial' | 'paired'
    seed: int = 0
    exact_ber: bool = False  # also count undetected-error bits (not just failed frames)
    # scalar, or a per-iteration schedule (tuple) -- e.g. a learned one
    # (ldpc_tpu.analysis.learned_minsum); schedules run on every decode
    # path (XLA flooding, XLA layered, the QC kernel) via per-iteration
    # alpha resolution
    minsum_alpha: float | tuple[float, ...] = 0.75
    minsum_beta: float = 0.15
    quiet: bool = False

    # --- checkpoint / observability (absent in the reference, SURVEY.md S5) ---
    checkpoint: str | None = None  # JSON file flushed after every SNR point
    resume: bool = False  # resume a sweep from the checkpoint file
    profile: str | None = None  # jax.profiler trace directory for the sweep

    # --- rate adaptation within one code (absent in the reference) ---
    # shorten: fix the LAST S info bits to zero (known at the receiver);
    # puncture: do not transmit the LAST P parity bits (LLR 0 = erasure).
    # Effective rate: (k - S) / (n - S - P).
    shorten: int = 0
    puncture: int = 0

    # --- sequential Monte-Carlo early stopping (absent in the reference) ---
    # Stop a SNR point once this many frame errors have been observed (the
    # estimator's relative precision is set by the error count, so fixed
    # error targets equalize per-point precision and skip wasted blocks at
    # high SNR). 0 = fixed block count like the reference.
    target_errors: int = 0

    def resolved(self) -> "SimOptions":
        """Fill fidelity-derived fields."""
        if self.fidelity not in ("reference", "exact"):
            raise ValueError(f"Unknown fidelity preset: {self.fidelity}")
        if self.layer_order not in ("serial", "paired"):
            raise ValueError(
                f"layer_order must be 'serial' or 'paired': {self.layer_order!r}"
            )
        if self.layer_order == "paired" and self.schedule != "layered":
            raise ValueError("--layer-order paired requires --schedule layered")
        if self.kernel not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"kernel must be 'auto', 'pallas' or 'xla': {self.kernel!r}"
            )
        exact = self.fidelity == "exact"
        return replace(
            self,
            decode_graph=self.decode_graph or ("orig" if exact else "std"),
            check_rule=self.check_rule or ("exact" if exact else "legacy"),
            noise_model=self.noise_model or ("exact" if exact else "legacy"),
        )

    @property
    def decoder_variant(self) -> str:
        d = self.decoder.lower().replace("_", "-")
        return {
            "sumproduct": "spa",
            "sum-product": "spa",
            "spa": "spa",
            "bitflipping": "bitflipping",
            "bit-flipping": "bitflipping",
            "minsum": "minsum",
            "min-sum": "minsum",
            "normalized-minsum": "normalized_minsum",
            "offset-minsum": "offset_minsum",
        }.get(d, d)

    def auto_batch(self, n: int) -> int:
        """Pick a device batch size: large enough to fill the card, small
        enough to keep message tensors comfortably in device memory."""
        if self.batch > 0:
            return self.batch
        target_elems = 64 << 20  # ~256 MB of f32 messages
        per_cw = max(n * 8, 1)
        b = max(1, target_elems // per_cw)
        return int(min(b, 8192, max(128, self.blocks)))
