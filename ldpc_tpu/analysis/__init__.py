"""Analysis tools: density evolution, EXIT charts, thresholds, failure
profiling, importance-sampled error floors."""

from ldpc_tpu.analysis.density_evolution import (
    bec_erasure_fixed_point,
    bec_threshold,
    de_error_probability,
    protograph_threshold,
    regular_protograph,
)
from ldpc_tpu.analysis.failures import (
    collect_failure_patterns,
    make_pattern_profiler,
    make_profiler,
    profile_point,
    profile_sweep,
    trapping_census,
    weight_summary,
)
from ldpc_tpu.analysis.graph_stats import (
    degree_histograms,
    girth,
    graph_stats,
)
from ldpc_tpu.analysis.learned_minsum import (
    evaluate_alphas,
    make_unrolled_minsum,
    train_alphas,
)
from ldpc_tpu.analysis.exit import (
    cnd_curve,
    edge_degree_distributions,
    exit_curves,
    exit_threshold,
    j_function,
    j_inverse,
    tunnel_gap,
    vnd_curve,
)
from ldpc_tpu.analysis.importance import (
    ISResult,
    estimate_point,
    make_is_step,
    orbit_supports,
)

__all__ = [
    "bec_erasure_fixed_point",
    "bec_threshold",
    "de_error_probability",
    "protograph_threshold",
    "regular_protograph",
    "cnd_curve",
    "edge_degree_distributions",
    "exit_curves",
    "exit_threshold",
    "j_function",
    "j_inverse",
    "tunnel_gap",
    "vnd_curve",
    "degree_histograms",
    "girth",
    "graph_stats",
    "evaluate_alphas",
    "make_unrolled_minsum",
    "train_alphas",
    "collect_failure_patterns",
    "make_pattern_profiler",
    "make_profiler",
    "profile_point",
    "profile_sweep",
    "trapping_census",
    "weight_summary",
    "ISResult",
    "estimate_point",
    "make_is_step",
    "orbit_supports",
]
