"""Samplers and chain diagnostics."""

from cosmax_torch.samplers.diagnostics import (
    autocorr_time,
    effective_samples,
    gelman_rubin,
    percentile_summary,
    split_gelman_rubin,
)
from cosmax_torch.samplers.ensemble import (
    EnsembleSampler,
    MoveSpec,
    default_moves,
    stretch_only,
)
from cosmax_torch.samplers.evidence import SteppingStone, stepping_stone_log_evidence
from cosmax_torch.samplers.hmc import HMCChain, HMCSampler
from cosmax_torch.samplers.optimize import (
    adam_minimize,
    best_fit,
    laplace,
    laplace_fit,
    map_fit,
    map_jitter_init,
    minimize_chi2,
)

__all__ = [
    "EnsembleSampler",
    "HMCChain",
    "HMCSampler",
    "MoveSpec",
    "SteppingStone",
    "default_moves",
    "stepping_stone_log_evidence",
    "stretch_only",
    "adam_minimize",
    "best_fit",
    "map_fit",
    "map_jitter_init",
    "laplace",
    "laplace_fit",
    "minimize_chi2",
    "autocorr_time",
    "effective_samples",
    "gelman_rubin",
    "split_gelman_rubin",
    "percentile_summary",
]
