"""Samplers and chain diagnostics."""

from cosmax_torch.samplers.ensemble import EnsembleSampler

__all__ = ["EnsembleSampler"]
