"""Gaussian-process reconstruction of H(z) (counterpart of ``cosmax/gp``)."""

from cosmax_torch.gp.exact_gp import ExactGP, GPParams, fit_gp, reconstruct_hz

__all__ = ["ExactGP", "GPParams", "fit_gp", "reconstruct_hz"]
