"""Likelihood terms and their composition into a log-probability."""

from cosmax_torch.likelihoods.base import ParamSpec, Term, make_chi2_breakdown, make_log_prob

__all__ = ["ParamSpec", "Term", "make_chi2_breakdown", "make_log_prob"]
