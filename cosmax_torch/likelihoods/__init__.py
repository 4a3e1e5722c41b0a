"""Likelihood terms and their composition into a log-probability. The
probe modules of ``__all__`` load on first use, so that importing one term
does not import them all."""

import importlib

from cosmax_torch.likelihoods.base import ParamSpec, Term, make_chi2_breakdown, make_log_prob

_SUBMODULES = ("bao", "sn", "cmb", "cc", "quasars", "fs8", "priors")
__all__ = ["ParamSpec", "Term", "make_log_prob", "make_chi2_breakdown", *_SUBMODULES]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
