"""Scalar Gaussian priors used as anchor terms (counterpart of
``cosmax/likelihoods/priors.py``).

Ported so far: the generic scalar prior and the Planck Omega_m h^2
prior 0.1430 +- 0.0011 (reference bao/desi_omh2.py:17-18,
cosmic_chronometers/cc.py:18-19) that ``cc.cc`` carries. The Om h^2
prior's meta (``scalar_prior``: the quantity, its mean and sigma, and
the parameters it reads) is what the fused log-prob kernel's packer
takes. The BBN omega_b priors come with the presets that use them
(ROADMAP.md queue 1, item 10).
"""

from cosmax_torch.likelihoods.base import Term

OMH2_PLANCK = (0.1430, 0.0011)


def gaussian_prior_term(fn, mean: float, sigma: float, name: str, meta=None) -> Term:
    """chi^2 = ((mean - fn(p)) / sigma)^2."""

    def chi2(p):
        return ((mean - fn(p)) / sigma) ** 2

    return Term(name=name, chi2=chi2, meta=dict(meta or {}, n=1))


def omh2_term(param_h0: str = "H0", param_om: str = "Om") -> Term:
    """Planck Omega_m h^2 prior (bao/desi_omh2.py:87-93)."""
    mean, sigma = OMH2_PLANCK
    return gaussian_prior_term(
        lambda p: p[param_om] * (p[param_h0] / 100.0) ** 2, mean, sigma, "omh2",
        meta=dict(scalar_prior=dict(quantity="omh2", mean=mean, sigma=sigma, h0=param_h0,
                                    om=param_om)),
    )
