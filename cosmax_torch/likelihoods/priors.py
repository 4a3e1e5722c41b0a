"""Scalar Gaussian priors used as anchor terms (counterpart of
``cosmax/likelihoods/priors.py``).

* BBN omega_b priors (three published variants): chen arXiv:2509.11743
  (0.02232 +- 0.00033), cyril arXiv:1801.08023 (0.02190 +- 0.00025),
  shonberg arXiv:2401.15054 (0.02218 +- 0.00055);
* the Planck Omega_m h^2 prior 0.1430 +- 0.0011 (reference
  bao/desi_omh2.py:17-18, cosmic_chronometers/cc.py:18-19).

Each prior's meta (``scalar_prior``: the quantity, its mean and sigma,
and the parameters it reads) is what the fused log-prob kernel's packer
takes. The Schoneberg 2 x 2 (omega_b, N_eff) prior, which no preset
uses, is not ported (ROADMAP.md queue 1, item 10c).
"""

from cosmax_torch.likelihoods.base import Term

BBN_PRIORS = {
    "chen": (0.02232, 0.00033),
    "cyril": (0.02190, 0.00025),
    "shonberg": (0.02218, 0.00055),
}
OMH2_PLANCK = (0.1430, 0.0011)
THETA_100_PLANCK = (1.04110, 0.00031)


def gaussian_prior_term(fn, mean: float, sigma: float, name: str, meta=None) -> Term:
    """chi^2 = ((mean - fn(p)) / sigma)^2."""

    def chi2(p):
        return ((mean - fn(p)) / sigma) ** 2

    return Term(name=name, chi2=chi2, meta=dict(meta or {}, n=1))


def bbn_term(variant: str = "cyril", param: str = "Obh2") -> Term:
    """A BBN prior on the sampled omega_b ``param``."""
    mean, sigma = BBN_PRIORS[variant]
    return gaussian_prior_term(
        lambda p: p[param], mean, sigma, f"bbn_{variant}",
        meta=dict(scalar_prior=dict(quantity="obh2", mean=mean, sigma=sigma, param=param)),
    )


def omh2_term(param_h0: str = "H0", param_om: str = "Om") -> Term:
    """Planck Omega_m h^2 prior (bao/desi_omh2.py:87-93)."""
    mean, sigma = OMH2_PLANCK
    return gaussian_prior_term(
        lambda p: p[param_om] * (p[param_h0] / 100.0) ** 2, mean, sigma, "omh2",
        meta=dict(scalar_prior=dict(quantity="omh2", mean=mean, sigma=sigma, h0=param_h0,
                                    om=param_om)),
    )
