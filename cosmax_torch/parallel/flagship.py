"""Mesh-sharded joint log-probability for large-covariance fits
(counterpart of ``cosmax/parallel/flagship.py``).

Splits a ``FitSpec``'s terms into cheap terms (BAO, CMB, priors),
evaluated on this rank's walkers, and large-N Gaussian terms (SN
compilations with ~1800^2 whiteners), whose chi^2 runs through
``data_sharded_chi2``: each rank of 'd' forms its slab's share with the
chi^2 kernel's row-block entry, and the shares are summed over 'd'. The
walkers are split over the walker axes and are the same on every rank of
'd'. A fast preset has no large term (its SN term is emulated): its
walkers are then split over every dim, 'd' included
(``sharded_batched_log_prob``), and every rank makes one fused launch on
its own block.
"""

from dataclasses import replace

from cosmax_torch.likelihoods.base import autograd_value_and_grad, make_log_prob, walker_chunk
from cosmax_torch.parallel.mesh import data_sharded_chi2, sharded_batched_log_prob


def _sharded_terms(fit, mesh, big_n_threshold):
    """The fit's terms with each large SN term's chi^2 split over 'd', or
    None when no term is large."""
    def shard(term):
        chi2 = data_sharded_chi2(term.meta["constants"]["linv"], mesh, fit.dtype)
        values, theory_mag = term.meta["constants"]["values"], term.meta["theory_mag"]
        return replace(term, chi2=lambda p: chi2(values - theory_mag(p)))

    # the dense SN terms (an emulated one has a theory_mag hook too, for
    # plots, but no whitener)
    big = [t for t in fit.terms if t.meta.get("method") == "dense" and "theory_mag" in t.meta
           and t.meta["n"] > big_n_threshold]
    if not big:
        return None
    return [shard(t) if t in big else t for t in fit.terms]


def build_sharded_log_prob(fit, mesh, big_n_threshold: int = 100):
    """Batched ``log_prob(walkers [W_local, D]) -> [W_local]`` of this
    rank's walker block, each large SN whitening split over 'd'. The terms
    run over the walker chunks of ``make_log_prob`` (the same on every rank
    of 'd'); out-of-box and non-finite rows map to -inf. With no large
    term, the block is split once more over 'd'."""
    terms = _sharded_terms(fit, mesh, big_n_threshold)
    if terms is None:
        return sharded_batched_log_prob(fit.log_prob(), mesh)
    return make_log_prob(fit.spec, terms, fit.derive)


def build_sharded_value_and_grad(fit, mesh, big_n_threshold: int = 100):
    """``value_and_grad(theta [W_local, D]) -> (logp, d logp / d theta)`` of
    this rank's walkers, the potential of HMC and the stepping stone on a
    mesh: ``fit.value_and_grad()`` where no term is large (the fast path),
    else autograd through the sharded terms, whose chi^2 backward sums each
    rank's share of the delta-gradient over 'd'."""
    terms = _sharded_terms(fit, mesh, big_n_threshold)
    if terms is None:
        return fit.value_and_grad()
    chunk = min(walker_chunk(t, fit.dtype) for t in fit.terms)
    return autograd_value_and_grad(make_log_prob(fit.spec, terms, fit.derive), chunk)
