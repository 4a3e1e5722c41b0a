"""The port's ensemble sampler held to the JAX package's ensemble tests that
had no counterpart in the port, at their walker counts, steps and
tolerances (another RNG, so the seeds are the port's own):

* tests/test_exact_posterior.py::test_chain_matches_exact_grid_posterior:
  the production move mixture on bao.desi lcdm (GL-32 distances, f64)
  against the grid-exact marginals;
* tests/test_samplers.py::test_kde_only_gaussian_recovery,
  ::test_kde_fallback_above_65536_walkers,
  ::test_thinned_run_matches_unthinned_slice and ::test_zero_steps_any_thin.
"""

import numpy as np
import pytest
import torch

from cosmax_torch.data import load_bao
from cosmax_torch.likelihoods import ParamSpec, make_log_prob
from cosmax_torch.likelihoods import bao as tbao
from cosmax_torch.samplers.ensemble import (
    EnsembleSampler,
    MoveSpec,
    default_moves,
    stretch_only,
    uniform_init,
)

F64 = torch.float64
COV = np.array([[1.0, 0.6], [0.6, 2.0]])
ICOV = np.linalg.inv(COV)
MU = np.array([1.5, -0.5])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small tensor ops: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gauss_lp(x):
    """The JAX tests' correlated 2-D Gaussian, batched: x [W, 2] -> [W]."""
    d = x - torch.as_tensor(MU, dtype=x.dtype)
    return -0.5 * torch.einsum("wi,ij,wj->w", d, torch.as_tensor(ICOV, dtype=x.dtype), d)


def _grid_marginals(log_prob, spec, n=400):
    """Exact marginal quantiles by 2-D grid integration (f64), as
    tests/test_exact_posterior.py computes them."""
    hs = np.linspace(spec.bounds[0, 0], spec.bounds[0, 1], n + 2)[1:-1]
    oms = np.linspace(spec.bounds[1, 0], spec.bounds[1, 1], n + 2)[1:-1]
    hh, oo = np.meshgrid(hs, oms, indexing="ij")
    pts = torch.as_tensor(np.stack([hh.ravel(), oo.ravel()], axis=1))
    ll = log_prob(pts).numpy().reshape(n, n)
    w = np.exp(ll - ll.max())

    def quantiles(axis, grid):
        m = w.sum(axis=1 - axis)
        c = np.cumsum(m) - 0.5 * m
        c /= m.sum()
        return tuple(np.interp(q, c, grid) for q in (0.159, 0.5, 0.841))

    return quantiles(0, hs), quantiles(1, oms)


def test_chain_matches_exact_grid_posterior():
    """The production move mixture (f64 here) reproduces the grid-exact
    marginal medians to 0.05 sigma and the 68% widths to 6%."""
    spec = ParamSpec(("h", "Om"), np.array([(0.5, 0.8), (0.1, 0.7)]))
    term = tbao.build_bao_term(load_bao("desi_dr2"), "lcdm", tbao.rd_fixed(147.09), "cpu", F64,
                               grid=("gl", 32))
    log_prob = make_log_prob(spec, [term], lambda p: {**p, "H0": 100 * p["h"]})
    (h_lo, h_med, h_hi), (o_lo, o_med, o_hi) = _grid_marginals(log_prob, spec)

    s = EnsembleSampler(log_prob, 256, 2, moves=default_moves())
    init = uniform_init(torch.Generator().manual_seed(3), spec.bounds, 256, F64, device="cpu")
    _, chain = s.run(init, 1500, seed=11)
    flat = chain.flat(discard=400).numpy()

    h_sig = 0.5 * (h_hi - h_lo)
    o_sig = 0.5 * (o_hi - o_lo)
    assert np.median(flat[:, 0]) == pytest.approx(h_med, abs=0.05 * h_sig)
    assert np.median(flat[:, 1]) == pytest.approx(o_med, abs=0.05 * o_sig)
    q = np.percentile(flat, [15.9, 84.1], axis=0)
    assert 0.5 * (q[1, 0] - q[0, 0]) == pytest.approx(h_sig, rel=0.06)
    assert 0.5 * (q[1, 1] - q[0, 1]) == pytest.approx(o_sig, rel=0.06)


def test_kde_only_gaussian_recovery():
    """The KDE move alone satisfies detailed balance (its q(old)/q(new)
    correction is the delicate part): it recovers the target Gaussian."""
    s = EnsembleSampler(gauss_lp, 64, 2, moves=(MoveSpec("kde", 1.0),))
    gen = torch.Generator().manual_seed(1)
    init = torch.as_tensor(MU, dtype=torch.float32) + 0.5 * torch.randn(
        (64, 2), generator=gen, dtype=torch.float32)
    _, chain = s.run(init, 1500, seed=0)
    flat = chain.flat(discard=400).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), MU, atol=0.12)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.3)
    assert 0.1 < chain.acceptance_fraction < 0.95


def test_kde_fallback_above_65536_walkers():
    """Above 65,536 walkers the KDE move is swapped onto a stretch move
    (its O(W^2) density evaluation would dominate a step)."""
    with pytest.warns(UserWarning, match="KDE move disabled"):
        s = EnsembleSampler(gauss_lp, 65538, 2, moves=default_moves())
    kinds = [m.kind for m in s.moves]
    assert "kde" not in kinds and "stretch" in kinds
    # the mixture's weights are kept
    assert sum(m.weight for m in s.moves) == pytest.approx(1.0)
    # at or below the threshold the KDE move stays
    s2 = EnsembleSampler(gauss_lp, 32768, 2, moves=default_moves())
    assert "kde" in [m.kind for m in s2.moves]
    # and the swapped sampler runs
    init = torch.zeros((65538, 2), dtype=torch.float32) + torch.as_tensor(MU, dtype=torch.float32)
    _, chain = s.run(init, 2, seed=0)
    assert bool(torch.isfinite(chain.log_probs).all())


def test_thinned_run_matches_unthinned_slice():
    """thin=k records samples[::k] of the unthinned run and ends in the
    identical state (the same steps)."""
    s = EnsembleSampler(gauss_lp, 32, 2, moves=default_moves())
    init = torch.zeros((32, 2), dtype=torch.float32)
    state_full, full = s.run(init, 23, seed=21)
    for thin in (4, 5, 25):
        state_t, thinned = s.run(init, 23, seed=21, thin=thin)
        assert torch.equal(thinned.samples, full.samples[::thin])
        assert torch.equal(thinned.log_probs, full.log_probs[::thin])
        assert torch.equal(state_t.walkers, state_full.walkers)


def test_zero_steps_any_thin():
    """n_steps=0 returns an empty chain for every thin."""
    s = EnsembleSampler(gauss_lp, 32, 2, moves=stretch_only())
    for thin in (1, 2, 5):
        state, chain = s.run(torch.zeros((32, 2), dtype=torch.float32), 0, seed=0, thin=thin)
        assert chain.samples.shape == (0, 32, 2)
        assert state.step == 0
