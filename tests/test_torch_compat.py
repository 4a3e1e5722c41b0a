"""The port's emcee facade (``cosmax_torch.compat``) on the cases of
``tests/test_compat.py`` with the same targets and limits, on the CPU
with one torch thread; plus bit-equal chains for one seed, a batched
``vmapped_log_prob=`` (a fast fit's ``log_prob()``), the walkers' dtype
rule, and the deterministic pieces (autocorrelation time, blob layout)
on one fixed chain against ``cosmax.compat``."""

import numpy as np
import pytest
import torch

from cosmax_torch.compat import AutocorrError, EnsembleSampler, NpzBackend

MU = np.array([1.0, -2.0])
ICOV = np.linalg.inv(np.array([[1.0, 0.3], [0.3, 0.5]]))


@pytest.fixture(autouse=True)
def _one_thread():
    """Thousands of small tensor ops a chain: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lp(x):
    d = x - torch.as_tensor(MU, dtype=x.dtype)
    return -0.5 * torch.sum(d * d)


def _sampler(nwalkers, log_prob=lp, **kw):
    return EnsembleSampler(nwalkers, 2, log_prob, device="cpu", **kw)


def _chi2(theta):
    d = theta - torch.as_tensor(MU, dtype=theta.dtype)
    return d @ torch.as_tensor(ICOV, dtype=theta.dtype) @ d, d


def test_reference_style_workflow():
    nwalkers, ndim, nsteps, burn_in = 64, 2, 800, 200
    rng = np.random.default_rng(0)
    initial = MU + 0.5 * rng.standard_normal((nwalkers, ndim))
    sampler = _sampler(nwalkers, moves=[("kde", 0.30), ("de", 0.56), ("snooker", 0.14)], seed=1)
    sampler.run_mcmc(initial, nsteps, progress=True)

    chain = sampler.get_chain(discard=burn_in)
    assert chain.shape == (nsteps - burn_in, nwalkers, ndim)
    flat = sampler.get_chain(discard=burn_in, flat=True)
    assert flat.shape == ((nsteps - burn_in) * nwalkers, ndim)
    np.testing.assert_allclose(flat.mean(axis=0), MU, atol=0.1)

    tau = sampler.get_autocorr_time(discard=burn_in)
    assert tau.shape == (ndim,) and (tau > 0).all()
    acc = sampler.acceptance_fraction
    assert acc.shape == (nwalkers,)
    assert 0.05 < acc.mean() < 0.95
    lps = sampler.get_log_prob(discard=burn_in)
    assert lps.shape == (nsteps - burn_in, nwalkers)
    assert np.isfinite(lps).all()


def test_second_run_mcmc_continues():
    sampler = _sampler(32, seed=5)
    init = np.zeros((32, 2))
    sampler.run_mcmc(init, 30)
    sampler.run_mcmc(None, 20)
    assert sampler.get_chain().shape == (50, 32, 2)
    fresh = _sampler(32, seed=5)
    fresh.run_mcmc(init, 50)
    np.testing.assert_array_equal(sampler.get_chain(), fresh.get_chain())


def test_same_seed_same_chain_bit_for_bit():
    init = MU + 0.3 * np.random.default_rng(9).standard_normal((32, 2))
    chains = []
    for _ in range(2):
        s = _sampler(32, seed=21)
        s.run_mcmc(init, 40)
        chains.append((s.get_chain(), s.get_log_prob()))
    np.testing.assert_array_equal(chains[0][0], chains[1][0])
    np.testing.assert_array_equal(chains[0][1], chains[1][1])
    other = _sampler(32, seed=22)
    other.run_mcmc(init, 40)
    assert not np.array_equal(other.get_chain(), chains[0][0])


def test_autocorr_error_on_short_chain():
    sampler = _sampler(32, seed=2)
    sampler.run_mcmc(np.zeros((32, 2)) + MU, 40)
    with pytest.raises(AutocorrError) as exc:
        sampler.get_autocorr_time()
    assert hasattr(exc.value, "tau")


def test_reset():
    sampler = _sampler(32, seed=3)
    sampler.run_mcmc(np.zeros((32, 2)), 10)
    sampler.reset()
    with pytest.raises(RuntimeError):
        sampler.get_chain()


def test_emcee_burn_in_idiom():
    sampler = _sampler(32, seed=7)
    init = np.zeros((32, 2)) + MU
    state = sampler.run_mcmc(init, 25)
    sampler.reset()
    sampler.run_mcmc(state, 15)
    assert sampler.get_chain().shape == (15, 32, 2)
    fresh = _sampler(32, seed=7)
    fresh.run_mcmc(init, 40)
    np.testing.assert_array_equal(sampler.get_chain(), fresh.get_chain(discard=25))


def test_coords_restart_does_not_continue():
    s = _sampler(32, seed=11)
    s.run_mcmc(np.zeros((32, 2)), 10)
    first = s.get_chain().copy()
    p1 = np.zeros((32, 2)) + MU
    s.run_mcmc(p1, 10)
    second = s.get_chain()
    assert second.shape == (10, 32, 2)
    assert not np.array_equal(first, second)
    s2 = _sampler(32, seed=11)
    s2.run_mcmc(p1, 10)
    assert not np.array_equal(second, s2.get_chain())


def test_none_before_any_run_raises():
    with pytest.raises(ValueError, match="initial_state=None"):
        _sampler(32, seed=13).run_mcmc(None, 5)


def test_blobs_reference_shaped_script(tmp_path):
    def log_prob(theta):  # emcee-style: (logp, blob)
        chi2, _ = _chi2(theta)
        return -0.5 * chi2, chi2

    backend = NpzBackend(tmp_path / "chain.npz")
    sampler = _sampler(32, log_prob, seed=3, backend=backend)
    p0 = MU + 0.2 * np.random.default_rng(1).standard_normal((32, 2))
    sampler.run_mcmc(p0, 50)
    blobs = sampler.get_blobs()
    assert blobs.shape == (50, 32)
    np.testing.assert_allclose(blobs, -2.0 * sampler.get_log_prob(), rtol=1e-5)
    assert sampler.get_blobs(discard=10, flat=True).shape == (40 * 32,)
    assert backend.iteration == 50
    assert backend.get_chain().shape == (50, 32, 2)


def test_backend_resume_after_crash(tmp_path):
    path = tmp_path / "c.npz"
    p0 = MU + 0.2 * np.random.default_rng(2).standard_normal((32, 2))
    ref = _sampler(32, seed=5)
    ref.run_mcmc(p0, 30)
    ref.run_mcmc(None, 20)
    full = ref.get_chain()

    s1 = _sampler(32, seed=5, backend=NpzBackend(path))
    s1.run_mcmc(p0, 30)
    del s1  # "crash"
    s2 = _sampler(32, seed=5, backend=NpzBackend(path))
    s2.run_mcmc(None, 20)
    got = s2.get_chain()
    assert got.shape == (50, 32, 2)
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(s2.get_log_prob(), ref.get_log_prob())
    assert NpzBackend(path).iteration == 50
    np.testing.assert_array_equal(NpzBackend(path).get_last_sample(), got[-1])


def test_backend_refuses_silent_overwrite(tmp_path):
    path = tmp_path / "c.npz"
    p0 = MU + 0.1 * np.random.default_rng(3).standard_normal((16, 2))
    _sampler(16, seed=7, backend=NpzBackend(path)).run_mcmc(p0, 10)
    s2 = _sampler(16, seed=7, backend=NpzBackend(path))
    with pytest.raises(ValueError, match="reset"):
        s2.run_mcmc(p0, 10)
    with pytest.raises(ValueError, match="backend holds"):
        _sampler(8, backend=NpzBackend(path))
    b = NpzBackend(path)
    b.reset(16, 2)
    assert not b.initialized
    _sampler(16, seed=7, backend=b).run_mcmc(p0, 10)
    assert b.iteration == 10


def test_get_blobs_none_without_blobs():
    s = _sampler(16, seed=0)
    s.run_mcmc(MU + 0.1 * np.random.default_rng(4).standard_normal((16, 2)), 5)
    assert s.get_blobs() is None


def test_get_blobs_heterogeneous_shapes():
    def log_prob(theta):
        chi2, d = _chi2(theta)
        return -0.5 * chi2, chi2, d  # scalar + length-2 vector

    sampler = _sampler(8, log_prob, seed=0)
    sampler.run_mcmc(MU + 0.1 * np.random.default_rng(0).standard_normal((8, 2)), 5)
    blobs = sampler.get_blobs()
    assert blobs.shape == (5, 8) and blobs.dtype == object
    chi2_cell, d_cell = blobs[0, 0]
    assert np.shape(chi2_cell) == () and np.shape(d_cell) == (2,)
    assert sampler.get_blobs(flat=True).shape == (40,)


def test_get_blobs_homogeneous_multi():
    def log_prob(theta):
        chi2, _ = _chi2(theta)
        return -0.5 * chi2, chi2, 2.0 * chi2

    sampler = _sampler(8, log_prob, seed=0)
    sampler.run_mcmc(MU + 0.1 * np.random.default_rng(0).standard_normal((8, 2)), 5)
    blobs = sampler.get_blobs()
    assert blobs.shape == (5, 8, 2)
    np.testing.assert_allclose(blobs[..., 1], 2.0 * blobs[..., 0], rtol=1e-6)


def test_vmapped_log_prob_of_a_fast_fit():
    """A fast fit's batched ``log_prob()`` as ``vmapped_log_prob`` (the
    fused kernel's path on a card; its plain version here): the chain's
    log-probs are the fit's at the recorded positions."""
    from cosmax_torch.configs import get_preset

    fit = get_preset("bao.desi", "lcdm", fast=True, device="cpu")
    lp_batched = fit.log_prob()
    s = EnsembleSampler(16, fit.spec.dim, lp_batched, vmapped_log_prob=lp_batched, seed=4,
                        device="cpu")
    mid = fit.spec.bounds.mean(axis=1)
    s.run_mcmc(mid * (1 + 0.01 * np.random.default_rng(6).standard_normal((16, 2))), 10)
    chain, lps = s.get_chain(), s.get_log_prob()
    assert np.isfinite(lps).all() and 0.0 < s.acceptance_fraction.mean() < 1.0
    want = lp_batched(torch.as_tensor(chain.reshape(-1, 2))).numpy().reshape(lps.shape)
    np.testing.assert_allclose(lps, want, rtol=1e-6)
    assert s.get_blobs() is None


def test_walker_dtype_follows_the_initial_coords():
    """A tensor's dtype is kept (an f64 CPU fit takes f64 coords); numpy
    coords take the device's default, float32."""
    p0 = MU + 0.1 * np.random.default_rng(5).standard_normal((16, 2))
    s = _sampler(16, seed=1)
    s.run_mcmc(torch.as_tensor(p0), 3)
    assert s.get_chain().dtype == np.float64
    s.run_mcmc(p0, 3)
    assert s.get_chain().dtype == np.float32


def test_a_faulty_log_prob_fails_at_the_first_evaluation():
    """The blob probe does not swallow the user's errors."""
    def broken(x):
        raise ZeroDivisionError("user bug")

    with pytest.raises(ZeroDivisionError, match="user bug"):
        _sampler(8, broken).run_mcmc(np.zeros((8, 2)), 2)


def _fixed_chain(steps=3000, walkers=8):
    """An AR(1) chain, [steps, walkers, 2], from a seeded numpy stream."""
    rng = np.random.default_rng(17)
    x = np.empty((steps, walkers, 2))
    x[0] = rng.standard_normal((walkers, 2))
    for t in range(1, steps):
        x[t] = 0.7 * x[t - 1] + rng.standard_normal((walkers, 2))
    return x + MU


def _jax_facade(log_prob, chain):
    import types

    from cosmax import compat as jax_compat

    s = jax_compat.EnsembleSampler(chain.shape[1], 2, log_prob, seed=0)
    s._chain = types.SimpleNamespace(samples=chain)
    return s


def _torch_facade(log_prob, chain):
    from cosmax_torch.samplers.ensemble import Chain

    s = _sampler(chain.shape[1], log_prob)
    t = torch.as_tensor(chain)
    s._chain = Chain(t, t[..., 0], torch.zeros(t.shape[:2], dtype=torch.bool),
                     torch.zeros(t.shape[0], dtype=torch.long))
    return s


def test_autocorr_time_of_a_fixed_chain_equals_the_jax_facade():
    import jax.numpy as jnp

    chain = _fixed_chain()
    jax_s = _jax_facade(lambda x: -0.5 * jnp.sum((x - MU) ** 2), chain)
    for discard in (0, 500):
        want = jax_s.get_autocorr_time(discard=discard)
        got = _torch_facade(lp, chain).get_autocorr_time(discard=discard)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    short = chain[:40]
    with pytest.raises(AutocorrError) as got_err:
        _torch_facade(lp, short).get_autocorr_time()
    with pytest.raises(Exception) as want_err:
        _jax_facade(lambda x: -0.5 * jnp.sum((x - MU) ** 2), short).get_autocorr_time()
    np.testing.assert_allclose(got_err.value.tau, want_err.value.tau, rtol=1e-10)


def _jax_blobs(kind):
    import jax.numpy as jnp

    icov, mu = jnp.asarray(ICOV), jnp.asarray(MU)

    def log_prob(theta):
        d = theta - mu
        chi2 = d @ icov @ d
        return {"one": (-0.5 * chi2, chi2), "homogeneous": (-0.5 * chi2, chi2, 2.0 * chi2),
                "heterogeneous": (-0.5 * chi2, chi2, d)}[kind]

    return log_prob


def _torch_blobs(kind):
    def log_prob(theta):
        chi2, d = _chi2(theta)
        return {"one": (-0.5 * chi2, chi2), "homogeneous": (-0.5 * chi2, chi2, 2.0 * chi2),
                "heterogeneous": (-0.5 * chi2, chi2, d)}[kind]

    return log_prob


@pytest.mark.parametrize("kind", ["one", "homogeneous", "heterogeneous"])
def test_blob_layout_of_a_fixed_chain_equals_the_jax_facade(kind):
    import jax

    chain = _fixed_chain(steps=6, walkers=4)
    for kw in (dict(), dict(discard=2, thin=2), dict(flat=True)):
        with jax.enable_x64(True):
            want = _jax_facade(_jax_blobs(kind), chain).get_blobs(**kw)
        got = _torch_facade(_torch_blobs(kind), chain).get_blobs(**kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        if kind == "heterogeneous":
            for g, w in zip(got.reshape(-1), want.reshape(-1)):
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_allclose(a, b, rtol=1e-12)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12)
