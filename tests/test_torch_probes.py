"""The multiprobe pieces of the port (loaders, the growth ODE, the CC,
quasar and fs8 terms, the priors) against the JAX package, in f64.

* the cc, fs8 and quasar loaders to 1e-12, all three quasar sigma modes,
  at 22 and 50 bins (the numpy binning against pandas.qcut);
* ``fsigma8`` to 1e-10 relative, with radiation;
* the CC term (both f conventions, chi^2 and log_norm) and the quasar
  term (chi^2 and log_norm) on the parity path to 1e-9 relative;
* the published anchors fs8.fs8 lcdm chi^2 = 62.73 and cc.cc lcdm chi^2
  = 30.39, logL = -130.62 (the latter on the parity and the fast path);
* RK4 on a linear system with a known solution.

No preset is built on the JAX side; every JAX evaluation takes N_THETA
walkers (un-jitted JAX compiles each primitive per shape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax import data as jdata
from cosmax.likelihoods.cc import build_cc_term as jax_cc
from cosmax.likelihoods.quasars import build_quasar_term as jax_qsr
from cosmax.models.growth import fsigma8 as jax_fsigma8
from cosmax_torch.configs import get_preset
from cosmax_torch.data import load_cc, load_fs8, load_quasars
from cosmax_torch.likelihoods.cc import build_cc_term
from cosmax_torch.likelihoods.quasars import build_quasar_term
from cosmax_torch.models.growth import fsigma8
from cosmax_torch.ops.ode import rk4

F64 = torch.float64
N_THETA = 8


def _params(seed, extra, model="wzcdm"):
    """[N_THETA] walker parameters, numpy, with Or from H0 when drawn."""
    rng = np.random.default_rng(seed)
    p = {"Om": rng.uniform(0.22, 0.42, N_THETA)}
    if model != "lcdm":
        p["w0"] = rng.uniform(-1.4, -0.6, N_THETA)
    for k, (lo, hi) in extra.items():
        p[k] = rng.uniform(lo, hi, N_THETA)
    if "H0" in p:
        p["Or"] = 4.15e-5 / (p["H0"] / 100.0) ** 2
    return p


def _both(term_t, term_j, p):
    """(chi2, log_norm) of the port's and the JAX package's term."""
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    with jax.enable_x64(True):
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        want = [np.asarray(jax.vmap(fn)(pj)) for fn in (term_j.chi2, term_j.log_norm)]
    got = [term_t.chi2(pt).numpy(), term_t.log_norm(pt).numpy()]
    return got, want


@pytest.mark.parametrize("n_bins", [22, 50])
@pytest.mark.parametrize("mode", ["sem_errors", "sem_data", "rms_errors"])
def test_quasar_loader_matches_jax(n_bins, mode):
    legend, *arrays = load_quasars(n_bins, sigma_mu_type=mode)
    jlegend, *jarrays = jdata.load_quasars(n_bins, sigma_mu_type=mode)
    assert legend == jlegend
    for got, want in zip(arrays, jarrays):
        assert got.shape == (n_bins,)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_cc_and_fs8_loaders_match_jax():
    for ours, theirs in ((load_cc(), jdata.load_cc()), (load_fs8(), jdata.load_fs8())):
        assert ours.legend == theirs.legend
        np.testing.assert_allclose(ours.values, theirs.values, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ours.cov, theirs.cov, rtol=1e-12, atol=0)
        assert ours.log_det == pytest.approx(theirs.log_det, rel=1e-12)
    np.testing.assert_array_equal(load_fs8().omega_fid, jdata.load_fs8().omega_fid)


@pytest.mark.parametrize("model", ["lcdm", "wcdm", "wzcdm"])
def test_fsigma8_matches_jax(model):
    z = load_fs8().z
    p = _params(1, {"sigma8": (0.7, 0.9), "H0": (62.0, 74.0)}, model)
    got = fsigma8(z, {k: torch.as_tensor(v) for k, v in p.items()}, model).numpy()
    with jax.enable_x64(True):
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        want = np.asarray(jax.vmap(lambda q: jax_fsigma8(z, q, model))(pj))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("convention", ["divide", "multiply"])
def test_cc_parity_term_matches_jax(convention):
    t = build_cc_term(load_cc(), "wzcdm", convention, device="cpu", dtype=F64)
    j = jax_cc(jdata.load_cc(), "wzcdm", "f_cc", convention)
    p = _params(2, {"H0": (62.0, 74.0), "f_cc": (0.5, 1.5)})
    (chi2, log_norm), (want_chi2, want_norm) = _both(t, j, p)
    np.testing.assert_allclose(chi2, want_chi2, rtol=1e-9, atol=0)
    np.testing.assert_allclose(log_norm, want_norm, rtol=1e-9, atol=0)


def test_quasar_parity_term_matches_jax():
    _, z, mu, sig = load_quasars(22)
    t = build_quasar_term(z, mu, sig, "wzcdm", device="cpu", dtype=F64)
    j = jax_qsr(z, mu, sig, "wzcdm")
    p = _params(3, {"H0": (62.0, 74.0), "dM_qsr": (-0.3, 0.3), "s": (0.1, 0.8)})
    (chi2, log_norm), (want_chi2, want_norm) = _both(t, j, p)
    np.testing.assert_allclose(chi2, want_chi2, rtol=1e-9, atol=0)
    np.testing.assert_allclose(log_norm, want_norm, rtol=1e-9, atol=0)


def test_fs8_published_anchor():
    """fs8/fs8.py docstring: chi2 = 62.73 at Om=0.268, s8=0.789, f=0.78 (LCDM)."""
    fit = get_preset("fs8.fs8", "lcdm", device="cpu", dtype=F64)
    chis = fit.chi2_breakdown()(torch.tensor([[0.268, 0.789, 0.78]], dtype=F64))
    assert float(chis["fs8"][0]) == pytest.approx(62.73, abs=0.2)


def test_cc_published_anchor():
    """cosmic_chronometers/cc.py docstring: chi2 = 30.39, logL = -130.62 at
    H0=67.1, Om=0.317, f=0.70 (LCDM), with the Om h^2 prior."""
    fit = get_preset("cc.cc", "lcdm", device="cpu", dtype=F64)
    theta = torch.tensor([[67.1, 0.317, 0.70]], dtype=F64)
    total = float(sum(v[0] for v in fit.chi2_breakdown()(theta).values()))
    assert total == pytest.approx(30.39, abs=0.05)
    assert float(fit.log_prob()(theta)[0]) == pytest.approx(-130.62, abs=0.05)
    # the fast path (the fused log-prob, the prior in its header) as well
    fast = get_preset("cc.cc", "lcdm", fast=True, device="cpu", dtype=F64)
    assert float(fast.log_prob()(theta)[0]) == pytest.approx(-130.62, abs=0.05)


def test_rk4_on_a_rotation():
    """y' = [[0, 1], [-1, 0]] y from (1, 0): y = (cos t, -sin t), to RK4's
    O(h^4) on the static grid, with a walker axis."""
    ts = np.linspace(0.0, 2.0, 41)
    y0 = torch.tensor([[1.0, 0.0], [2.0, 0.0]], dtype=F64)
    ys = rk4(lambda t, y: torch.stack([y[:, 1], -y[:, 0]], dim=-1), y0, ts, substeps=4)
    assert ys.shape == (2, 41, 2)
    want = np.stack([np.cos(ts), -np.sin(ts)], axis=-1)
    np.testing.assert_allclose(ys[0].numpy(), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ys[1].numpy(), 2.0 * want, rtol=0, atol=2e-9)
