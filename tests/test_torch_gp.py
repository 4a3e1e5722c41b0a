"""The port's GP reconstruction of H(z) (``cosmax_torch.gp``) against the
JAX package's on the CPU in f64: the marginal likelihood, the predictive
and a fantasy model at the same hyperparameters (1e-10 relative), 200
Adam steps' hyperparameters (1e-6 relative), and the reconstruction
against the reference's published values (tests/test_gp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.gp import fit_gp as jax_fit_gp
from cosmax.gp.exact_gp import GPParams as JaxParams
from cosmax_torch.data import load_cc
from cosmax_torch.gp import ExactGP, GPParams, fit_gp, reconstruct_hz

F64 = torch.float64
# hyperparameters away from the initial point, in both packages' terms
RAW = dict(raw_outputscale=0.7, raw_lengthscale=-0.4, mean_const=0.12, noise_scale=0.55)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cc():
    return load_cc()


@pytest.fixture(scope="module")
def pair(cc):
    """(JAX GP, JAX params, port GP, port params) on the standardised CC
    data at the same hyperparameters."""
    with jax.enable_x64(True):
        jgp, _, _ = jax_fit_gp(cc.z, cc.values, cc.cov, iters=1)
        jp = JaxParams(**{k: jnp.asarray(v) for k, v in RAW.items()})
    gp = ExactGP(np.asarray(jgp.x), np.asarray(jgp.y), np.asarray(jgp.noise_cov),
                 (jgp.ls_lo, jgp.ls_hi), device="cpu", dtype=F64)
    tp = GPParams(**{k: torch.tensor(v, dtype=F64) for k, v in RAW.items()})
    return jgp, jp, gp, tp


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_mll_matches_jax(pair):
    jgp, jp, gp, tp = pair
    with jax.enable_x64(True):
        want = float(jgp.mll(jp))
    assert float(gp.mll(tp)) == pytest.approx(want, rel=1e-10)


def test_predict_matches_jax(pair):
    jgp, jp, gp, tp = pair
    grid = np.linspace(0.0, 2.2, 23)
    with jax.enable_x64(True):
        m_want, c_want = jgp.predict(jp, grid)
        pm_want = jgp.predict_mean(jp, grid)
    m, c = gp.predict(tp, torch.as_tensor(grid))
    assert _rel(m, m_want) < 1e-10 and _rel(c, c_want) < 1e-10
    assert _rel(gp.predict_mean(tp, grid), pm_want) < 1e-10


def test_condition_on_matches_jax(pair):
    jgp, jp, gp, tp = pair
    x_new, y_new, var_new = np.array([0.35, 1.1]), np.array([0.2, -0.4]), np.array([0.05, 0.08])
    grid = np.linspace(0.0, 2.0, 17)
    for noise in (var_new, np.diag(var_new)):
        with jax.enable_x64(True):
            m_want, c_want = jgp.condition_on(x_new, y_new, noise).predict(jp, grid)
        m, c = gp.condition_on(x_new, y_new, noise).predict(tp, grid)
        assert _rel(m, m_want) < 1e-10 and _rel(c, c_want) < 1e-10
    with pytest.raises(ValueError):
        gp.condition_on([0.1, 0.2], [1.0], [0.1, 0.1])
    with pytest.raises(ValueError):
        gp.condition_on([0.1], [1.0], np.eye(3))


def test_fit_200_steps_matches_jax_x64(cc):
    with jax.enable_x64(True):
        _, jparams, jinfo = jax_fit_gp(cc.z, cc.values, cc.cov, iters=200)
    _, params, info = fit_gp(cc.z, cc.values, cc.cov, iters=200, device="cpu", dtype=F64)
    for k in ("outputscale", "lengthscale", "noise_scale"):
        assert info[k] == pytest.approx(jinfo[k], rel=1e-6), k
    for a, b in zip(params, jparams):
        assert float(a) == pytest.approx(float(b), rel=1e-6, abs=1e-9)
    np.testing.assert_allclose(info["losses"], np.asarray(jinfo["losses"]), rtol=1e-6)


def test_failed_cholesky_raises_after_the_loop(cc):
    """A training covariance that is not positive definite is not hidden:
    the loop collects the factorisation's info and raises."""
    bad = -np.eye(len(cc.z)) * 1e6
    with pytest.raises(torch.linalg.LinAlgError, match="Cholesky"):
        fit_gp(cc.z, cc.values, bad, iters=3, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def fitted(cc):
    return reconstruct_hz(cc.z, cc.values, cc.cov, iters=3000, device="cpu", dtype=F64)


def test_hyperparameters_match_reference(fitted):
    info = fitted["info"]
    assert info["lengthscale"] == pytest.approx(2.366, abs=0.05)
    assert info["noise_scale"] == pytest.approx(0.489, abs=0.03)


def test_h0_and_deceleration(fitted):
    h0, sigma = fitted["h_mean"][0], fitted["h_std"][0]
    assert h0 == pytest.approx(67.5, abs=2.0)
    assert 2.0 < sigma < 8.0
    q, z = fitted["q"], fitted["z_grid"]
    assert q[0] < 0 and q[z > 1.5][-1] > 0
    cov = fitted["h_cov"]
    np.testing.assert_allclose(np.sqrt(np.clip(np.diag(cov), 0, None)), fitted["h_std"],
                               rtol=1e-6, atol=1e-9)


def test_q_matches_finite_differences(fitted):
    """q(z) = -1 + (1+z) H'/H from one backward of the summed means, held
    against central differences of the predictive mean."""
    gp, p, info = fitted["gp"], fitted["params"], fitted["info"]
    z = torch.as_tensor(fitted["z_grid"][5:-5])
    eps = 1e-5

    def h(zz):
        return (gp.predict_mean(p, zz) * info["y_std"] + info["y_mean"]).detach()

    dh = (h(z + eps) - h(z - eps)) / (2 * eps)
    q = -1.0 + (1.0 + z) * dh / h(z)
    np.testing.assert_allclose(fitted["q"][5:-5], q.numpy(), rtol=1e-6, atol=1e-8)


def test_gp_cli_writes_summary_and_figures(tmp_path):
    import json

    from cosmax_torch.gp.__main__ import main

    assert main(["--out", str(tmp_path), "--iters", "50", "--device", "cpu"]) == 0
    summ = json.loads((tmp_path / "gp_summary.json").read_text())
    assert set(summ) == {"outputscale", "lengthscale", "noise_scale", "H0", "H0_sigma", "q0"}
    for name in ("cc_gp_Hz.png", "cc_gp_qz.png", "cc_gp_cov.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_entry_points_default_to_the_card(cc):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_gp(cc.z, cc.values, cc.cov, iters=1)
