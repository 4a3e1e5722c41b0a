"""cosmax_torch likelihoods and presets against cosmax on the parity path.

* the flagship bao.desi_cmb_des5y/wzcdm per-term chi^2 at 8 seeded theta,
  1e-9 relative in f64 (and with the dense synthetic 1829^2 SN factor);
* the bao.desi LCDM anchor chi^2(h=0.690, Om=0.298) = 10.2753;
* the port in f32 against JAX in f64 within 1e-4 of max|logp|;
* -inf for out-of-box and NaN walkers, without touching other rows;
* the port's SN whitener bit-equal to the JAX loader's, through interop.

One preset build per package and configuration (module fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.configs import get_preset as jax_preset
from cosmax.data import load_sn as jax_load_sn
from cosmax.likelihoods import cmb as jax_cmb
from cosmax_torch.configs import get_preset
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods import base as tbase
from cosmax_torch.likelihoods import cmb as tcmb

F64 = torch.float64


# Every JAX evaluation uses the same walker count: un-jitted JAX compiles
# each primitive per shape, so shared shapes share compiled executables.
N_THETA = 8


def _thetas(bounds, seed, n=N_THETA, spread=0.05):
    rng = np.random.default_rng(seed)
    lo, hi = bounds[:, 0], bounds[:, 1]
    return 0.5 * (lo + hi) + spread * (hi - lo) * rng.standard_normal((n, len(lo)))


def _jax_eval(fit, theta):
    """Per-term chi^2 and log_prob of the JAX preset, vmapped, no jit, f64."""
    with jax.enable_x64(True):
        th = jnp.asarray(theta)
        chi = jax.vmap(fit.chi2_breakdown())(th)
        lp = jax.vmap(fit.log_prob())(th)
        return {k: np.asarray(v) for k, v in chi.items()}, np.asarray(lp)


@pytest.fixture(scope="module")
def flagship():
    with jax.enable_x64(True):
        jfit = jax_preset("bao.desi_cmb_des5y", model="wzcdm")
    tfit = get_preset("bao.desi_cmb_des5y", "wzcdm", device="cpu", dtype=F64)
    theta = _thetas(tfit.spec.bounds, seed=0)
    jchi, jlp = _jax_eval(jfit, theta)
    return dict(tfit=tfit, theta=theta, jchi=jchi, jlp=jlp)


def test_flagship_per_term_chi2_f64(flagship):
    tfit, theta = flagship["tfit"], flagship["theta"]
    got = tfit.chi2_breakdown()(torch.as_tensor(theta))
    assert set(got) == set(flagship["jchi"]) == {"bao", "cmb_desi", "sn"}
    for name, want in flagship["jchi"].items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-9, atol=0, err_msg=name)
    lp = tfit.log_prob()(torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(lp, flagship["jlp"], rtol=1e-9, atol=0)


def test_flagship_f32_against_jax_f64(flagship):
    fit32 = get_preset("bao.desi_cmb_des5y", "wzcdm", device="cpu")
    lp = fit32.log_prob()(torch.as_tensor(flagship["theta"], dtype=torch.float32))
    assert lp.dtype == torch.float32
    want = flagship["jlp"]
    err = np.max(np.abs(lp.double().numpy() - want)) / np.max(np.abs(want))
    assert err < 1e-4, err


def test_flagship_dense_synthetic_whitening_f64():
    """synthetic_sys=True: the dense 1829^2 DES-SN5YR factor of the
    flagship's chip run, against the JAX package's own synthetic build."""
    with jax.enable_x64(True):
        jfit = jax_preset("bao.desi_cmb_des5y", model="wzcdm", synthetic_sys=True)
    tfit = get_preset("bao.desi_cmb_des5y", "wzcdm", synthetic_sys=True, device="cpu", dtype=F64)
    linv = tfit.terms[2].meta["constants"]["linv"]
    assert bool((torch.tril(linv, -1) != 0).any())  # dense, not diagonal
    theta = _thetas(tfit.spec.bounds, seed=5)
    sn = jfit.terms[2]
    with jax.enable_x64(True):
        want = jax.vmap(lambda th: sn.chi2(jfit.derive(jfit.spec.unpack(th))))(jnp.asarray(theta))
    got = tfit.chi2_breakdown()(torch.as_tensor(theta))
    np.testing.assert_allclose(got["sn"].numpy(), np.asarray(want), rtol=1e-9, atol=0)


def test_bao_desi_anchor():
    fit = get_preset("bao.desi", "lcdm", device="cpu", dtype=F64)
    chi2 = fit.chi2_breakdown()(torch.tensor([[0.690, 0.298]], dtype=F64))["bao"]
    assert abs(float(chi2[0]) - 10.2753) < 1e-4


def test_out_of_box_and_nan_walkers_are_minus_inf(flagship):
    tfit = flagship["tfit"]
    theta = torch.as_tensor(flagship["theta"][:4]).clone()
    ref = tfit.log_prob()(theta)
    bad = torch.cat([theta, theta[:3].clone()])
    bad[4, 2] = 0.95  # Om beyond its bound (0.1, 0.6)
    bad[5, 0] = float("nan")
    bad[6, 2], bad[6, 4] = -3.0, -1.9  # Om < 0, phantom w0: E^2 < 0, NaN rows
    lp = tfit.log_prob()(bad)
    # batch composition changes only the CPU GEMM's blocking
    np.testing.assert_allclose(lp[:4].numpy(), ref.numpy(), rtol=1e-12, atol=0)
    assert bool(torch.all(lp[4:] == -torch.inf))
    # bound edges are outside the strict interior
    edge = theta[:1].clone()
    edge[0, 2] = tfit.spec.bounds[2, 0]
    assert float(tfit.log_prob()(edge)[0]) == -np.inf


def test_chunking_does_not_change_values(flagship, monkeypatch):
    tfit = flagship["tfit"]
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, seed=3, n=24))
    whole = tfit.log_prob()(theta)
    # a budget of five CMB quadratures: every term runs in several chunks
    monkeypatch.setattr(tbase, "TEMP_BYTES", 8 * 48 * 5)
    assert [tbase.walker_chunk(t, F64) for t in tfit.terms] == [1, 5, 1]
    # same values up to the CPU GEMM's blocking (gemv for one walker)
    np.testing.assert_allclose(tfit.log_prob()(theta).numpy(), whole.numpy(), rtol=1e-12, atol=0)


def test_sn_whitener_bit_equal_through_interop(flagship):
    linv = jax_load_sn("des5y").linv
    via = constants_from_numpy(dict(linv=linv), "cpu", F64)["linv"]
    port = flagship["tfit"].terms[2].meta["constants"]["linv"]
    assert port.dtype == F64 and torch.equal(port, via)
    assert np.array_equal(port.numpy(), linv)


@pytest.mark.parametrize("compression", sorted(jax_cmb.COMPRESSIONS))
def test_cmb_compressions_f64(compression):
    comp = jax_cmb.COMPRESSIONS[compression]
    rng = np.random.default_rng(7)
    p = dict(
        H0=rng.uniform(64, 72, N_THETA), Om=rng.uniform(0.28, 0.34, N_THETA),
        Obh2=rng.uniform(0.021, 0.023, N_THETA), w0=rng.uniform(-1.2, -0.8, N_THETA),
    )
    p["Or"] = comp.omega_r_h2() / (p["H0"] / 100.0) ** 2
    with jax.enable_x64(True):
        jterm = jax_cmb.build_cmb_term(compression, "wzcdm")
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        want = np.asarray(jax.vmap(jterm.chi2)(pj))
        want_obs = np.asarray(jax.vmap(lambda q: jax_cmb.cmb_observables(comp, q, "wzcdm"))(pj))
    tterm = tcmb.build_cmb_term(compression, "wzcdm", "cpu", F64)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    obs = tcmb.cmb_observables(tcmb.COMPRESSIONS[compression], tp, "wzcdm").numpy()
    np.testing.assert_allclose(obs, want_obs, rtol=1e-12)
    np.testing.assert_allclose(tterm.chi2(tp).numpy(), want, rtol=1e-9)


@pytest.mark.parametrize("name", ["bao.desi_cmb_union3", "bao.desi_cmb_pantheon"])
def test_other_joint_presets_f64(name):
    with jax.enable_x64(True):
        jfit = jax_preset(name, model="wzcdm")
    tfit = get_preset(name, "wzcdm", device="cpu", dtype=F64)
    assert tfit.spec.names == jfit.spec.names
    np.testing.assert_array_equal(tfit.spec.bounds, jfit.spec.bounds)
    assert tfit.dof == jfit.dof and tfit.seed == jfit.seed
    theta = _thetas(tfit.spec.bounds, seed=11)
    jchi, _ = _jax_eval(jfit, theta)
    got = tfit.chi2_breakdown()(torch.as_tensor(theta))
    for term, want in jchi.items():
        np.testing.assert_allclose(got[term].numpy(), want, rtol=1e-9, atol=0, err_msg=term)


class _Building(Exception):
    """Raised in place of a table build: the preset was not refused."""


def test_unported_paths_raise(monkeypatch):
    # w0wacdm takes the fast path in every ported preset: the multiprobe
    # family goes on to build its tables (built and held against the JAX
    # package in test_torch_w0wa_joint.py)
    def building(*args, **kwargs):
        raise _Building

    monkeypatch.setattr("cosmax_torch.models.linear_chi2.table_cached", building)
    monkeypatch.setattr("cosmax_torch.models.linear_chi2._FINALIZE_MEMO", {})
    with pytest.raises(_Building):
        get_preset("joint.multiprobe", "w0wacdm", fast=True, device="cpu")
    with pytest.raises(KeyError, match="unknown preset"):
        get_preset("qsr.no_such_preset", "lcdm", device="cpu")
    from cosmax_torch.likelihoods import sn

    with pytest.raises(_Building):
        get_preset("cc.cc_des5y", "w0wacdm", fast=True, device="cpu")
    from cosmax_torch.data import load_sn

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sn.build_sn_term(load_sn("union3"), "lcdm", "dM", device="cpu", method="compressed")
    with pytest.raises(TypeError, match="device"):
        sn.build_sn_term(load_sn("union3"), "lcdm", "dM", 70.0)  # no CPU default
