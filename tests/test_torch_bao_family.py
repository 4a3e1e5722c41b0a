"""The BAO family of the port (ROADMAP item 10b and ``bao.sdss``: 17
presets) on the parity path, against the JAX package.

* each preset's spec (names, bounds, walkers, seed, data size) equals the
  JAX package's;
* per term in f64 at the centre of its box and at its published point
  (``BASELINE.md``; values the row does not give at the box centre),
  rtol 1e-9: every preset in wzcdm, the presets of the fused kernel's
  branches K2-K5 (r_d from z_drag or a drag formula, theta*, H0-free,
  exp(w0)) in all four models;
* the drag-epoch formulae elementwise against JAX;
* the published anchor of bao/desi_bbn.py: chi^2 = 10.29 and r_d = 148.31
  at H0 = 68.45, Om = 0.2976, wb = 0.02190 (lcdm);
* the preset options (``compression``, ``z_star``, ``dataset``), the
  exp(w0) parameter order, and the CLI's ``--list``.

Every JAX evaluation is jitted and takes both points of a configuration
at once."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.configs import get_preset as jax_preset
from cosmax.models import recombination as jrec
from cosmax_torch.configs import get_preset
from cosmax_torch.configs.presets import Derive, _adjust_params
from cosmax_torch.models import recombination as trec

F64 = torch.float64
FAMILY = ("bao.sdss", "bao.desi_omh2", "bao.desi_bbn", "bao.desi_bbn_theta_star",
          "bao.desi_omh2_theta_star", "bao.desi_cc", "bao.desi_cmb", "bao.desi_pantheon",
          "bao.desi_union3", "bao.desi_des5y", "bao.desi_pantheon_cc", "bao.desi_union3_cc",
          "bao.desi_des5y_cc", "bao.desi_union3_bbn", "bao.desi_des5y_bbn",
          "bao.desi_union3_omh2", "bao.desi_des5y_omh2")
# the presets of the kernel's branches K2-K5, held in all four models
BRANCH_PRESETS = ("bao.desi_bbn", "bao.desi_bbn_theta_star", "bao.desi_omh2_theta_star",
                  "bao.desi_union3_bbn", "bao.desi_des5y_bbn", "bao.desi_des5y",
                  "bao.desi_pantheon")
MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")
# the published lcdm rows of BASELINE.md (medians); w0 = -1 (exp_w0 = 1/e)
# and wa = 0 in the other models
PUBLISHED = {
    "bao.sdss": dict(h=0.688, Om=0.294),
    "bao.desi_omh2": dict(h=0.693, Om=0.298, rd=146.48),
    "bao.desi_bbn": dict(H0=68.45, Om=0.2976, Obh2=0.02190),
    "bao.desi_bbn_theta_star": dict(rd=148.33, H0=68.45, Om=0.2974),
    "bao.desi_omh2_theta_star": dict(H0=69.34, Om=0.297, Obh2=0.02343, rd=146.43),
    "bao.desi_cc": dict(f_cc=0.70, H0=69.1, rd=146.9, Om=0.299),
    "bao.desi_cmb": dict(rd=148.41, H0=68.01, Om=0.3051, Obh2=0.02231),
    "bao.desi_pantheon": dict(M=-19.402, H0=68.67, Om=0.304),
    "bao.desi_union3": dict(dM=-0.119, H0=68.69, Om=0.304),
    "bao.desi_des5y": dict(dM=-9.230, rd_h=100.54, Om=0.310),
    "bao.desi_pantheon_cc": dict(f_cc=1.47, H0=68.6, M=-19.40, rd=147.1, Om=0.305),
    "bao.desi_union3_cc": dict(f_cc=0.70, dM=-0.118, H0=68.7, rd=147.0, Om=0.304),
    "bao.desi_des5y_cc": dict(f_cc=0.70, dM=-0.059, H0=68.3, rd=147.2, Om=0.311),
    "bao.desi_union3_bbn": dict(dM=-0.116, H0=68.79, Obh2=0.02218),
    "bao.desi_des5y_bbn": dict(H0=68.63, Om=0.3105, Obh2=0.02219, dM=-0.047),
    "bao.desi_union3_omh2": dict(rd=147.32, H0=68.59, Om=0.304),
    "bao.desi_des5y_omh2": dict(dM=-0.071, rd=148.13, H0=67.87, Om=0.310),
}


def points(name, spec):
    """[centre, published point] of a preset's box."""
    lo, hi = spec.bounds[:, 0], spec.bounds[:, 1]
    centre = 0.5 * (lo + hi)
    pub = dict(PUBLISHED[name], w0=-1.0, exp_w0=math.exp(-1.0), wa=0.0)
    published = np.array([pub.get(nm, c) for nm, c in zip(spec.names, centre)])
    return np.stack([centre, published])


def jax_breakdown(jfit, theta):
    with jax.enable_x64(True):
        out = jax.jit(jax.vmap(jfit.chi2_breakdown()))(jnp.asarray(theta))
        return {k: np.asarray(v) for k, v in out.items()}


CONFIGS = [(n, "wzcdm") for n in FAMILY] + [
    (n, m) for n in BRANCH_PRESETS for m in MODELS if m != "wzcdm"
]


@pytest.mark.parametrize("name,model", CONFIGS)
def test_parity_per_term_matches_jax(name, model):
    with jax.enable_x64(True):
        jfit = jax_preset(name, model)
    tfit = get_preset(name, model, device="cpu", dtype=F64)
    assert tfit.spec.names == jfit.spec.names
    np.testing.assert_array_equal(tfit.spec.bounds, jfit.spec.bounds)
    assert (tfit.n_walkers, tfit.n_steps, tfit.burn_in, tfit.seed, tfit.data_size) == (
        jfit.n_walkers, jfit.n_steps, jfit.burn_in, jfit.seed, jfit.data_size)
    assert tfit.note == jfit.note
    theta = points(name, tfit.spec)
    want = jax_breakdown(jfit, theta)
    got = tfit.chi2_breakdown()(torch.as_tensor(theta))
    assert set(got) == set(want)
    for term, w in want.items():
        assert np.all(np.isfinite(w)), term
        np.testing.assert_allclose(got[term].numpy(), w, rtol=1e-9, atol=0, err_msg=term)


def test_drag_formulae_match_jax():
    rng = np.random.default_rng(0)
    wb = rng.uniform(0.015, 0.04, 64)
    wm = rng.uniform(0.08, 0.25, 64)
    tb, tm = torch.as_tensor(wb), torch.as_tensor(wm)
    with jax.enable_x64(True):
        for name in ("z_drag", "z_drag_hu", "r_drag_aizpuru", "r_drag_desi"):
            want = np.asarray(getattr(jrec, name)(jnp.asarray(wb), jnp.asarray(wm)))
            got = getattr(trec, name)(tb, tm).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=0, err_msg=name)
        want = np.asarray(jrec.r_drag_desi(jnp.asarray(wb), jnp.asarray(wm), 3.04))
        np.testing.assert_allclose(trec.r_drag_desi(tb, tm, 3.04).numpy(), want, rtol=1e-13)


def test_desi_bbn_published():
    """bao/desi_bbn.py docstring: chi^2 = 10.29, derived r_d = 148.31 at
    H0 = 68.45, Om = 0.2976, wb = 0.02190 (lcdm)."""
    from cosmax_torch.likelihoods.bao import rd_from_z_drag

    fit = get_preset("bao.desi_bbn", "lcdm", device="cpu", dtype=F64)
    theta = torch.tensor([[68.45, 0.2976, 0.02190]], dtype=F64)
    total = float(sum(v[0] for v in fit.chi2_breakdown()(theta).values()))
    assert total == pytest.approx(10.29, abs=0.05)
    p = fit.derive(fit.spec.unpack(theta))
    assert float(rd_from_z_drag("lcdm")(p)[0]) == pytest.approx(148.31, abs=0.05)


def test_preset_options_pass_through():
    """``compression`` of bao.desi_cmb, ``z_star`` of
    bao.desi_omh2_theta_star and ``dataset`` of bao.desi, as the JAX
    package's ``**kwargs``."""
    for name, opts, term in (("bao.desi_cmb", dict(compression="desi"), "cmb_desi"),
                             ("bao.desi_omh2_theta_star", dict(z_star="hu"), "theta_star"),
                             ("bao.desi", dict(dataset="sdss_dr16_comp"), "bao")):
        with jax.enable_x64(True):
            jfit = jax_preset(name, "lcdm", **opts)
        tfit = get_preset(name, "lcdm", device="cpu", dtype=F64, **opts)
        assert tfit.note == jfit.note and tfit.data_size == jfit.data_size
        theta = points("bao.sdss" if name == "bao.desi" else name, tfit.spec)
        want = jax_breakdown(jfit, theta)
        got = tfit.chi2_breakdown()(torch.as_tensor(theta))
        assert term in got
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-9, atol=0, err_msg=k)
    sdss = get_preset("bao.sdss", "lcdm", device="cpu", dtype=F64)
    other = get_preset("bao.desi", "lcdm", device="cpu", dtype=F64, dataset="sdss_dr16_comp")
    theta = torch.as_tensor(points("bao.sdss", sdss.spec))
    assert torch.equal(sdss.chi2_breakdown()(theta)["bao"], other.chi2_breakdown()(theta)["bao"])


def test_exp_w0_parameters_and_derive():
    """exp_w0 takes w0's place: dropped in lcdm, wa after it in w0wacdm;
    the derive sets w0 = log(exp_w0) only where exp_w0 is sampled, and a
    constant H0 for every walker."""
    params = [("M", -20, -19), ("exp_w0", 0.2, 0.7)]
    assert _adjust_params(params, "lcdm") == [("M", -20, -19)]
    assert [p[0] for p in _adjust_params(params, "w0wacdm")] == ["M", "exp_w0", "wa"]
    x = torch.tensor([0.3, 0.5], dtype=F64)
    p = Derive(w0_log="exp_w0")(dict(exp_w0=x, Om=x))
    assert torch.equal(p["w0"], torch.log(x))
    assert "w0" not in Derive(w0_log="exp_w0")(dict(Om=x))
    p = Derive(h0=1.0)(dict(Om=x))
    assert torch.equal(p["H0"], torch.ones(2, dtype=F64))


def test_cli_lists_the_family(capsys):
    from cosmax_torch import fit as fit_cli

    assert fit_cli.main(["--list"]) == 0
    listed = {ln.split()[0] for ln in capsys.readouterr().out.splitlines() if ln.strip()}
    assert set(FAMILY) <= listed
