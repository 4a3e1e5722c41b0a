"""The SN family of the port (the ten ``sn.*`` presets) and the rest of
``cc.*`` (``cc.cc_pantheon``, ``cc.cc_plain``, ``cc.cc_cmb``) on the
parity path, against the JAX package.

* every ``load_sn`` case equals the JAX package's to 1e-12 (values,
  covariance, redshifts, the Cepheid extras, the effective sample size),
  with and without the synthetic systematic covariance;
* each preset's spec (names, bounds, walkers, steps, seed, moves, data
  size, note) equals the JAX package's;
* per term in f64 at the centre of its box, at its published point
  (``BASELINE.md``; values the row does not give, and presets without a
  row, at the box centre) and at a seeded point in the box, rtol 1e-9:
  every preset in wzcdm (``cc.cc_cmb`` is lcdm whatever the model), the
  presets of new structure in all four models (``sn.pantheon_shoes``: a
  sampled H0 and the Cepheid rows; ``sn.des5y_cmb``: a CMB compression
  with the radiation-aware E(z); ``sn.union21``: (1 + z_cmb) in the
  distance; ``sn.des5y``: H0 fixed, none sampled; ``cc.cc_plain``: CC
  without the f nuisance);
* the published anchor of sn/union3.py: chi^2 = 23.9594 at dM = -0.070,
  Om = 0.357 (lcdm; its docstring prints 24.0), and the CLI's ``--list``.

Every JAX evaluation is jitted and takes the points of a configuration
at once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.configs import get_preset as jax_preset
from cosmax.data import loaders as jloaders
from cosmax_torch.configs import get_preset
from cosmax_torch.data import loaders as tloaders

F64 = torch.float64
FAMILY = ("sn.pantheon", "sn.pantheon_shoes", "sn.union3", "sn.des5y", "sn.union21",
          "sn.pantheon18", "sn.des5y_bins", "sn.pantheon_cmb", "sn.union3_cmb", "sn.des5y_cmb",
          "cc.cc_pantheon", "cc.cc_plain", "cc.cc_cmb")
# the presets whose structure no earlier preset had, held in all four models
NEW_STRUCTURE = ("sn.pantheon_shoes", "sn.des5y_cmb", "sn.union21", "sn.des5y", "cc.cc_plain")
MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")
# the published lcdm rows of BASELINE.md (medians); w0 = -1 and wa = 0 in
# the other models. sn.union21, sn.pantheon18, sn.des5y_bins and cc.cc_cmb
# have no row.
PUBLISHED = {
    "sn.pantheon": dict(M=-19.351, Om=0.332),
    "sn.pantheon_shoes": dict(M=-19.24, H0=73.5, Om=0.332),
    "sn.union3": dict(dM=-0.070, Om=0.357),
    "sn.des5y": dict(dM=0.022, Om=0.352),
    "sn.pantheon_cmb": dict(H0=67.21, Om=0.319, M=-19.444),
    "sn.union3_cmb": dict(H0=67.11, Om=0.319, dM=-0.167),
    "sn.des5y_cmb": dict(H0=66.86, Om=0.324, dM=-0.095),
    "cc.cc_pantheon": dict(f_cc=0.70, H0=67.1, M=-19.445, Om=0.331),
    "cc.cc_plain": dict(H0=66.8, Om=0.321),
}
# every load_sn case of the JAX package, with its size
DATASETS = {"pantheon_plus": 1590, "pantheon_plus_shoes": 1657, "union3": 22, "des5y": 1829,
            "des5y_bins": 37, "union21": 580, "pantheon18": 1048, "pantheon18_bins": 40}


def points(name, spec, seed=0):
    """[centre, published point, a seeded point] of a preset's box."""
    lo, hi = spec.bounds[:, 0], spec.bounds[:, 1]
    centre = 0.5 * (lo + hi)
    pub = dict(PUBLISHED.get(name, {}), w0=-1.0, wa=0.0)
    published = np.array([pub.get(nm, c) for nm, c in zip(spec.names, centre)])
    seeded = lo + (hi - lo) * np.random.default_rng(seed).uniform(0.1, 0.9, lo.size)
    return np.stack([centre, published, seeded])


def jax_breakdown(jfit, theta):
    with jax.enable_x64(True):
        out = jax.jit(jax.vmap(jfit.chi2_breakdown()))(jnp.asarray(theta))
        return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("synthetic", [False, True])
@pytest.mark.parametrize("name", DATASETS)
def test_load_sn_matches_jax(name, synthetic):
    with jloaders.use_synthetic_sys(synthetic):
        want = jloaders.load_sn(name)
    with tloaders.use_synthetic_sys(synthetic):
        got = tloaders.load_sn(name)
    assert got.n == want.n == DATASETS[name]
    assert (got.legend, got.synthetic_cov) == (want.legend, want.synthetic_cov)
    keys = {k for k in want.extras if not k.startswith("_")}
    assert {k for k in got.extras if not k.startswith("_")} == keys
    for key, w, g in [("values", want.values, got.values), ("cov", want.cov, got.cov)] + [
            (k, want.extras[k], got.extras[k]) for k in sorted(keys)]:
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=key)
    if synthetic and name not in ("union3", "pantheon18_bins"):
        # the synthetic term is there: off-diagonal covariance
        assert np.count_nonzero(got.cov - np.diag(np.diag(got.cov))) > got.n


def test_synthetic_seeds_are_the_jax_seeds():
    from cosmax.data.synthetic_cov import seed_for as jseed
    from cosmax_torch.data.synthetic_cov import seed_for as tseed

    for name in ("pantheon_plus", "des5y", "union21", "pantheon18"):
        assert tseed(name) == jseed(name)
        np.testing.assert_allclose(tloaders._synthetic_sys_for(name),
                                   jloaders._synthetic_sys_for(name), rtol=1e-12, atol=0)


CONFIGS = [(n, "wzcdm") for n in FAMILY] + [
    (n, m) for n in NEW_STRUCTURE for m in MODELS if m != "wzcdm"
]


@pytest.mark.parametrize("name,model", CONFIGS)
def test_parity_per_term_matches_jax(name, model):
    with jax.enable_x64(True):
        jfit = jax_preset(name, model)
    tfit = get_preset(name, model, device="cpu", dtype=F64)
    assert (tfit.model, tfit.spec.names) == (jfit.model, jfit.spec.names)
    np.testing.assert_array_equal(tfit.spec.bounds, jfit.spec.bounds)
    assert (tfit.n_walkers, tfit.n_steps, tfit.burn_in, tfit.seed, tfit.data_size) == (
        jfit.n_walkers, jfit.n_steps, jfit.burn_in, jfit.seed, jfit.data_size)
    assert tfit.note == jfit.note
    assert [(m.kind, m.weight) for m in tfit.moves] == [(m.kind, m.weight) for m in jfit.moves]
    theta = points(name, tfit.spec)
    want = jax_breakdown(jfit, theta)
    got = tfit.chi2_breakdown()(torch.as_tensor(theta))
    assert set(got) == set(want)
    for term, w in want.items():
        assert np.all(np.isfinite(w)), term
        np.testing.assert_allclose(got[term].numpy(), w, rtol=1e-9, atol=0, err_msg=term)


def test_union3_published_anchor():
    """sn/union3.py (lcdm): chi^2 = 23.9594 at the published medians, the
    JAX package's value (the docstring prints 24.0)."""
    fit = get_preset("sn.union3", "lcdm", device="cpu", dtype=F64)
    chi2 = fit.chi2_breakdown()(torch.tensor([[-0.070, 0.357]], dtype=F64))["sn"]
    assert float(chi2[0]) == pytest.approx(23.9594, abs=5e-5)


def test_cc_cmb_is_lcdm_in_every_model():
    for model in MODELS:
        fit = get_preset("cc.cc_cmb", model, device="cpu", dtype=F64)
        assert fit.model == "lcdm" and fit.spec.names == ("H0", "Om", "Obh2", "f_cc")


def test_cc_plain_has_no_normalisation():
    """The CC term without f: the plain chi^2, no log-normalisation, no
    rescaling for the packer."""
    fit = get_preset("cc.cc_plain", "wzcdm", device="cpu", dtype=F64)
    cc = next(t for t in fit.terms if t.name == "cc")
    assert cc.log_norm is None and "rescale" not in cc.meta
    theta = torch.as_tensor(points("cc.cc_plain", fit.spec))
    lp = fit.log_prob()(theta)
    chi = fit.chi2_breakdown()(theta)
    torch.testing.assert_close(lp, -0.5 * (chi["cc"] + chi["omh2"]), rtol=1e-14, atol=0)


def test_cli_lists_every_ported_preset(capsys):
    from cosmax.configs import list_presets as jax_presets
    from cosmax_torch import fit as fit_cli
    from tests.test_torch_bao_family import FAMILY as BAO

    assert fit_cli.main(["--list"]) == 0
    listed = {ln.split()[0] for ln in capsys.readouterr().out.splitlines() if ln.strip()}
    assert set(FAMILY) | set(BAO) <= listed and len(listed) == 45
    assert listed == set(jax_presets())
