"""The quasar fits of the port (the five ``qsr.*`` presets) and
``cmb.cmb`` on the parity path, against the JAX package.

* each preset's spec (names, bounds, walkers, steps, burn-in, seed,
  moves, data size, note) equals the JAX package's;
* per term in f64 at the centre of its box, at its published point
  (``BASELINE.md``'s lcdm medians; w0 = -1 and wa = 0 in the other
  models) and at a seeded point in the box, rtol 1e-9: the five quasar
  fits in all four models (22 bins with Pantheon+ or Union3 at a fixed
  H0 = 70; 50 bins with DES-SN5YR; with DESI BAO on the 3000-point
  trapezoids at H0 = 70 for every walker, and the three probes), and
  ``cmb.cmb`` in each of its four compressions (lcdm whatever the model);
* ``sigma_mu_type`` reaches the quasar term as in the JAX package;
* the published anchor of quasars/qsr_desi.py: BAO 10.32 and QSO 19.62
  at dM_qsr = -0.197, s = 0.408, rd = 144.857, Om = 0.299 (lcdm). The
  ``VALIDATION.md`` rows qsr.desi[wzcdm] and qsr.union3[wzcdm] are not
  compared: they were made with a poisoned table cache.

Every JAX evaluation is jitted and takes the points of a configuration
at once."""

import jax
import numpy as np
import pytest
import torch

from cosmax.configs import get_preset as jax_preset
from cosmax_torch.configs import get_preset
from tests.test_torch_sn_family import jax_breakdown

F64 = torch.float64
QSR = ("qsr.pantheon", "qsr.union3", "qsr.desi", "qsr.des5y_desi", "qsr.des5y")
FAMILY = QSR + ("cmb.cmb",)
MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")
COMPRESSIONS = ("chen", "act", "desi", "union3")
# the published lcdm medians of BASELINE.md (values a row does not give at
# the box centre)
PUBLISHED = {
    "qsr.pantheon": dict(dM_qsr=-0.144, s=0.392, M=-19.349, Om=0.337),
    "qsr.union3": dict(dM_qsr=-0.099, s=0.382, dM=-0.068, Om=0.370),
    "qsr.des5y": dict(dM_qsr=-0.078, s=1.518, dM=0.040, Om=0.382),
    "qsr.desi": dict(dM_qsr=-0.197, s=0.408, rd=144.857, Om=0.299),
    "qsr.des5y_desi": dict(dM_qsr=-0.181, s=0.402, dM=-0.003, rd=143.48, Om=0.312),
    "cmb.cmb/chen": dict(H0=67.40, Om=0.3167, Obh2=0.02236),
    "cmb.cmb/act": dict(H0=67.23, Om=0.3170),
    "cmb.cmb/desi": dict(H0=67.50, Om=0.3119),
    "cmb.cmb/union3": dict(H0=67.39, Om=0.3148),
}


def points(key, spec, seed=0):
    """[centre, published point, a seeded point] of a preset's box; ``key``
    the preset's name, or for cmb.cmb ``cmb.cmb/<compression>``."""
    lo, hi = spec.bounds[:, 0], spec.bounds[:, 1]
    centre = 0.5 * (lo + hi)
    pub = dict(PUBLISHED.get(key, {}), w0=-1.0, wa=0.0)
    published = np.array([pub.get(nm, c) for nm, c in zip(spec.names, centre)])
    seeded = lo + (hi - lo) * np.random.default_rng(seed).uniform(0.1, 0.9, lo.size)
    return np.stack([centre, published, seeded])


def _hold(tfit, jfit, key):
    """The spec of ``tfit`` equals ``jfit``'s, and each term's chi^2 at
    ``points`` within 1e-9 relative."""
    assert (tfit.model, tfit.spec.names) == (jfit.model, jfit.spec.names)
    np.testing.assert_array_equal(tfit.spec.bounds, jfit.spec.bounds)
    assert (tfit.n_walkers, tfit.n_steps, tfit.burn_in, tfit.seed, tfit.data_size) == (
        jfit.n_walkers, jfit.n_steps, jfit.burn_in, jfit.seed, jfit.data_size)
    assert tfit.note == jfit.note
    assert [(m.kind, m.weight) for m in tfit.moves] == [(m.kind, m.weight) for m in jfit.moves]
    theta = points(key, tfit.spec)
    want = jax_breakdown(jfit, theta)
    got = tfit.chi2_breakdown()(torch.as_tensor(theta))
    assert set(got) == set(want)
    for term, w in want.items():
        assert np.all(np.isfinite(w)), term
        np.testing.assert_allclose(got[term].numpy(), w, rtol=1e-9, atol=0, err_msg=term)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", QSR)
def test_parity_per_term_matches_jax(name, model):
    with jax.enable_x64(True):
        jfit = jax_preset(name, model)
    _hold(get_preset(name, model, device="cpu", dtype=F64), jfit, name)


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_cmb_cmb_matches_jax_in_each_compression(compression):
    """cmb.cmb is lcdm whatever the model asked for, in both packages."""
    with jax.enable_x64(True):
        jfit = jax_preset("cmb.cmb", "wzcdm", compression=compression)
    tfit = get_preset("cmb.cmb", "wzcdm", device="cpu", dtype=F64, compression=compression)
    assert tfit.model == "lcdm" and tfit.spec.names == ("H0", "Om", "Obh2")
    _hold(tfit, jfit, f"cmb.cmb/{compression}")


def test_sigma_mu_type_reaches_the_quasar_term():
    """The aggregation mode of the quasar bins changes the quasar term as
    in the JAX package (rms aggregates are sqrt(n) wider: chi^2 drops)."""
    theta = np.array([[-0.197, 0.408, 144.857, 0.299]])
    got = {}
    for mode in ("sem_errors", "rms_errors", "sem_data"):
        with jax.enable_x64(True):
            jfit = jax_preset("qsr.desi", "lcdm", sigma_mu_type=mode)
        want = jax_breakdown(jfit, theta)["quasars"]
        fit = get_preset("qsr.desi", "lcdm", device="cpu", dtype=F64, sigma_mu_type=mode)
        got[mode] = float(fit.chi2_breakdown()(torch.as_tensor(theta))["quasars"][0])
        np.testing.assert_allclose(got[mode], want[0], rtol=1e-9, atol=0, err_msg=mode)
    assert got["rms_errors"] < got["sem_errors"] != got["sem_data"]


def test_qsr_desi_published_anchor():
    """quasars/qsr_desi.py: BAO 10.32 + QSO 19.62 at the published medians
    (lcdm), as the JAX package's tests hold it."""
    fit = get_preset("qsr.desi", "lcdm", device="cpu", dtype=F64)
    chis = fit.chi2_breakdown()(torch.tensor([[-0.197, 0.408, 144.857, 0.299]], dtype=F64))
    assert float(chis["bao"][0]) == pytest.approx(10.32, abs=0.05)
    assert float(chis["quasars"][0]) == pytest.approx(19.62, abs=0.05)
