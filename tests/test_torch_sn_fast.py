"""The SN family and the rest of ``cc.*`` on the port's fast path: the
fused log-prob's packer and plain version against the JAX package.

No new branch of the kernel is needed: a fixed-H0 SN form has one
nuisance column (the magnitude), an SN-only fit samples no H0, the SN +
CMB fits are the flagship's terms without BAO, and ``cc.cc_plain``'s CC
form has no rescaling (``F_F_IDX`` = -1).

* per term, the plain version cut to that term alone (the kernel's
  oracle) against the JAX package's fast path: with the JAX bundle
  carried across (``interop.bundle_from_numpy``) within 1e-9 relative,
  with the port's own bundle within the truncation contract 1e-3 + 2e-4
  sqrt(chi^2) (the exact terms, the CMB and the prior, within 1e-9), in
  wzcdm for every preset, and in w0wacdm on a split grid of SMALL_NODES
  nodes an axis (both packages, ``small_split_grid``) for the presets of
  new structure, at walkers in both halves;
* the packer refuses none of the 13 presets in any model, and the plain
  version equals the sum of the port's fast terms there (1e-10);
* the packed header: no H0 slot where none is sampled, the Cepheid fit's
  two nuisance columns, the radiation of the SN + CMB fits.

The CUDA kernel runs only on a card (``chip_smoke.py`` phase 15 holds it
against the plain version at full width there); here the wrapper takes
the plain version because the tensors lie on the CPU. Each preset is
built once per package in this module, with one BLAS thread."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cosmax.configs import get_preset as jax_preset
from cosmax_torch.configs import get_preset
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods.base import make_log_prob
from cosmax_torch.ops.kernels import fused_log_prob as fl
from tests.test_torch_bao_fast import _exact, _plain_terms
from tests.test_torch_sn_family import FAMILY, MODELS, NEW_STRUCTURE, points
from tests.test_torch_w0wa import _thetas
from tests.test_torch_w0wa_joint import _bundle, _jax_bundle, small_split_grid

F64 = torch.float64
JAX_CONFIGS = [(n, "wzcdm") for n in FAMILY] + [
    (n, "w0wacdm") for n in NEW_STRUCTURE
]


@pytest.fixture(scope="module", autouse=True)
def _small_grid_one_blas_thread():
    with small_split_grid(), threadpool_limits(1):
        yield


@functools.lru_cache(maxsize=None)
def _fast(name, model):
    """The port's fast build in f64, once per configuration in this module."""
    return get_preset(name, model, fast=True, device="cpu", dtype=F64)


def _theta(fit, seed=0):
    """The box's centre, published and seeded points, and walkers about
    the centre; in w0wacdm also walkers in half 1 (s = w0 + wa > 0)."""
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    rng = np.random.default_rng(seed)
    near = 0.5 * (lo + hi) + 0.08 * (hi - lo) * rng.standard_normal((5, len(lo)))
    near = np.clip(near, lo + 1e-3 * (hi - lo), hi - 1e-3 * (hi - lo))
    out = [points(fit.name, fit.spec), near]
    if fit.model == "w0wacdm":
        out.append(_thetas(fit.spec.bounds, list(fit.spec.names), seed, n=8))
    return np.concatenate(out)


def _chi2_alone(fit, theta):
    """chi^2 of each term from the plain version, each term alone: -2 logp
    of the term's cut, plus twice its log-normalisation (the rescaled CC
    form's const + coef ln f)."""
    got = _plain_terms(fit, fl.pack(fit), theta)
    p = fit.derive(fit.spec.unpack(torch.as_tensor(theta)))
    for t in fit.terms:
        if t.log_norm is not None:
            got[t.name] = got[t.name] + 2.0 * t.log_norm(p).numpy()
    return got


def _emulated_first(fit):
    """``fit`` with its CMB term last: the helpers find the bundle in the
    first term, and the SN + CMB fits list the CMB first."""
    return replace(fit, terms=sorted(fit.terms, key=lambda t: t.name.startswith("cmb")))


@functools.lru_cache(maxsize=None)
def _jax(name, model):
    """The JAX package's fast build and its jitted breakdown at _theta."""
    theta = _theta(_fast(name, model))
    with jax.enable_x64(True):
        jfit = jax_preset(name, model, fast=True)
        chi = jax.jit(jax.vmap(jfit.chi2_breakdown()))(jnp.asarray(theta))
        return jfit, theta, {k: np.asarray(v) for k, v in chi.items()}


@pytest.mark.parametrize("name,model", JAX_CONFIGS)
def test_fast_with_the_jax_bundle_carried_across(name, model):
    jfit, theta, want = _jax(name, model)
    tfit = get_preset(name, model, fast=True, device="cpu", dtype=F64)
    jb = _jax_bundle(_emulated_first(jfit))
    kind, halves = jb.finalized()
    bundle_from_numpy(_bundle(_emulated_first(tfit)), kind,
                      [dict(axes=h["axes"], bw=h["bw"], rep=h["rep"]) for h in halves],
                      {key[0]: handle.per_half for key, (_, handle) in jb.regs.items()})
    got = _chi2_alone(tfit, theta)
    assert set(got) == set(want)
    for term, w in want.items():
        np.testing.assert_allclose(got[term], w, rtol=1e-9, atol=0, err_msg=term)


@pytest.mark.parametrize("name,model", JAX_CONFIGS)
def test_fast_own_bundle_within_the_truncation_contract(name, model):
    _, theta, want = _jax(name, model)
    tfit = _fast(name, model)
    got = _chi2_alone(tfit, theta)
    assert set(got) == set(want)
    for term, w in want.items():
        if _exact(tfit, term):
            np.testing.assert_allclose(got[term], w, rtol=1e-9, atol=0, err_msg=term)
        else:
            tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(w, 0.0))
            assert np.all(np.abs(got[term] - w) <= tol), (term, got[term] - w)


@pytest.mark.parametrize("model", MODELS)
def test_every_preset_packs(model):
    """The packer refuses none of the 13 presets; the plain version equals
    the sum of the fast terms, and an out-of-box walker is -inf."""
    for name in FAMILY:
        tfit = _fast(name, model)
        theta = torch.as_tensor(_theta(tfit, seed=2))
        packed = fl.pack(tfit)
        fused = fl.fused_log_prob(packed, theta)
        terms = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(theta)
        assert bool(torch.isfinite(fused).all()), name
        np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0,
                                   err_msg=name)
        bad = theta[:1].clone()
        bad[0, 0] = tfit.spec.bounds[0, 1] + 1.0
        assert float(fl.fused_log_prob_reference(packed, bad)[0]) == -np.inf, name


@pytest.mark.parametrize("model", MODELS)
def test_packed_header_of_the_new_structure(model):
    """What the packer writes for the new structure: no H0 slot in an
    SN-only fit at a fixed H0 (one nuisance column, the magnitude); two
    columns and H0's slot for the Cepheid fit; Omega_r h^2 and the CMB
    block for the SN + CMB fits; no rescaling for cc.cc_plain."""
    def sn_form(packed):
        return next(f for f in packed.forms if f["F_MAG_IDX"] >= 0)

    des5y = fl.pack(_fast("sn.des5y", model))
    assert des5y.hdr["H_I_H0"] == -1 and des5y.hdr["H_HAS_CMB"] == 0
    assert sn_form(des5y)["F_J"] == 1
    shoes = _fast("sn.pantheon_shoes", model)
    packed = fl.pack(shoes)
    assert packed.hdr["H_I_H0"] == shoes.spec.names.index("H0") and sn_form(packed)["F_J"] == 2
    cmb = _fast("sn.des5y_cmb", model)
    packed = fl.pack(cmb)
    assert packed.hdr["H_HAS_CMB"] == 1 and packed.hdr["H_ORH2"] == cmb.derive.orh2 > 0
    plain = fl.pack(_fast("cc.cc_plain", model))
    (form,) = plain.forms
    assert (form["F_F_IDX"], form["F_BETA"]) == (-1, 2)
    for off in [lay["T_OFF_FORMS"] for lay in plain.halves] or [plain.hdr["H_OFF_FORMS"]]:
        assert float(plain.buf[off + fl.FORM["F_POW"]]) == 1.0
    assert fl.PRIORS[plain.hdr["H_PRIOR"]] == "omh2"
    assert fl.pack(_fast("cc.cc_cmb", model)).hdr["H_MODEL"] == fl.MODELS.index("lcdm")
