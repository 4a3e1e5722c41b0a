"""The BAO family on the port's fast path, and the fused log-prob's #1e
branches in its packer and plain version, against the JAX package.

The branches: K1 the scalar priors (Om h^2, or a BBN prior on the sampled
omega_b), K2 the walker's r_d (r_s(z_drag) by GL-128, or a drag fitting
formula), K3 the 100 theta* prior in the CMB block, K4 the H0-free fit
(H0 = 1 for every walker, r_d = 100 rd_h, the SN form without H0), K5
w0 = log(exp_w0). Each is held on the presets that need it:

* per term, the plain version cut to that term alone (``fused_log_prob
  _reference``, the kernel's oracle) against the JAX package's fast path:
  with the JAX bundle carried across (``interop.bundle_from_numpy``)
  within 1e-9 relative, with the port's own bundle within the truncation
  contract 1e-3 + 2e-4 sqrt(chi^2) (the exact terms, theta* and the
  priors, within 1e-9), in wzcdm, and in w0wacdm on a split grid of
  SMALL_NODES nodes an axis (both packages, ``small_split_grid``);
* the plain version against the sum of the port's fast terms in all four
  models, 1e-10 relative, out-of-box and NaN rows -inf;
* all 17 presets pack in each model (the packer refuses none);
* the packed header of each branch, the work count, the refusals that
  remain (theta* beside a compression, a two-dimensional prior, BAO
  terms with different r_d) and the layout constants the kernel shares.

The CUDA kernel runs only on a card (``chip_smoke.py`` phase 14 holds it
against the plain version there, each term alone, with a planted fault
per branch); here the wrapper takes the plain version because the
tensors lie on the CPU. Each preset is built once per package in this
module, with one BLAS thread."""

import functools
import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cosmax.configs import get_preset as jax_preset
from cosmax_torch.configs import get_preset
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods.base import Term, make_log_prob
from cosmax_torch.ops.kernels import fused_log_prob as fl
from tests.test_torch_bao_family import FAMILY, MODELS, points
from tests.test_torch_w0wa_joint import _bundle, _jax_bundle, small_split_grid

F64 = torch.float64
# preset: (its header as the packer writes it) - the branches it carries
BRANCHES = {
    "bao.desi_bbn": dict(H_RD_KIND="z_drag", H_PRIOR="param"),
    "bao.desi_des5y_bbn": dict(H_RD_KIND="desi", H_PRIOR="param"),
    "bao.desi_union3_bbn": dict(H_RD_KIND="aizpuru", H_PRIOR="param"),
    "bao.desi_omh2_theta_star": dict(H_RD_KIND="param", H_PRIOR="omh2", C_OBS="theta_100"),
    "bao.desi_bbn_theta_star": dict(H_RD_KIND="param", H_PRIOR="param", C_OBS="theta_100"),
    "bao.desi_des5y": dict(H_RD_KIND="param", H_PRIOR="none", H_H0_CONST=1.0),
    "bao.desi_pantheon": dict(H_RD_KIND="fixed", H_PRIOR="none", H_W0_LOG=1),
}
# the configurations held against the JAX package's fast path
JAX_CONFIGS = [(n, "wzcdm") for n in BRANCHES] + [
    (n, "w0wacdm") for n in ("bao.desi_bbn", "bao.desi_omh2_theta_star", "bao.desi_des5y",
                             "bao.desi_pantheon")
]


@pytest.fixture(scope="module", autouse=True)
def _small_grid_one_blas_thread():
    with small_split_grid(), threadpool_limits(1):
        yield


@functools.lru_cache(maxsize=None)
def _fast(name, model):
    """The port's fast build in f64, once per configuration in this module."""
    return get_preset(name, model, fast=True, device="cpu", dtype=F64)


def _theta(fit, n=6, seed=0):
    """The box centre, the published point and walkers about the centre."""
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    rng = np.random.default_rng(seed)
    near = 0.5 * (lo + hi) + 0.08 * (hi - lo) * rng.standard_normal((n, len(lo)))
    return np.concatenate([points(fit.name, fit.spec), np.clip(near, lo + 1e-3 * (hi - lo),
                                                                hi - 1e-3 * (hi - lo))])


@functools.lru_cache(maxsize=None)
def _jax(name, model):
    """The JAX package's fast build and its jitted breakdown at _theta."""
    theta = _theta(_fast(name, model))
    with jax.enable_x64(True):
        jfit = jax_preset(name, model, fast=True)
        chi = jax.jit(jax.vmap(jfit.chi2_breakdown()))(jnp.asarray(theta))
        return jfit, theta, {k: np.asarray(v) for k, v in chi.items()}


def _alone(packed, key):
    """The packed plain version's layout cut to one term: form ``key``,
    the CMB block (None) or the scalar prior ("prior")."""
    hdr = dict(packed.hdr, H_PRIOR=packed.hdr["H_PRIOR"] if key == "prior" else 0)
    if isinstance(key, int):
        hdr["H_OFF_FORMS"] += key * fl.FORM_STRIDE
        forms = (packed.forms[key],)
        halves = tuple(dict(lay, forms=(lay["forms"][key],),
                            T_OFF_FORMS=lay["T_OFF_FORMS"] + key * fl.FORM_STRIDE)
                       for lay in packed.halves)
    else:
        forms, halves = (), tuple(dict(lay, forms=()) for lay in packed.halves)
    return replace(packed, hdr=hdr, forms=forms, cmb=packed.cmb if key is None else {},
                   halves=halves)


def _plain_terms(fit, packed, theta):
    """chi^2 of each term of ``fit`` from the plain version, each term alone:
    {term name: [W]}."""
    emulated = [t for t in fit.terms if fl._emulated(t) is not None]
    keys = {t.name: i for i, t in enumerate(emulated)}
    for t in fit.terms:
        if "theta_star" in t.meta or "compression" in t.meta:
            keys[t.name] = None
        elif "scalar_prior" in t.meta:
            keys[t.name] = "prior"
    th = torch.as_tensor(theta)
    return {name: (-2.0 * fl.fused_log_prob_reference(_alone(packed, k), th)).numpy()
            for name, k in keys.items()}


def _exact(fit, name):
    return fl._emulated(next(t for t in fit.terms if t.name == name)) is None


@pytest.mark.parametrize("name,model", JAX_CONFIGS)
def test_branch_with_the_jax_bundle_carried_across(name, model):
    jfit, theta, want = _jax(name, model)
    tfit = get_preset(name, model, fast=True, device="cpu", dtype=F64)
    jb = _jax_bundle(jfit)
    kind, halves = jb.finalized()
    bundle_from_numpy(_bundle(tfit), kind,
                      [dict(axes=h["axes"], bw=h["bw"], rep=h["rep"]) for h in halves],
                      {key[0]: handle.per_half for key, (_, handle) in jb.regs.items()})
    got = _plain_terms(tfit, fl.pack(tfit), theta)
    assert set(got) == set(want)
    for term, w in want.items():
        np.testing.assert_allclose(got[term], w, rtol=1e-9, atol=0, err_msg=term)


@pytest.mark.parametrize("name,model", JAX_CONFIGS)
def test_branch_own_bundle_within_the_truncation_contract(name, model):
    _, theta, want = _jax(name, model)
    tfit = _fast(name, model)
    got = _plain_terms(tfit, fl.pack(tfit), theta)
    assert set(got) == set(want)
    for term, w in want.items():
        if _exact(tfit, term):
            np.testing.assert_allclose(got[term], w, rtol=1e-9, atol=0, err_msg=term)
        else:
            tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(w, 0.0))
            assert np.all(np.abs(got[term] - w) <= tol), (term, got[term] - w)


@pytest.mark.parametrize("name", BRANCHES)
@pytest.mark.parametrize("model", MODELS)
def test_fused_plain_matches_the_terms(name, model):
    """The plain version against the sum of the port's fast terms; an
    out-of-box and a NaN walker are -inf and touch no other row."""
    tfit = _fast(name, model)
    packed = fl.pack(tfit)
    for k, v in BRANCHES[name].items():
        v = 0 if (k, model) == ("H_W0_LOG", "lcdm") else v  # lcdm samples no w0
        table = {"H_RD_KIND": fl.RD_KINDS, "H_PRIOR": fl.PRIORS}.get(k)
        got = packed.cmb[k] if k.startswith("C_") else packed.hdr[k]
        assert got == (fl.OBSERVABLES.index(v) if k == "C_OBS" else
                       table.index(v) if table else v), k
    theta = torch.as_tensor(_theta(tfit, n=30, seed=1))
    fused = fl.fused_log_prob(packed, theta)
    terms = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(theta)
    assert bool(torch.isfinite(fused).all())
    np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0)
    bad = torch.cat([theta, theta[:2].clone()])
    hi = tfit.spec.bounds[0, 1]
    bad[-2, 0] = hi + 1.0
    bad[-1, tfit.spec.names.index("Om")] = float("nan")
    lp = fl.fused_log_prob_reference(packed, bad)
    assert bool(torch.all(lp[-2:] == -torch.inf))
    np.testing.assert_allclose(lp[:-2].numpy(), fused.numpy(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("model", MODELS)
def test_every_family_preset_packs(model):
    """The packer refuses none of the 17 presets; the plain version equals
    the sum of the fast terms at a few walkers."""
    for name in FAMILY:
        tfit = _fast(name, model)
        theta = torch.as_tensor(_theta(tfit, n=2, seed=2))
        fused = fl.fused_log_prob(fl.pack(tfit), theta)
        terms = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(theta)
        np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0,
                                   err_msg=name)


def test_work_count_of_the_branches():
    """The per-walker count grows by each branch's work: the z_drag
    quadrature's 128 nodes, theta*'s 72, a drag formula and a prior a few
    operations."""
    def ops(packed, cmb=None, **hdr):
        return fl.work_per_walker(replace(packed, hdr=dict(packed.hdr, **hdr),
                                          cmb=packed.cmb if cmb is None else cmb))[0]

    fixed = dict(H_RD_KIND=fl.RD_KINDS.index("fixed"))
    bbn = fl.pack(_fast("bao.desi_bbn", "wzcdm"))
    assert ops(bbn) - ops(bbn, **fixed) > 128 * 30
    theta = fl.pack(_fast("bao.desi_omh2_theta_star", "wzcdm"))
    assert ops(theta) - ops(theta, cmb={}) > 72 * 30
    drag = fl.pack(_fast("bao.desi_des5y_bbn", "wzcdm"))
    assert 0 < ops(drag) - ops(drag, **fixed) < 50
    assert 0 < ops(drag) - ops(drag, H_PRIOR=0) < ops(theta) - ops(theta, H_PRIOR=0) < 10


def test_rd_over_h_branch(monkeypatch):
    """r_d = (r_d h) / h, which no preset uses: bao.desi_bbn_theta_star with
    its sampled rd read as r_d h in both packages. The parity BAO term
    against the JAX package's (1e-9), the plain fused version against
    the port's fast terms (1e-10)."""
    import cosmax.likelihoods.bao as jbao

    from cosmax_torch.likelihoods import bao

    monkeypatch.setattr(bao, "rd_param", bao.rd_over_h)
    monkeypatch.setattr(jbao, "rd_param", jbao.rd_over_h)
    name = "bao.desi_bbn_theta_star"
    par = get_preset(name, "wzcdm", device="cpu", dtype=F64)
    fast = get_preset(name, "wzcdm", fast=True, device="cpu", dtype=F64)
    packed = fl.pack(fast)
    assert fl.RD_KINDS[packed.hdr["H_RD_KIND"]] == "over_h"
    theta = _theta(fast)
    with jax.enable_x64(True):
        want = jax.jit(jax.vmap(jax_preset(name, "wzcdm").chi2_breakdown()))(jnp.asarray(theta))
    th = torch.as_tensor(theta)
    np.testing.assert_allclose(par.chi2_breakdown()(th)["bao"].numpy(), np.asarray(want["bao"]),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(fl.fused_log_prob(packed, th).numpy(),
                               make_log_prob(fast.spec, fast.terms, fast.derive)(th).numpy(),
                               rtol=1e-10, atol=0)


def test_packer_refusals_name_their_item():
    """What the packer still refuses names ROADMAP item 10c: theta*
    beside a CMB compression (no preset has both; the kernel has one CMB
    block), a prior it has no branch for (the Schoneberg 2 x 2 BBN prior,
    not ported), BAO terms with different r_d treatments, r_s(z_drag) of
    another model."""
    from cosmax_torch.likelihoods import bao, cmb, priors

    fit = _fast("bao.desi_omh2_theta_star", "wzcdm")
    comp = cmb.build_cmb_term("desi", "wzcdm", "cpu", F64)
    with pytest.raises(NotImplementedError, match="item 10c"):
        fl.pack(replace(fit, terms=fit.terms + (comp,)))
    assert not hasattr(priors, "bbn_shonberg_2d_term")
    two_d = Term("bbn_shonberg2d", chi2=lambda p: p["Obh2"] * 0.0, meta=dict(n=2))
    with pytest.raises(NotImplementedError, match="item 10"):
        fl.pack(replace(fit, terms=fit.terms[:1] + (two_d,)))
    prior_2 = replace(priors.bbn_term("chen"), name="bbn_2")
    with pytest.raises(NotImplementedError, match="item 10c"):
        fl.pack(replace(fit, terms=fit.terms + (prior_2,)))
    bbn = _fast("bao.desi_bbn", "wzcdm")
    with pytest.raises(NotImplementedError, match="item 10c"):
        fl.pack(replace(bbn, terms=(bbn.terms[0], replace(
            bbn.terms[0], meta=dict(bbn.terms[0].meta, rd=bao.rd_fixed())))))
    with pytest.raises(NotImplementedError, match="item 10c"):
        fl.pack(replace(bbn, terms=(replace(
            bbn.terms[0], meta=dict(bbn.terms[0].meta, rd=bao.rd_from_z_drag("lcdm"))),)))


def test_kernel_source_agrees_on_the_1e_branches():
    """The .cu file's r_d kinds, prior kinds, theta* observable and
    z_drag rule size equal the packer's (the tables themselves are held by
    tests/test_torch_fast.py::test_kernel_source_agrees_with_the_packer)."""
    src = (Path(fl.__file__).resolve().parents[2] / "csrc" / "fused_log_prob.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for kind in ("fixed", "param", "over_h", "aizpuru", "desi"):
        assert consts[f"RD_{kind.upper()}"] == fl.RD_KINDS.index(kind), kind
    assert fl.RD_KINDS[-1] == "z_drag"  # every kind above RD_DESI
    assert consts["PRIOR_OMH2"] == fl.PRIORS.index("omh2") and fl.PRIORS[0] == "none"
    assert consts["OBS_THETA_100"] == fl.OBSERVABLES.index("theta_100")
    assert consts["MAX_GL_RD"] == fl.MAX_GL_RD
    assert fl.CMB["C_SIGMA"] < fl.CMB["C_NODES"]
