"""The quasar fits and ``cmb.cmb`` on the port's fast path: the fused
log-prob's packer and plain version against the JAX package, and the
kernel's three branches these presets take.

* a lift form past MAX_K = 32 values (``qsr.des5y``'s 50 quasar bins):
  the kernel runs the values in chunks of MAX_K, the window walked again
  for each chunk; the packer takes up to MAX_LIFT values;
* a fit with no emulated term (``cmb.cmb``, lcdm in every model): no
  grid, no forms (``H_NFORMS`` = 0, no scratch rows), the CMB block
  alone; a w0wacdm fit without one stays refused;
* a Tucker axis of rank above MAX_RANK = 16 (the w0 axis of
  ``qsr.pantheon`` and ``qsr.union3`` in wcdm, ranks 19 and 17 in both
  packages' builds): it is the outer axis of the kernel's block product,
  read row by row (at most MAX_RANK_OUTER), the inner one at most 16;
* and a split half that the compressor leaves Tucker (``sn.union3_cmb``'s
  half 1 in w0wacdm at full width), packed as the same tensor train.

Held here:

* per term, the plain version cut to that term alone (the kernel's
  oracle) against the JAX package's fast path: with the JAX bundle
  carried across (``interop.bundle_from_numpy``) within 1e-9 relative,
  with the port's own bundle within the truncation contract 1e-3 + 2e-4
  sqrt(chi^2) (the exact CMB within 1e-9), every preset in wzcdm, the two
  quasar fits of a Tucker axis past rank 16 in wcdm, and the
  quasar fits in w0wacdm on a split grid of SMALL_NODES nodes an axis
  (both packages, ``small_split_grid``), at walkers in both halves;
* the packer refuses none of the six presets in any model, and the plain
  version equals the sum of the port's fast terms there (1e-10), the
  50-value lift alone and the zero-form fit among them;
* the packed header of each branch, its work count and its limits;
* the packer's choice of the split kernel's f64 sweep (``H_SWEEP_F64``):
  ``qsr.desi`` and ``qsr.des5y_desi`` in w0wacdm and no other preset of
  the family, and on ``qsr.desi`` near its published point the 3xTF32
  sweep, emulated, past 1e-4 of max|logp| where the f64 sweep is within.

The CUDA kernel runs only on a card (``chip_smoke.py`` phase 16 holds it
against the plain version at full width there, with a planted fault per
branch); here the wrapper takes the plain version because the tensors lie
on the CPU. Each preset is built once per package in this module, with one
BLAS thread."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from chip_smoke import LOGP_RTOL, _term_alone, published_walkers
from cosmax.configs import get_preset as jax_preset
from cosmax_torch.configs import get_preset
from cosmax_torch.configs.presets import Derive, FitSpec, _spec
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods import cmb
from cosmax_torch.likelihoods.base import make_log_prob
from cosmax_torch.ops.kernels import fused_log_prob as fl
from tests.test_torch_bao_fast import _alone, _exact
from tests.test_torch_qsr_family import COMPRESSIONS, FAMILY, MODELS, points
from tests.test_torch_sn_fast import _chi2_alone
from tests.test_torch_w0wa import _sweep, _tf32_product, _thetas
from tests.test_torch_w0wa_joint import _bundle, _jax_bundle, small_split_grid

F64 = torch.float64
# in wcdm, qsr.pantheon and qsr.union3 take the Tucker axis of rank above 16
JAX_CONFIGS = [(n, "wzcdm") for n in FAMILY] + [
    (n, "wcdm") for n in ("qsr.pantheon", "qsr.union3")] + [
    (n, "w0wacdm") for n in ("qsr.des5y", "qsr.desi", "qsr.pantheon")
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
    key = "cmb.cmb/chen" if fit.name == "cmb.cmb" else fit.name
    out = [points(key, fit.spec), near]
    if fit.model == "w0wacdm":
        out.append(_thetas(fit.spec.bounds, list(fit.spec.names), seed, n=8))
    return np.concatenate(out)


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
    if name != "cmb.cmb":  # cmb.cmb has no emulated term: nothing to carry
        jb = _jax_bundle(jfit)
        kind, halves = jb.finalized()
        bundle_from_numpy(_bundle(tfit), kind,
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
    """The packer refuses none of the six presets; the plain version equals
    the sum of the fast terms, and an out-of-box and a NaN walker are -inf
    and touch no other row."""
    for name in FAMILY:
        tfit = _fast(name, model)
        theta = torch.as_tensor(_theta(tfit, seed=2))
        packed = fl.pack(tfit)
        fused = fl.fused_log_prob(packed, theta)
        terms = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(theta)
        assert bool(torch.isfinite(fused).all()), name
        np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0,
                                   err_msg=name)
        bad = torch.cat([theta, theta[:2].clone()])
        bad[-2, 0] = tfit.spec.bounds[0, 1] + 1.0
        bad[-1, tfit.spec.names.index("Om")] = float("nan")
        lp = fl.fused_log_prob_reference(packed, bad)
        assert bool(torch.all(lp[-2:] == -torch.inf)), name
        np.testing.assert_allclose(lp[:-2].numpy(), fused.numpy(), rtol=1e-12, atol=0)


def test_the_f64_sweep_where_a_float32_sweep_would_cancel():
    """The packer's rule (H_SWEEP_F64): in w0wacdm, qsr.desi and
    qsr.des5y_desi take the split kernel's f64 sweep, because their BAO
    group's table scale, set by the Om -> 0 corner of their box, exceeds
    its values at half 0's reference centre more than 1e4 times (the
    12-node grid holds that corner: the scales 8.949e4 / 7.431e4 are the
    full grid's); no other preset of the family in w0wacdm takes it, nor
    any on a Tucker grid."""
    sweep = {"qsr.desi": 8.949e4, "qsr.des5y_desi": 7.431e4}
    for name in FAMILY:
        for model in MODELS:
            tfit = _fast(name, model)  # cmb.cmb is lcdm in every model
            packed = fl.pack(tfit)
            split = tfit.model == "w0wacdm"
            want = split and name in sweep
            assert packed.hdr["H_SWEEP_F64"] == int(want), (name, model)
            assert fl.instance(packed) == (2 if want else int(split)), (name, model)
            if not split:
                continue
            emulated = [(t, *fl._emulated(t)) for t in tfit.terms if fl._emulated(t) is not None]
            worst = [fl.sweep_cancellation(emulated, h) for h in range(2)]
            if want:
                bao = [(t, k, o) for t, k, o in emulated if t.name == "bao"]
                assert fl.sweep_cancellation(bao, 0) == worst[0] > 1e4, (name, worst)
                scale = bao[0][2].handle.per_half[0][2]
                np.testing.assert_allclose(scale, sweep[name], rtol=1e-4)
                assert worst[1] < fl.SWEEP_F64_RATIO
            else:
                assert max(worst) < fl.SWEEP_F64_RATIO / 10, (name, worst)
            # the f64 sweep's shared memory fits a block
            assert fl.split_smem_bytes(packed.hdr) <= fl.MAX_SMEM


def test_qsr_desi_needs_the_f64_sweep_near_its_published_point(monkeypatch):
    """What the f64 sweep repairs, on the CPU: qsr.desi in w0wacdm near its
    published point (``chip_smoke.published_walkers``), float32 buffers
    against the f64 fast path, as chip_smoke.py phase 16 holds the kernel
    (LOGP_RTOL of max|logp|, whole and the BAO alone). The plain version,
    whose sweep runs in f64 as the kernel's f64 instance does, stays
    within; the kernel's 3xTF32 sweep, emulated, does not. (On the 12-node
    grid qsr.des5y_desi's BAO alone errs past 1e-4 from the float32 storage
    of its cores already; at full width 2.7e-5, phase 16.)"""
    tfit = _fast("qsr.desi", "w0wacdm")
    packed = fl.pack(tfit)
    theta = torch.as_tensor(published_walkers(tfit).astype(np.float64))
    names = [t.name for t in tfit.terms if fl._emulated(t) is not None]
    for key in ("whole", names.index("bao")):
        p64 = packed if key == "whole" else _term_alone(fl, packed, key)
        want = fl.fused_log_prob_reference(p64, theta).numpy()
        p32 = replace(p64, buf=p64.buf.float(), dev=p64.dev.float())
        scale = np.max(np.abs(want))
        plain = fl.fused_log_prob_reference(p32, theta.float()).double().numpy()
        with monkeypatch.context() as mp:
            mp.setattr(fl, "_tt_coeff", lambda p, h, c: _sweep(
                p, h, c, lambda a, g: _tf32_product(a, g, 3)))
            tf32 = fl.fused_log_prob_reference(p32, theta.float()).double().numpy()
        errs = [np.max(np.abs(x - want)) / scale for x in (plain, tf32)]
        assert errs[0] <= LOGP_RTOL < errs[1], (key, errs)


@pytest.mark.parametrize("model", MODELS)
def test_the_lift_of_50_values(model):
    """qsr.des5y's quasar form: a lift of 50 values (two chunks of the
    kernel's MAX_K), its rows d_ref [50], sigma^2 [50] and scale B_t; the
    plain version's lift alone equals the port's fast quasar term, chi^2
    and log-normalisation (1e-10); a lift above MAX_LIFT is refused."""
    tfit = _fast("qsr.des5y", model)
    packed = fl.pack(tfit)
    lifts = [(i, f) for i, f in enumerate(packed.forms) if fl.KINDS[f["F_KIND"]] == "lift"]
    ((i, form),) = lifts
    assert fl.MAX_K < form["F_K"] == 50 <= fl.MAX_LIFT
    for lay in packed.halves:
        assert lay["forms"][i]["F_K"] == 50
    theta = torch.as_tensor(_theta(tfit, seed=3))
    qso = next(t for t in tfit.terms if t.name == "quasars")
    p = tfit.derive(tfit.spec.unpack(theta))
    want = -0.5 * qso.chi2(p) + qso.log_norm(p)
    got = fl.fused_log_prob_reference(_alone(packed, i), theta)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fl, "MAX_LIFT", 49)
        with pytest.raises(NotImplementedError, match="lift form of 50 values.*#1a and #1c"):
            fl.pack(tfit)


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_the_fit_with_no_emulated_term(compression):
    """cmb.cmb: no grid and no forms (no scratch rows for the kernel), the
    CMB block of its compression alone; the plain version equals the
    port's CMB term (1e-10) and the JAX package's fast cmb.cmb (1e-9)."""
    tfit = get_preset("cmb.cmb", "w0wacdm", fast=True, device="cpu", dtype=F64,
                      compression=compression)
    packed = fl.pack(tfit)
    h = packed.hdr
    assert tfit.model == "lcdm" and packed.forms == () and packed.halves == ()
    assert (h["H_NFORMS"], h["H_NAXES"], h["H_KO"], h["H_KI"], h["H_SPLIT"]) == (0, 0, 0, 0, 0)
    assert h["H_HAS_CMB"] == 1 and fl._stride(packed) == 0
    assert fl.OBSERVABLES[packed.cmb["C_OBS"]] == cmb.COMPRESSIONS[compression].observables
    ops, product, nbytes = fl.work_per_walker(packed)
    assert product == 0 and nbytes == 16 and 72 * 30 < ops < 3000
    theta = _theta(tfit, seed=4)
    lp = fl.fused_log_prob(packed, torch.as_tensor(theta))
    want = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(torch.as_tensor(theta))
    np.testing.assert_allclose(lp.numpy(), want.numpy(), rtol=1e-10, atol=0)
    with jax.enable_x64(True):
        jfit = jax_preset("cmb.cmb", "lcdm", fast=True, compression=compression)
        jlp = np.asarray(jax.jit(jax.vmap(jfit.log_prob()))(jnp.asarray(theta)))
    np.testing.assert_allclose(lp.numpy(), jlp, rtol=1e-9, atol=0)


def test_no_emulated_term_stays_refused_where_no_preset_needs_it():
    """A w0wacdm fit of the CMB alone (no preset builds one: cmb.cmb is
    lcdm), and a fit with neither an emulated term nor a CMB term, are
    refused naming ROADMAP item 10c."""
    params = [("H0", 60, 70), ("Om", 0.15, 0.45), ("Obh2", 0.020, 0.024), ("w0", -2, 0),
              ("wa", -3, 2)]
    term = cmb.build_cmb_term("chen", "w0wacdm", "cpu", F64)
    fit = FitSpec("cmb_w0wa", "w0wacdm", _spec(params), (term,),
                  Derive(orh2=cmb.COMPRESSIONS["chen"].omega_r_h2()), torch.device("cpu"), F64,
                  fast=True)
    with pytest.raises(NotImplementedError, match="no emulated term.*item 10c"):
        fl.pack(fit)
    prior_only = _fast("cmb.cmb", "lcdm")
    from cosmax_torch.likelihoods import priors

    with pytest.raises(NotImplementedError, match="no emulated term and no CMB term.*item 10c"):
        fl.pack(replace(prior_only, terms=(priors.omh2_term(),)))


def test_a_tucker_axis_past_rank_16_is_the_outer_one(monkeypatch):
    """qsr.pantheon and qsr.union3 in wcdm: the port's Tucker ranks are the
    JAX package's, and one of them is above MAX_RANK; that axis is the
    outer one of the block product, KO rows read one by one, the other the
    inner one padded to 16; ranks at most 16 keep the rule that pads fewer
    rows. An outer axis above MAX_RANK_OUTER, or no axis of rank at most
    MAX_RANK, is refused."""
    ranks = {}
    for name in ("qsr.pantheon", "qsr.union3"):
        kind, (half,) = _jax_bundle(_jax(name, "wcdm")[0]).finalized()
        assert (kind, half["rep"][0]) == ("native", "tucker")
        r1, r2 = ranks[name] = tuple(int(u.shape[1]) for u in half["rep"][1])
        packed = fl.pack(_fast(name, "wcdm"))
        h = packed.hdr
        assert (h["H_R1"], h["H_R2"]) == (r1, r2) and r1 <= fl.MAX_RANK < r2
        assert h["H_INNER"] == 1 and (h["H_KO"], h["H_KI"]) == (r2, 16)
        assert r2 <= fl.MAX_RANK_OUTER
        assert fl._stride(packed) == r2 + 16 and fl.tucker_smem_bytes(h) <= fl.MAX_SMEM
        assert fl.work_per_walker(packed)[1] == 2 * h["H_R1"] * r2 * h["H_RALL"]
    flagship = fl.pack(_fast("qsr.desi", "wzcdm")).hdr
    assert max(flagship["H_R1"], flagship["H_R2"]) <= fl.MAX_RANK
    wcdm = _fast("qsr.pantheon", "wcdm")
    r1, r2 = ranks["qsr.pantheon"]
    monkeypatch.setattr(fl, "MAX_RANK_OUTER", r2 - 1)
    with pytest.raises(NotImplementedError, match=f"rank {r2}.*#1a and #1c"):
        fl.pack(wcdm)
    monkeypatch.setattr(fl, "MAX_RANK_OUTER", r2)
    monkeypatch.setattr(fl, "MAX_RANK", r1 - 1)
    with pytest.raises(NotImplementedError,
                       match=rf"Tucker ranks \({r1}, {r2}\).*#1a and #1c"):
        fl.pack(wcdm)


def test_a_tucker_split_half_packs_as_its_tensor_train():
    """A split half that the compressor leaves Tucker (sn.union3_cmb's half
    1 at full width: ranks (7, 12, 11), 22 columns) is packed as the same
    function in tensor-train form: the two smallest ranks' axes first,
    their Kronecker bond, the third factor folded into the core, an
    identity tail; equal to the Tucker contraction to rounding."""
    from cosmax_torch.models.emu_core import coeff_contract

    rng = np.random.default_rng(5)
    factors = [rng.standard_normal((40, r)) for r in (7, 12, 11)]
    core = rng.standard_normal((7, 12, 11, 22))
    kind, perm, cores, tail = fl._tucker_as_tt(("tucker", factors, core))
    assert (kind, perm) == ("tt", (0, 2, 1))
    assert [g.shape for g in cores] == [(40, 7), (7, 40, 77), (77, 40, 22)]
    assert max(g.shape[-1] for g in cores) <= fl.MAX_BOND
    np.testing.assert_array_equal(tail, np.eye(22))
    weights = [torch.as_tensor(rng.standard_normal((9, 40))) for _ in range(3)]
    want = coeff_contract(weights, ("tucker", [torch.as_tensor(u) for u in factors],
                                    torch.as_tensor(core)))
    got = coeff_contract(weights, (kind, perm, [torch.as_tensor(g) for g in cores],
                                   torch.as_tensor(tail)))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))
