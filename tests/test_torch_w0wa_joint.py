"""The port's w0wacdm fast path for the multiprobe family
(``joint.multiprobe``, ``fs8.fs8``, ``cc.cc_union3``, ``cc.cc_des5y``: CC,
quasars and fsigma8 on the split grid) and ``cc.cc``'s Om h^2 prior in the
fused log-prob, against the JAX package.

The split grid is cut to SMALL_NODES Chebyshev nodes an axis in both
packages (``small_split_grid``: each package's ``_grid_spec`` wrapped and
its finalize memo, whose keys do not hold the grid's size, kept apart),
so that a w0wacdm build takes seconds. Each preset is built once per
package in this module, with one BLAS thread.

* per term in f64, at walkers in both halves: with the JAX bundle carried
  across (``interop.bundle_from_numpy``) within 1e-9 relative; with each
  package's own bundle within the truncation contract 1e-3 + 2e-4
  sqrt(chi^2); the tensor trains' axis orders equal and bonds within one;
* the fs8 curves (the growth ODE's and the AP one) on a few hundred
  nodes of each half of the rotated grid, against JAX's to 1e-10
  relative; their build over chunks of nodes gives the same rows to
  rounding;
* ``fused_log_prob_reference`` against ``make_log_prob`` at 70 walkers,
  35 on each side of s = w0 + wa = 0, 1e-10 relative;
* the split kernel's sweep emulated in 3xTF32 on the multiprobe: the
  quasar lift and the fs8 amplitude pair (and every other term) each
  alone within 1e-4 of its own max|logp| of the f64 plain version, where
  one TF32 pass exceeds it on both;
* ``cc.cc`` fast in the four models: the prior in the packed header, the
  fused plain version against the terms, the fast terms against the
  port's parity path and the JAX package's fast and parity terms.

The CUDA kernel runs only on a card (``chip_smoke.py`` phase 13 holds it
against the plain version at full width there); here the wrapper takes
the plain version because the tensors lie on the CPU."""

import inspect
from contextlib import contextmanager
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cosmax.configs import get_preset as jax_preset
from cosmax.models import linear_chi2 as jlc
from cosmax_torch.configs import get_preset
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods import fs8 as tfs8
from cosmax_torch.likelihoods.base import make_log_prob
from cosmax_torch.models import linear_chi2 as tlc
from cosmax_torch.ops.kernels import fused_log_prob as fl
from tests.test_torch_w0wa import _sweep, _tf32_product, _thetas

F64 = torch.float64
SMALL_NODES = 12
PRESETS = ("joint.multiprobe", "fs8.fs8", "cc.cc_union3", "cc.cc_des5y")
# each package's own split grid, 40 nodes an axis
FULL_GRID = {tlc: tlc._grid_spec, jlc: jlc._grid_spec}
KINDS = {"joint.multiprobe": ["linear", "linear", "linear", "lift", "amp_pair"],
         "fs8.fs8": ["amp_pair"], "cc.cc_union3": ["linear", "linear"],
         "cc.cc_des5y": ["linear", "linear"]}


@contextmanager
def small_split_grid():
    """The w0wacdm split grid of both packages cut to SMALL_NODES nodes an
    axis, with fresh finalize memos, for the duration."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tlc, jlc):
            grid = mod._grid_spec
            mp.setattr(mod, "_grid_spec", lambda model, n, domains, grid=grid: grid(
                model, SMALL_NODES if model == "w0wacdm" else n, domains))
            mp.setattr(mod, "_FINALIZE_MEMO", {})
        yield


def _jax_bundle(jfit):
    """The JAX fast preset's bundle, found in its first term's closures."""
    fns = [jfit.terms[0].chi2]
    while True:
        found = inspect.getclosurevars(fns.pop()).nonlocals
        if "bundle" in found:
            return found["bundle"]
        fns += [v for v in found.values() if inspect.isfunction(v)]


def _jax_bundle_of(jfit):
    """The JAX fast preset's finalized bundle as numpy: the arguments of
    ``bundle_from_numpy``."""
    jb = _jax_bundle(jfit)
    kind, halves = jb.finalized()
    out = []
    for h in halves:
        _, perm, cores, tail = h["rep"]
        out.append(dict(axes=[np.asarray(a) for a in h["axes"]], bw=np.asarray(h["bw"]),
                        rep=("tt", perm, [np.asarray(g) for g in cores], np.asarray(tail))))
    windows = {key[0]: handle.per_half for key, (_, handle) in jb.regs.items()}
    return kind, out, windows


def _bundle(fit):
    """The port's bundle of a fast preset."""
    meta = fit.terms[0].meta
    return next(meta[k] for k in ("linear_chi2", "curve_values", "amp_pair") if k in meta).bundle


@pytest.fixture(scope="module", autouse=True)
def _small_grid_one_blas_thread():
    """The reduced split grid for the whole module, and one BLAS thread:
    the tensor-train builds are SVDs that gain little from threads and,
    beside other test processes, spin against each other."""
    with small_split_grid(), threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def built():
    """Per preset: the JAX and the port's w0wacdm fast builds (f64), 16
    walkers over both halves and the JAX breakdown there."""
    out = {}
    for name in PRESETS:
        with jax.enable_x64(True):
            jfit = jax_preset(name, "w0wacdm", fast=True)
            theta = _thetas(jfit.spec.bounds, list(jfit.spec.names), seed=0)
            jchi = {k: np.asarray(v) for k, v in
                    jax.jit(jax.vmap(jfit.chi2_breakdown()))(jnp.asarray(theta)).items()}
        tfit = get_preset(name, "w0wacdm", fast=True, device="cpu", dtype=F64)
        assert tfit.spec.names == jfit.spec.names
        out[name] = dict(jfit=jfit, tfit=tfit, theta=theta, jchi=jchi)
    return out


@pytest.mark.parametrize("name", PRESETS)
def test_the_multiprobe_family_keeps_the_3xtf32_sweep(built, name):
    """No group of these bundles comes near the f64 sweep's ratio
    (H_SWEEP_F64; the CC group's ~1e2 is the largest)."""
    tfit = built[name]["tfit"]
    packed = fl.pack(tfit)
    emulated = [(t, *fl._emulated(t)) for t in tfit.terms if fl._emulated(t) is not None]
    worst = max(fl.sweep_cancellation(emulated, h) for h in range(2))
    assert packed.hdr["H_SWEEP_F64"] == 0 and fl.instance(packed) == 1
    assert worst < fl.SWEEP_F64_RATIO / 5, worst


@pytest.mark.parametrize("name", PRESETS)
def test_w0wacdm_tt_bonds_within_one_of_jax(built, name):
    tkind, thalves = _bundle(built[name]["tfit"]).finalized()
    jkind, jhalves, _ = _jax_bundle_of(built[name]["jfit"])
    assert tkind == jkind == "split"
    for th, jh in zip(thalves, jhalves):
        assert th["rep"][0] == jh["rep"][0] == "tt"
        assert th["rep"][1] == tuple(jh["rep"][1])
        t_bonds = [g.shape[-1] for g in th["rep"][2]]
        j_bonds = [g.shape[-1] for g in jh["rep"][2]]
        assert all(abs(a - b) <= 1 for a, b in zip(t_bonds, j_bonds)), (t_bonds, j_bonds)
        for ax_t, ax_j in zip(th["axes"], jh["axes"]):
            assert len(ax_t) == SMALL_NODES
            np.testing.assert_allclose(ax_t, ax_j, rtol=1e-15, atol=0)


@pytest.mark.parametrize("name", PRESETS)
def test_w0wacdm_with_the_jax_bundle_carried_across(built, name):
    """Lift, amp-pair and linear windows alike on identical constants."""
    b = built[name]
    tfit = get_preset(name, "w0wacdm", fast=True, device="cpu", dtype=F64)
    bundle_from_numpy(_bundle(tfit), *_jax_bundle_of(b["jfit"]))
    got = tfit.chi2_breakdown()(torch.as_tensor(b["theta"]))
    assert set(got) == set(b["jchi"])
    for term, want in b["jchi"].items():
        np.testing.assert_allclose(got[term].numpy(), want, rtol=1e-9, atol=0, err_msg=term)


@pytest.mark.parametrize("name", PRESETS)
def test_w0wacdm_own_bundles_within_the_truncation_contract(built, name):
    b = built[name]
    got = b["tfit"].chi2_breakdown()(torch.as_tensor(b["theta"]))
    for term, want in b["jchi"].items():
        tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(want, 0.0))
        assert np.all(np.abs(got[term].numpy() - want) <= tol), term


@pytest.mark.parametrize("name", PRESETS)
def test_fused_plain_matches_the_terms_at_70_walkers(built, name):
    """Each walker its own half in the plain version, against the per-term
    path's select of both; bad walkers touch no other row."""
    tfit = built[name]["tfit"]
    names = list(tfit.spec.names)
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, names, seed=1, n=70))
    s = theta[:, names.index("w0")] + theta[:, names.index("wa")]
    assert int((s <= 0).sum()) == 35 and int((s > 0).sum()) == 35
    packed = fl.pack(tfit)
    assert packed.hdr["H_SPLIT"] == 1 and packed.hdr["H_PRIOR"] == 0
    for lay in packed.halves:
        assert [fl.KINDS[f["F_KIND"]] for f in lay["forms"]] == KINDS[name]
        assert 4 * lay["T_NQ"] <= fl.MAX_RALL and lay["T_R2"] <= fl.MAX_BOND
    assert fl.split_smem_bytes(packed.hdr) <= fl.MAX_SMEM
    before = fl.LAUNCHES
    fused = fl.fused_log_prob(packed, theta)
    assert fl.LAUNCHES == before  # CPU tensors never reach the kernel
    terms = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(theta)
    assert bool(torch.isfinite(fused).all())
    np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0)

    bad = torch.cat([theta, theta[:2].clone()])
    bad[70, names.index("Om")] = 0.95  # beyond every preset's Om bound
    bad[71, names.index("w0")] = float("nan")  # s = NaN: half 1, then -inf
    lp = fl.fused_log_prob_reference(packed, bad)
    assert bool(torch.all(lp[70:] == -torch.inf))
    np.testing.assert_allclose(lp[:70].numpy(), fused.numpy(), rtol=1e-12, atol=0)
    for h in (0, 1):
        ops, prod, nbytes = fl.work_per_walker(packed, h)
        assert nbytes == 4 * (len(names) + 1) and ops > 0 and prod > 0


def _fs8_curves(bundle):
    """The fs8 group's two registered curves (the AP one, the growth one)
    of a bundle."""
    ((curves, _),) = [v for key, v in bundle.regs.items() if key[0] == "fs8"]
    return curves


def test_growth_curve_on_the_rotated_axes_matches_jax(built):
    """Both fs8 curves of the w0wacdm multiprobe (the AP one and the growth
    ODE's) at 300 nodes of each half of the rotated grid (Om, wa, s = w0 +
    wa), without and with the radiation Or = OR_REF, against the JAX
    package's, 1e-10 relative; in half 0 over chunks of ~130 nodes, the
    rows of one piece to rounding."""
    b = built["joint.multiprobe"]
    tb, jb = _bundle(b["tfit"]), _jax_bundle(b["jfit"])
    t_curves, j_curves = _fs8_curves(tb), _fs8_curves(jb)
    _, halves = tlc._grid_spec("w0wacdm", None, tb.domains)
    _, jhalves = jlc._grid_spec("w0wacdm", None, jb.domains)
    rng = np.random.default_rng(5)
    for h, ((axes, to_params, _, _), (jaxes, jto_params, _, _)) in enumerate(zip(halves,
                                                                             jhalves)):
        for ax, jax_ax in zip(axes, jaxes):
            np.testing.assert_array_equal(ax, np.asarray(jax_ax))
        flat = tlc.flatten_grid(axes)
        flat = flat[rng.choice(len(flat), 300, replace=False)]
        for orr in (None, tlc.OR_REF):
            def tp(th, to_params=to_params, orr=orr):
                return to_params(th) if orr is None else dict(to_params(th), Or=orr)

            def jtp(th, to_params=jto_params, orr=orr):
                return to_params(th) if orr is None else dict(to_params(th), Or=orr)

            for cf, jcf in zip(t_curves, j_curves):
                got = cf(flat, tp)
                with jax.enable_x64(True):
                    want = np.asarray(jcf(flat, jtp))
                assert got.shape == want.shape == (300, 66)
                np.testing.assert_allclose(got, want, rtol=1e-10,
                                           atol=1e-10 * np.abs(want).max())
                if h or orr is not None:
                    continue
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(tfs8, "BUILD_TEMP_BYTES", 8 * 130 * 4224)
                    # torch's vector loops and their scalar tails round
                    # exp and log apart in the last bit
                    np.testing.assert_allclose(cf(flat, tp), got, rtol=1e-14, atol=0)


def _bench(fit, n, seed, half):
    """Walkers drawn as the bench draw about the box centre (half 0) or
    about w0 = -1, wa = 1.3 (half 1), those in the box and in that half
    kept, as chip_smoke.py draws them."""
    names = list(fit.spec.names)
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    mid = 0.5 * (lo + hi)
    if half:
        mid[names.index("w0")], mid[names.index("wa")] = -1.0, 1.3
    draw = mid + 0.05 * (hi - lo) * np.random.default_rng(seed).standard_normal((4 * n, len(lo)))
    s = draw[:, names.index("w0")] + draw[:, names.index("wa")]
    keep = ((s > 0) == bool(half)) & np.all((lo < draw) & (draw < hi), axis=1)
    return torch.as_tensor(draw[keep][:n])


def _form_logps(packed, theta):
    """logp of each emulated form alone, from the plain version (each
    walker its own half)."""
    out = []
    for i in range(len(packed.forms)):
        halves = tuple(dict(lay, forms=(lay["forms"][i],),
                            T_OFF_FORMS=lay["T_OFF_FORMS"] + i * fl.FORM_STRIDE)
                       for lay in packed.halves)
        alone = replace(packed, cmb={}, hdr=dict(packed.hdr, H_PRIOR=0), halves=halves)
        out.append(fl.fused_log_prob_reference(alone, theta).double())
    return out


def test_split_sweep_in_3xtf32_holds_the_lift_and_amp_pair(built, monkeypatch):
    """The split kernel's tensor-core sweep, emulated (as in
    tests/test_torch_w0wa.py) on the w0wacdm multiprobe at 64 bench-like
    walkers in each half: in 3xTF32 every term alone, the quasar lift and
    the fs8 amplitude pair among them, stays within 1e-4 of its own
    max|logp| of the f64 plain version; one TF32 pass exceeds that on the
    lift and on the amplitude pair."""
    tfit = built["joint.multiprobe"]["tfit"]
    packed = fl.pack(tfit)
    kinds = [fl.KINDS[f["F_KIND"]] for f in packed.forms]
    p32 = replace(packed, buf=packed.buf.float(), dev=packed.dev.float())
    errs = {}
    for half in (0, 1):
        theta = _bench(tfit, 64, seed=11 + half, half=half)
        assert theta.shape[0] == 64
        want = _form_logps(packed, theta)
        for passes in (3, 1):
            monkeypatch.setattr(fl, "_tt_coeff", lambda p, h, c, passes=passes: _sweep(
                p, h, c, lambda a, g: _tf32_product(a, g, passes)))
            got = _form_logps(p32, theta.float())
            monkeypatch.undo()
            errs[half, passes] = [float((g - w).abs().max() / w.abs().max())
                                  for g, w in zip(got, want)]
    print("each term alone vs f64 (" + ", ".join(kinds) + "): " + "; ".join(
        f"half {h} {'3xTF32' if p == 3 else 'one TF32 pass'} "
        + ", ".join(f"{e:.2e}" for e in v) for (h, p), v in errs.items()))
    assert max(max(errs[h, 3]) for h in (0, 1)) <= 1e-4, errs
    for kind in ("lift", "amp_pair"):
        i = kinds.index(kind)
        assert max(errs[h, 1][i] for h in (0, 1)) > 1e-4, (kind, errs)


def _cc_thetas(fit, n=16):
    """Half the walkers about the box centre, half uniform over it."""
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    rng = np.random.default_rng(3)
    near = 0.5 * (lo + hi) + 0.05 * (hi - lo) * rng.standard_normal((n // 2, len(lo)))
    return np.concatenate([near, lo + (hi - lo) * rng.uniform(0.02, 0.98, (n - n // 2, len(lo)))])


@pytest.mark.parametrize("model", ["lcdm", "wcdm", "wzcdm", "w0wacdm"])
def test_cc_cc_fast_in_each_model(model, monkeypatch):
    """cc.cc on the fast path, on each package's own grid (w0wacdm's split
    grid at its 40 nodes an axis: the CC build takes seconds): the Om h^2
    prior in the packed header, the fused plain version against the sum of
    the terms (1e-10); the prior alone against the port's parity term and
    the JAX package's (1e-12); the fast CC term within the truncation
    contract of the port's parity term near the box centre and of the JAX
    package's fast term over the box."""
    from cosmax_torch.likelihoods.priors import OMH2_PLANCK

    for mod, grid in FULL_GRID.items():
        monkeypatch.setattr(mod, "_grid_spec", grid)
        monkeypatch.setattr(mod, "_FINALIZE_MEMO", {})

    tfit = get_preset("cc.cc", model, fast=True, device="cpu", dtype=F64)
    par = get_preset("cc.cc", model, device="cpu", dtype=F64)
    packed = fl.pack(tfit)
    buf, h = packed.buf, packed.hdr
    assert h["H_PRIOR"] == 1 and h["H_SPLIT"] == (model == "w0wacdm")
    assert (float(buf[fl.HEADER["H_PRIOR_MEAN"]]), float(buf[fl.HEADER["H_PRIOR_SIGMA"]])) \
        == OMH2_PLANCK
    theta = _cc_thetas(tfit)
    th = torch.as_tensor(theta)
    fused = fl.fused_log_prob(packed, th)
    np.testing.assert_allclose(fused.numpy(), make_log_prob(tfit.spec, tfit.terms,
                                                            tfit.derive)(th).numpy(),
                               rtol=1e-10, atol=0)
    halves = tuple(dict(lay, forms=()) for lay in packed.halves)
    prior = -2.0 * fl.fused_log_prob_reference(replace(packed, forms=(), halves=halves), th)
    with jax.enable_x64(True):
        jchi = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(jax_preset(
            "cc.cc", model, fast=True).chi2_breakdown()))(jnp.asarray(theta)).items()}
        jpar = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(jax_preset(
            "cc.cc", model).chi2_breakdown()))(jnp.asarray(theta)).items()}
    got, want_par = tfit.chi2_breakdown()(th), par.chi2_breakdown()(th)
    assert set(got) == set(jchi) == set(jpar) == {"cc", "omh2"}
    np.testing.assert_allclose(prior.numpy(), want_par["omh2"].numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(prior.numpy(), jpar["omh2"], rtol=1e-12, atol=0)
    # the parity term near the box centre (the first 8 walkers), where the
    # contract is stated; the JAX package's fast term everywhere
    for want, rows in ((want_par["cc"].numpy(), slice(0, 8)), (jchi["cc"], slice(None))):
        tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(want[rows], 0.0))
        assert np.all(np.abs(got["cc"].numpy()[rows] - want[rows]) <= tol)
