"""The port's fast path (emulated BAO and SN, bundles, ``fast=True``, the
fused log-prob's packer and plain version, ``--fast``) against the JAX
package and against the port's own parity path.

* the flagship per-term chi^2 of each package's own bundle within the
  truncation contract 1e-3 + 2e-4 sqrt(chi^2), and with the JAX bundle
  carried across (``interop.bundle_from_numpy``) within 1e-9 relative;
* the port in f32 against JAX in f64 within 1e-4 of max|logp|;
* ``fused_log_prob_reference`` against ``make_log_prob`` over the fast
  terms, 1e-10 relative in f64, with -inf rows kept to themselves;
* ports of the reference's emulator tests (tests/test_linear_chi2.py);
* ``--fast --device cpu`` through the CLI.

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it against
the plain version there); here the wrapper takes the plain version
because the tensors lie on the CPU. One JAX fast build per configuration
(module fixtures); every JAX evaluation takes N_THETA points."""

import inspect
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
from cosmax.data import load_sn as jax_load_sn
from cosmax.likelihoods.sn import build_sn_term as jax_build_sn_term
from cosmax_torch.configs import get_preset
from cosmax_torch.data import load_bao, load_sn
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods import bao as tbao
from cosmax_torch.likelihoods import sn as tsn
from cosmax_torch.likelihoods.base import Term, make_log_prob
from cosmax_torch.models.emu_core import OR_REF, bary_vector
from cosmax_torch.models.linear_chi2 import bundle_scope
from cosmax_torch.ops.kernels import fused_log_prob as fl

F64 = torch.float64
N_THETA = 8
FLAGSHIP = ("bao.desi_cmb_des5y", "wzcdm")


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """The w0wacdm tensor-train builds are SVDs that gain little from
    BLAS threads; beside other test processes (pytest-xdist), threaded
    SVDs spin against each other and take ten times longer."""
    with threadpool_limits(1):
        yield


def _thetas(bounds, seed, n=N_THETA, spread=0.05):
    rng = np.random.default_rng(seed)
    lo, hi = bounds[:, 0], bounds[:, 1]
    return 0.5 * (lo + hi) + spread * (hi - lo) * rng.standard_normal((n, len(lo)))


def _points(seed, n, extra, model="wzcdm"):
    """Walker parameter dicts of [n] f64 tensors (the reference test's
    draw), with Or from H0 when H0 is drawn."""
    rng = np.random.default_rng(seed)
    p = {"Om": rng.uniform(0.2, 0.45, n)}
    if model != "lcdm":
        p["w0"] = rng.uniform(-1.5, -0.5, n)
    for k, (lo, hi) in extra.items():
        p[k] = rng.uniform(lo, hi, n)
    if "H0" in p:
        p["Or"] = 4.15e-5 / (p["H0"] / 100.0) ** 2
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _jax_bundle(jfit):
    """The JAX fast preset's finalized bundle as numpy: the arguments of
    ``bundle_from_numpy``."""
    jb = inspect.getclosurevars(jfit.terms[0].chi2).nonlocals["bundle"]
    kind, halves = jb.finalized()
    halves = [
        dict(axes=[np.asarray(a) for a in h["axes"]], bw=np.asarray(h["bw"]),
             rep=(h["rep"][0], [np.asarray(u) for u in h["rep"][1]], np.asarray(h["rep"][2])))
        for h in halves
    ]
    windows = {key[0]: handle.per_half for key, (_, handle) in jb.regs.items()}
    return kind, halves, windows


@pytest.fixture(scope="module")
def flagship():
    with jax.enable_x64(True):
        jfit = jax_preset(*FLAGSHIP, fast=True)
        theta = _thetas(jfit.spec.bounds, seed=0)
        th = jnp.asarray(theta)
        jchi = {k: np.asarray(v) for k, v in jax.vmap(jfit.chi2_breakdown())(th).items()}
        jlp = np.asarray(jax.vmap(jfit.log_prob())(th))
    tfit = get_preset(*FLAGSHIP, fast=True, device="cpu", dtype=F64)
    return dict(jfit=jfit, tfit=tfit, theta=theta, jchi=jchi, jlp=jlp)


def test_flagship_own_bundles_within_the_truncation_contract(flagship):
    got = flagship["tfit"].chi2_breakdown()(torch.as_tensor(flagship["theta"]))
    assert set(got) == set(flagship["jchi"]) == {"bao", "cmb_desi", "sn"}
    for name, want in flagship["jchi"].items():
        # each package picks its own SVD ranks; both hold the absolute
        # contract, whose chi^2 image scales as 2 sqrt(chi^2) |dy|
        tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(want, 0.0))
        assert np.all(np.abs(got[name].numpy() - want) <= tol), name


def test_flagship_f32_against_jax_f64(flagship):
    fit32 = get_preset(*FLAGSHIP, fast=True, device="cpu")
    lp = fit32.log_prob()(torch.as_tensor(flagship["theta"], dtype=torch.float32))
    assert lp.dtype == torch.float32
    want = flagship["jlp"]
    err = np.max(np.abs(lp.double().numpy() - want)) / np.max(np.abs(want))
    assert err < 1e-4, err


def test_flagship_with_the_jax_bundle_carried_across(flagship):
    """Both packages on identical emulator constants: the same function
    to f64 rounding, whatever rank each SVD picks."""
    tfit = get_preset(*FLAGSHIP, fast=True, device="cpu", dtype=F64)
    bundle_from_numpy(tfit.terms[0].meta["linear_chi2"].bundle, *_jax_bundle(flagship["jfit"]))
    theta = torch.as_tensor(flagship["theta"])
    got = tfit.chi2_breakdown()(theta)
    for name, want in flagship["jchi"].items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-9, atol=0, err_msg=name)
    np.testing.assert_allclose(tfit.log_prob()(theta).numpy(), flagship["jlp"], rtol=1e-9, atol=0)


def test_fused_plain_matches_make_log_prob_at_70_walkers(flagship):
    """Port of test_megakernel_blocked_log_prob_matches_vmap: the fused
    log-prob (here its plain version) against the sum of the fast terms,
    70 walkers, 1e-10 relative in f64; bad walkers touch no other row."""
    tfit = flagship["tfit"]
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, seed=1, n=70))
    packed = fl.pack(tfit)
    before = fl.LAUNCHES
    fused = fl.fused_log_prob(packed, theta)
    assert fl.LAUNCHES == before  # CPU tensors never reach the kernel
    terms = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(theta)
    assert fused.shape == (70,) and bool(torch.isfinite(fused).all())
    np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0)

    bad = torch.cat([theta, theta[:4].clone()])
    bad[70, 2] = 0.95  # Om beyond its bound (0.1, 0.6)
    bad[71, 0] = float("nan")
    bad[72, 2], bad[72, 4] = -3.0, -1.9  # Om < 0: NaN inside the bounds mask
    bad[73, 2] = tfit.spec.bounds[2, 0]  # on the edge: outside the strict interior
    lp = fl.fused_log_prob_reference(packed, bad)
    assert bool(torch.all(lp[70:] == -torch.inf))
    np.testing.assert_allclose(lp[:70].numpy(), fused.numpy(), rtol=1e-12, atol=0)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: the bit pattern of cvt.rna.tf32.f32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tucker_tf32(packed, theta, passes):
    """The native grid's coefficient vector [W, 4 nq] as the kernel's
    block products compute it, emulated in float32 on the f32 buffer: for
    each outer index j, D_j = w2 B_j with the inner factor w2 [W, KI] and
    the core matrix's rows B_j = [j KI, (j + 1) KI), each operand split into
    TF32 hi + lo, the products a_lo b_hi + a_hi b_lo + a_hi b_hi
    (``passes`` 3) or a_hi b_hi alone (1) summed from zero; then a = sum_j
    w1[j] D_j in f32."""
    h, buf = packed.hdr, packed.buf
    ko, ki, ldb, nq = (int(h[k]) for k in ("H_KO", "H_KI", "H_LDB", "H_NQ"))
    coords = [theta[:, h["H_I_OM"]]] + ([theta[:, h["H_I_W0"]]] if h["H_NAXES"] > 1 else [])
    wps = []
    for i, x in enumerate(coords, 1):
        n = h[f"H_N{i}"]
        w = bary_vector(x, fl._seg(buf, h[f"H_OFF_AX{i}"], n), fl._seg(buf, h[f"H_OFF_BW{i}"], n))
        wps.append(w @ fl._factor(packed, i))
    if len(wps) == 1:
        outer, inner = torch.ones_like(wps[0][:, :1]), wps[0]
    else:
        outer, inner = wps[::-1] if h["H_INNER"] == 1 else wps
    a = torch.nn.functional.pad(inner, (0, ki - inner.shape[1]))
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    b = fl._seg(buf, h["H_OFF_CORE"], ko * ki * ldb, (ko * ki, ldb))[:, :4 * nq]
    out = torch.zeros(len(theta), 4 * nq)
    for j in range(ko):
        bj = b[j * ki:(j + 1) * ki]
        b_hi = _tf32(bj)
        d = a_hi @ b_hi
        if passes == 3:
            d = a_lo @ b_hi + a_hi @ _tf32(bj - b_hi) + d
        out = out + outer[:, j:j + 1] * d
    return out


def tucker_term_errors(packed, theta, passes):
    """Per emulated term, logp of that term alone in f32 with the
    contraction of ``_tucker_tf32`` against the f64 plain version, as a
    fraction of the term's own max|logp| (the whole sum's scale would hide
    a small term); ``packed`` and ``theta`` are f64."""
    p32 = replace(packed, buf=packed.buf.float())
    th32 = theta.float()
    logps = []
    for pk, th, a in ((packed, theta, None), (p32, th32, _tucker_tf32(p32, th32, passes))):
        h, buf = pk.hdr, pk.buf
        zero = torch.zeros_like(th[:, 0])
        h0 = th[:, h["H_I_H0"]] * buf[fl.HEADER["H_H0_SCALE"]] if h["H_I_H0"] >= 0 else zero
        o_r = buf[fl.HEADER["H_ORH2"]] / (h0 / 100.0) ** 2 if h["H_ORH2"] != 0 else zero
        w0 = th[:, h["H_I_W0"]] if h["H_NAXES"] > 1 else None
        if a is None:
            a = fl._tucker_coeff(pk, th[:, h["H_I_OM"]], w0)
        # the walker's r_d, as the kernel computes it before the forms
        rd = fl._walker_rd(pk, lambda j: th[:, int(j)], h0, th[:, h["H_I_OM"]], o_r, w0, None,
                           fl.MODELS[int(h["H_MODEL"])]) + zero
        logps.append([])
        for i, f in enumerate(pk.forms):
            chi2, log_norm = fl._forms_chi2(pk, [f], h["H_OFF_FORMS"] + i * fl.FORM_STRIDE, a,
                                            th, h0, (o_r / OR_REF)[:, None], rd)
            logps[-1].append((-0.5 * chi2 + log_norm).double())
    return [float((got - want).abs().max() / want.abs().max())
            for want, got in zip(*logps)]


def test_tucker_contraction_in_3xtf32_holds_each_term(flagship):
    """The kernel's tensor-core contraction, emulated: in 3xTF32 each
    flagship term alone (BAO, SN) stays within 1e-4 of its own max|logp|
    of the f64 plain version on 70 bench-like walkers; one TF32 pass
    fails that check."""
    tfit = flagship["tfit"]
    packed = fl.pack(tfit)
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, seed=1, n=70))
    three, one = (tucker_term_errors(packed, theta, p) for p in (3, 1))
    print(f"each term alone vs f64: 3xTF32 {three}, one TF32 pass {one}")
    assert len(three) == 2 and max(three) <= 1e-4 < max(one), (three, one)


@pytest.mark.parametrize("name", ["bao.desi", "bao.desi_cmb_des5y", "bao.desi_cmb_union3",
                                  "bao.desi_cmb_pantheon"])
def test_ported_presets_build_fast_for_each_model(name):
    for model in ("lcdm", "wcdm", "wzcdm", "w0wacdm"):
        fit = get_preset(name, model, fast=True, device="cpu", dtype=F64)
        assert fit.fast
        theta = _thetas(fit.spec.bounds, seed=2)
        if model == "w0wacdm":  # two walkers on the split grid's half 1
            i_w0, i_wa = fit.spec.names.index("w0"), fit.spec.names.index("wa")
            theta[:2, i_w0], theta[:2, i_wa] = -0.3, 0.9
        theta = torch.as_tensor(theta)
        fused = fit.log_prob()(theta)
        terms = make_log_prob(fit.spec, fit.terms, fit.derive)(theta)
        assert bool(torch.isfinite(fused).all()), (name, model)
        np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0,
                                   err_msg=f"{name}/{model}")


@pytest.mark.parametrize("rd_case", ["fixed", "param"])
def test_bao_emulated_all_rd_treatments(rd_case):
    """beta = (c/H0)/r_d covers the r_d treatments unchanged: the
    emulated BAO against the port's GL grid, chi^2 and its gradient."""
    ds = load_bao("desi_dr2")
    rd_fn, extra = {
        "fixed": (tbao.rd_fixed(147.09), {}),
        "param": (tbao.rd_param("rd"), {"rd": (138.0, 155.0)}),
    }[rd_case]
    gl = tbao.build_bao_term(ds, "wzcdm", rd_fn, "cpu", F64, grid=("gl", 64))
    emu = tbao.build_bao_term(ds, "wzcdm", rd_fn, "cpu", F64, grid=("emu",))
    p = _points(4, 10, dict(extra, H0=(62.0, 73.0)))
    np.testing.assert_allclose(emu.chi2(p).numpy(), gl.chi2(p).numpy(), rtol=0, atol=2e-2)
    for k in ("Om", "H0"):
        grads = []
        for term in (gl, emu):
            q = {n: v.clone().requires_grad_(n == k) for n, v in p.items()}
            (g,) = torch.autograd.grad(term.chi2(q).sum(), q[k])
            grads.append(g.numpy())
        np.testing.assert_allclose(grads[1], grads[0], rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(grads[0]).max()))


def test_sn_emulated_sampled_h0_radiation():
    """The flagship convention: a sampled H0 acts as a uniform -5 log10 h
    shift (an analytic gamma column), radiation via the secant delta;
    the port's emulated SN against the JAX package's compressed SN,
    which evaluates both exactly."""
    ds = load_sn("des5y")
    emu = tsn.build_sn_term(ds, "wzcdm", "dM", "H0", device="cpu", dtype=F64, method="emulated")
    p = _points(1, N_THETA, {"dM": (-0.5, 0.5), "H0": (62.0, 74.0)})
    with jax.enable_x64(True):
        comp = jax_build_sn_term(jax_load_sn("des5y"), "wzcdm", mag_param="dM", h0="H0",
                                 method="compressed")
        want = np.asarray(jax.vmap(comp.chi2)({k: jnp.asarray(v.numpy()) for k, v in p.items()}))
    # chi^2 ~ 1650 here; 1e-2 is ~6e-6 relative (Or-secant dominated)
    np.testing.assert_allclose(emu.chi2(p).numpy(), want, rtol=0, atol=1e-2)


def test_sn_emulated_cepheids():
    """SH0ES variant: the calibrator rows are constants plus M; the H0
    shift must not touch them. The port's emulated and dense SN on the
    port's Pantheon+ & SH0ES table against the JAX package's compressed
    and dense SN on the JAX loader's."""
    from cosmax.likelihoods.sn import build_sn_term as jsn

    jds = jax_load_sn("pantheon_plus_shoes")
    ds = load_sn("pantheon_plus_shoes")
    kw = dict(mag_param="M", h0="H0", cepheids=True)
    emu = tsn.build_sn_term(ds, "wzcdm", **kw, device="cpu", dtype=F64, method="emulated")
    dense = tsn.build_sn_term(ds, "wzcdm", **kw, device="cpu", dtype=F64)
    p = _points(2, N_THETA, {"M": (-19.45, -19.15), "H0": (66.0, 76.0)})
    with jax.enable_x64(True):
        pj = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
        want_comp = np.asarray(jax.vmap(jsn(jds, "wzcdm", **kw, method="compressed").chi2)(pj))
        want_dense = np.asarray(jax.vmap(jsn(jds, "wzcdm", **kw).chi2)(pj))
    np.testing.assert_allclose(emu.chi2(p).numpy(), want_comp, rtol=0, atol=1e-2)
    np.testing.assert_allclose(dense.chi2(p).numpy(), want_dense, rtol=1e-9, atol=0)


def test_bundle_matches_solo_builds():
    """Co-compressed terms give the chi^2 of standalone builds: bundling
    changes the factorisation, not the function."""
    bao_ds, sn_ds = load_bao("desi_dr2"), load_sn("union3")

    def build():
        return (
            tbao.build_bao_term(bao_ds, "wzcdm", tbao.rd_param("rd"), "cpu", F64, grid=("emu",)),
            tsn.build_sn_term(sn_ds, "wzcdm", "dM", 70.0, device="cpu", dtype=F64,
                              use_z_hel=False, method="emulated"),
        )

    solo = build()
    with bundle_scope():
        bundled = build()
    assert bundled[0].chi2.bundle is bundled[1].chi2.bundle
    assert solo[0].chi2.bundle is not solo[1].chi2.bundle
    p = _points(6, 6, {"H0": (62.0, 73.0), "rd": (140.0, 152.0), "dM": (-0.4, 0.4)})
    for s, b in zip(solo, bundled):
        want = s.chi2(p).numpy()
        tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(want, 0.0))
        assert np.all(np.abs(b.chi2(p).numpy() - want) <= tol)


def test_bundle_refinalize_after_late_registration():
    """A term evaluated before a sibling registers must still be right
    after the bundle refinalizes: the handles are re-windowed and the
    cached quadratic forms rebuilt."""
    bao_ds, sn_ds = load_bao("desi_dr2"), load_sn("union3")
    ref = tbao.build_bao_term(bao_ds, "wcdm", tbao.rd_fixed(147.09), "cpu", F64, grid=("gl", 64))
    p = {k: torch.tensor([v], dtype=F64) for k, v in
         dict(Om=0.31, w0=-0.95, H0=68.0, dM=-0.05).items()}
    with bundle_scope():
        b_bao = tbao.build_bao_term(bao_ds, "wcdm", tbao.rd_fixed(147.09), "cpu", F64,
                                    grid=("emu",))
        first = float(b_bao.chi2(p)[0])  # finalizes a one-term bundle
        gen = b_bao.chi2.handle.gen
        b_sn = tsn.build_sn_term(sn_ds, "wcdm", "dM", 70.0, device="cpu", dtype=F64,
                                 use_z_hel=False, method="emulated")
        float(b_sn.chi2(p)[0])  # refinalizes with two terms
        second = float(b_bao.chi2(p)[0])  # must use the new windows
    assert b_bao.chi2.handle.gen > gen
    want = float(ref.chi2(p)[0])
    assert first == pytest.approx(want, abs=1e-3)
    assert second == pytest.approx(want, abs=1e-3)


def test_preset_domains_cover_prior_box():
    """fast=True narrows the grid to the preset's own prior box: chi^2
    still tracks the parity path at the box corners (the 3% pad keeps
    them interior) and stays finite just outside."""
    fast = get_preset(*FLAGSHIP, fast=True, device="cpu", dtype=F64)
    par = get_preset(*FLAGSHIP, device="cpu", dtype=F64)
    lo, hi = par.spec.bounds[:, 0], par.spec.bounds[:, 1]
    corners = torch.as_tensor(np.stack([lo, hi]))
    fb = sum(fast.chi2_breakdown()(corners).values()).numpy()
    pb = sum(par.chi2_breakdown()(corners).values()).numpy()
    # the corners sit far up the chi^2 surface; the contract scales with it
    assert np.all(np.abs(fb - pb) <= 2e-4 * np.maximum(pb, 1.0) + 5e-2), (fb, pb)
    outside = torch.as_tensor(hi + 0.005 * (hi - lo))[None]
    assert all(bool(torch.isfinite(v).all()) for v in fast.chi2_breakdown()(outside).values())


def test_packer_refuses_what_the_kernel_does_not_take(flagship, monkeypatch):
    tfit = flagship["tfit"]
    with pytest.raises(ValueError, match="fast=True"):
        fl.pack(replace(tfit, fast=False))
    other = Term("omh2", chi2=lambda p: p["H0"] * 0.0)
    with pytest.raises(NotImplementedError, match="item 10"):
        fl.pack(replace(tfit, terms=tfit.terms + (other,)))
    monkeypatch.setattr(fl, "MAX_RANK", 4)
    with pytest.raises(NotImplementedError, match="#1a and #1c"):
        fl.pack(tfit)


def test_wrapper_checks_and_work_count(flagship):
    packed = fl.pack(flagship["tfit"])
    with pytest.raises(ValueError, match=r"\[W, 6\]"):
        fl.fused_log_prob(packed, torch.zeros(3, 5, dtype=F64))
    with pytest.raises(ValueError, match="constants on"):
        fl.fused_log_prob(packed, torch.zeros(3, 6, device="meta"))
    ops, product, nbytes = fl.work_per_walker(packed)
    h = packed.hdr
    # the flagship: ~4k f32 operations (projections, forms, CMB) beside the
    # core contraction on the tensor cores, 2 r1 r2 R_all; theta + logp
    assert nbytes == 28 and 2000 < ops < 10000
    assert product == 2 * h["H_R1"] * h["H_R2"] * h["H_RALL"] == 4864


def test_kernel_source_agrees_with_the_packer(flagship):
    """The .cu file's compile-time maxima and buffer slots equal the
    packer's (nvcc runs only on the card; this holds the two files
    together here)."""
    src = (Path(fl.__file__).resolve().parents[2] / "csrc" / "fused_log_prob.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    want = dict(HEADER=fl.HEADER, PAIR=fl.PAIR, FORM=fl.FORM, CMB=fl.CMB, HALF=fl.HALF)
    for table in want.values():
        for k, v in table.items():
            assert consts[k] == v, k
    for k in ("MAX_DIM", "MAX_NODES", "MAX_RANK", "MAX_RANK_OUTER", "MAX_BOND", "MAX_RALL",
              "MAX_FORMS", "MAX_K", "MAX_LIFT", "MAX_GL", "MAX_FLOATS", "PAIR_STRIDE", "FORM_STRIDE", "HALF_STRIDE",
              "THREADS", "VLD", "VLD_F64", "KSLICE", "NCOL", "SLD", "STAGES", "MIN_RIN", "WPAD",
              "WLD", "CLD", "NCOLT", "TUCKER_WARPS"):
        assert consts[k] == getattr(fl, k), k
    # the native grid's core matrix [KO KI][LDB]: its rows the outer index
    # times the inner rank padded to k-steps of 8, its row stride 8 or 24
    # mod 32 (the B fragments on 32 banks) and wide enough for the n-tiles
    # of every window; the kernel's per-warp scratch as the packer counts it
    h = fl.pack(flagship["tfit"]).hdr
    assert h["H_KI"] % 8 == 0 and h["H_KO"] * h["H_KI"] >= h["H_R1"] * h["H_R2"]
    assert h["H_LDB"] % 32 in (8, 24) and h["H_LDB"] >= 4 * h["H_NQ"]
    assert "TUCKER_WARPS * (static_cast<size_t>(stride) * WLD + NCOLT * CLD)" in src
    assert fl.tucker_smem_bytes(dict(H_SIZE=fl.MAX_FLOATS, H_KO=fl.MAX_RANK,
                                     H_KI=fl.MAX_RANK)) <= fl.MAX_SMEM
    # the split grid's header slots and its per-half block, whose per-core
    # slots the kernel indexes from T_PERM0, T_AX0, T_N0, T_G0 and T_R1
    assert {"H_I_WA", "H_SPLIT", "H_OFF_HALVES", "H_VROWS"} <= set(fl.HEADER)
    # the block's half counts: int s_count[2][WARPS], WARPS = THREADS / 32
    assert "__shared__ int s_count[2][WARPS];" in src and "WARPS = THREADS / 32;" in src
    assert fl.GROUP_BYTES == 2 * (fl.THREADS // 32) * 4
    # the largest split fit the kernel takes still fits a block: 64 nodes,
    # every bond MAX_BOND, and a constant buffer of the flagship's size
    worst = dict(H_N1=fl.MAX_NODES, H_VROWS=2 * fl.MAX_BOND, H_SIZE=1000)
    assert fl.split_smem_bytes(worst) <= fl.MAX_SMEM
    # the f64 sweep (H_SWEEP_F64, the launch's instance 2): its rows are
    # VLD_F64 doubles, a row's floats as the kernel counts them
    assert "instance == 2 ? 2 * VLD_F64 : VLD" in src
    f64 = dict(worst, H_SWEEP_F64=1)
    assert fl.split_smem_bytes(f64) - fl.split_smem_bytes(worst) == \
        4 * (fl.MAX_NODES + fl.WPAD + 2 * fl.MAX_BOND) * (2 * fl.VLD_F64 - fl.VLD)
    packed = fl.pack(flagship["tfit"])
    assert packed.hdr["H_SWEEP_F64"] == 0 and fl.instance(packed) == 0
    assert max(fl.HEADER.values()) < fl.HEADER_SIZE
    for k, v in fl.HALF.items():
        assert consts[k] == v, k
    for i in range(3):
        for first in ("T_PERM", "T_AX", "T_N", "T_G"):
            assert fl.HALF[f"{first}{i}"] == fl.HALF[f"{first}0"] + i
        assert fl.HALF[f"T_R{i + 1}"] == fl.HALF["T_R1"] + i
    assert max(fl.HALF.values()) < fl.HALF_STRIDE


def test_cli_fast_on_the_cpu(tmp_path, capsys):
    from cosmax_torch import fit as fit_cli

    out = tmp_path / "run"
    rc = fit_cli.main(["--preset", FLAGSHIP[0], "--model", FLAGSHIP[1], "--fast",
                       "--device", "cpu", "--walkers", "8", "--steps", "3", "--seed", "0",
                       "--no-plots", "--out", str(out)])
    assert rc == 0
    assert "fast path" in capsys.readouterr().out
    chain = np.load(out / "chain.npy")
    assert chain.shape[1:] == (8, 6) and np.all(np.isfinite(chain))
