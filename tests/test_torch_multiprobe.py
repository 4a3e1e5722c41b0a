"""The multiprobe joint (``joint.multiprobe``: BAO + CMB + SN + CC +
quasars + fsigma8) of the port against the JAX package, and the fused
log-prob's packer and plain version on the terms it adds.

* the parity joint per term against JAX to 1e-9 relative in f64;
* the fast joint per term with each package's own bundle within the
  truncation contract 1e-3 + 2e-4 sqrt(chi^2), and with the JAX bundle
  carried across (``make_curve_values``, ``make_amp_pair_chi2`` and the
  CC form on identical constants) to 1e-9 relative;
* the port in f32 against JAX in f64 within 1e-4 of max|logp|;
* the port's fast path against its own parity path at mid-box, at the
  tolerances of tests/test_likelihood_parity.py;
* ``fused_log_prob_reference`` against the sum of the fast terms at 70
  walkers, 1e-10 relative in f64, with -inf rows kept to themselves;
* the packer on all 12 new fast configurations, and its refusals;
* ``--fast`` through the CLI.

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it against
the plain version there). One JAX build per path (module fixtures), and
every JAX evaluation takes N_THETA walkers."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.configs import get_preset as jax_preset
from cosmax_torch.configs import get_preset
from cosmax_torch.data import load_quasars
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods.base import make_log_prob
from cosmax_torch.ops.kernels import fused_log_prob as fl
from tests.test_torch_fast import tucker_term_errors

F64 = torch.float64
N_THETA = 4
MODEL = "wzcdm"
NEW_FAST = ("joint.multiprobe", "fs8.fs8", "cc.cc_union3", "cc.cc_des5y")
TERMS = {"bao", "cmb_desi", "sn", "cc", "quasars", "fs8"}


def _thetas(bounds, seed, n=N_THETA, spread=0.05):
    rng = np.random.default_rng(seed)
    lo, hi = bounds[:, 0], bounds[:, 1]
    return 0.5 * (lo + hi) + spread * (hi - lo) * rng.standard_normal((n, len(lo)))


def _jax_eval(jfit, theta):
    """The JAX package's breakdown and log-prob, each jitted: one XLA
    compile, where un-jitted JAX would compile every primitive."""
    with jax.enable_x64(True):
        th = jnp.asarray(theta)
        chi = jax.jit(jax.vmap(jfit.chi2_breakdown()))(th)
        return ({k: np.asarray(v) for k, v in chi.items()},
                np.asarray(jax.jit(jax.vmap(jfit.log_prob()))(th)))


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


@functools.lru_cache(maxsize=None)
def _fast_fit(name, model):
    """The port's fast build in f64, once per configuration in this file
    (the cold table builds of the fs8 growth curves take seconds)."""
    return get_preset(name, model, fast=True, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def fast():
    with jax.enable_x64(True):
        jfit = jax_preset("joint.multiprobe", MODEL, fast=True)
    tfit = _fast_fit("joint.multiprobe", MODEL)
    theta = _thetas(tfit.spec.bounds, seed=0)
    jchi, jlp = _jax_eval(jfit, theta)
    return dict(jfit=jfit, tfit=tfit, theta=theta, jchi=jchi, jlp=jlp)


def test_parity_joint_per_term_matches_jax(fast):
    with jax.enable_x64(True):
        jfit = jax_preset("joint.multiprobe", MODEL)
    tfit = get_preset("joint.multiprobe", MODEL, device="cpu", dtype=F64)
    assert tfit.spec.names == jfit.spec.names
    np.testing.assert_array_equal(tfit.spec.bounds, jfit.spec.bounds)
    assert tfit.data_size == jfit.data_size
    theta = fast["theta"]
    # JAX's log_prob would run the growth ODE (and compile its scan) a
    # second time: its value is composed from the breakdown instead
    with jax.enable_x64(True):
        th = jnp.asarray(theta)
        jchi = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(jfit.chi2_breakdown()))(th).items()}
        p = jax.vmap(lambda x: jfit.derive(jfit.spec.unpack(x)))(th)
        jlp = sum(-0.5 * jchi[t.name] for t in jfit.terms) + sum(
            np.asarray(jax.vmap(t.log_norm)(p)) for t in jfit.terms if t.log_norm is not None
        )
    got = tfit.chi2_breakdown()(torch.as_tensor(theta))
    assert set(got) == set(jchi) == TERMS
    for name, want in jchi.items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-9, atol=0, err_msg=name)
    lp = tfit.log_prob()(torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(lp, jlp, rtol=1e-9, atol=0)


def test_fast_joint_own_bundles_within_the_truncation_contract(fast):
    got = fast["tfit"].chi2_breakdown()(torch.as_tensor(fast["theta"]))
    assert set(got) == set(fast["jchi"]) == TERMS
    for name, want in fast["jchi"].items():
        tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(want, 0.0))
        assert np.all(np.abs(got[name].numpy() - want) <= tol), name


def test_fast_joint_with_the_jax_bundle_carried_across(fast):
    """Identical emulator constants: the CC form, the quasar curve values
    and the fs8 amplitude pair give the JAX package's numbers to f64
    rounding."""
    tfit = get_preset("joint.multiprobe", MODEL, fast=True, device="cpu", dtype=F64)
    bundle_from_numpy(tfit.terms[0].meta["linear_chi2"].bundle, *_jax_bundle(fast["jfit"]))
    theta = torch.as_tensor(fast["theta"])
    got = tfit.chi2_breakdown()(theta)
    for name, want in fast["jchi"].items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-9, atol=0, err_msg=name)
    np.testing.assert_allclose(tfit.log_prob()(theta).numpy(), fast["jlp"], rtol=1e-9, atol=0)

    # the curve values themselves: mu_model = mu_ref + dmu(theta)
    qsr = next(t for t in tfit.terms if t.name == "quasars")
    jqsr = next(t for t in fast["jfit"].terms if t.name == "quasars")
    p = tfit.derive(tfit.spec.unpack(theta))
    d_ref = qsr.meta["constants"]["d_ref"].numpy()  # mu - mu_ref
    got_mu = qsr.meta["curve_values"](p).numpy() - d_ref
    with jax.enable_x64(True):
        pj = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
        mu_data = np.asarray(jax.vmap(jqsr.meta["mu_model"])(pj))
    _, _, qmu, _ = load_quasars(22)
    np.testing.assert_allclose(got_mu + qmu, mu_data, rtol=1e-9, atol=0)


def test_fast_f32_against_jax_f64(fast):
    fit32 = get_preset("joint.multiprobe", MODEL, fast=True, device="cpu")
    lp = fit32.log_prob()(torch.as_tensor(fast["theta"], dtype=torch.float32))
    assert lp.dtype == torch.float32
    want = fast["jlp"]
    err = np.max(np.abs(lp.double().numpy() - want)) / np.max(np.abs(want))
    assert err < 1e-4, err


def test_fast_against_own_parity_at_mid_box(fast):
    """As tests/test_likelihood_parity.py holds the JAX package: the fast
    terms track the parity terms at the box centre, radiation on."""
    par = get_preset("joint.multiprobe", MODEL, device="cpu", dtype=F64)
    lo, hi = par.spec.bounds[:, 0], par.spec.bounds[:, 1]
    theta = torch.as_tensor(0.5 * (lo + hi))[None]
    fb = fast["tfit"].chi2_breakdown()(theta)
    pb = par.chi2_breakdown()(theta)
    assert set(fb) == set(pb)
    for k in pb:
        tol = 2e-2 if k in ("fs8", "sn") else 5e-3
        assert float(fb[k][0]) == pytest.approx(float(pb[k][0]), abs=tol), k


@pytest.mark.parametrize("name, model", [("joint.multiprobe", MODEL), ("fs8.fs8", "lcdm"),
                                         ("cc.cc_union3", "wzcdm"), ("cc.cc_des5y", "wcdm")])
def test_fused_plain_matches_the_terms_at_70_walkers(fast, name, model):
    """The fused log-prob's plain version against the sum of the fast
    terms (log-normalisations included), 1e-10 relative in f64; bad
    walkers touch no other row."""
    fit = _fast_fit(name, model)
    theta = torch.as_tensor(_thetas(fit.spec.bounds, seed=1, n=70))
    packed = fl.pack(fit)
    before = fl.LAUNCHES
    fused = fl.fused_log_prob(packed, theta)
    assert fl.LAUNCHES == before  # CPU tensors never reach the kernel
    terms = make_log_prob(fit.spec, fit.terms, fit.derive)(theta)
    assert fused.shape == (70,) and bool(torch.isfinite(fused).all())
    np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0)

    names = fit.spec.names
    bad = torch.cat([theta, theta[:3].clone()])
    bad[70, names.index("Om")] = 0.95  # beyond every preset's Om bound
    bad[71, 0] = float("nan")
    bad[72, -1] = fit.spec.bounds[-1, 1]  # on the edge: outside the strict interior
    lp = fl.fused_log_prob_reference(packed, bad)
    assert bool(torch.all(lp[70:] == -torch.inf))
    np.testing.assert_allclose(lp[:70].numpy(), fused.numpy(), rtol=1e-12, atol=0)


def test_tucker_contraction_in_3xtf32_holds_each_term(fast):
    """The kernel's tensor-core contraction, emulated as in
    tests/test_torch_fast.py: in 3xTF32 each multiprobe term alone (the
    linear BAO, SN and CC, the quasar lift, the fs8 amplitude pair) stays
    within 1e-4 of its own max|logp| of the f64 plain version on 70
    bench-like walkers; one TF32 pass fails that check."""
    tfit = fast["tfit"]
    packed = fl.pack(tfit)
    assert [fl.KINDS[f["F_KIND"]] for f in packed.forms] == ["linear"] * 3 + ["lift", "amp_pair"]
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, seed=1, n=70))
    three, one = (tucker_term_errors(packed, theta, p) for p in (3, 1))
    print(f"each term alone vs f64: 3xTF32 {three}, one TF32 pass {one}")
    assert max(three) <= 1e-4 < max(one), (three, one)


def test_packer_takes_the_12_new_configurations(fast, monkeypatch):
    kinds = {"joint.multiprobe": ["linear", "linear", "linear", "lift", "amp_pair"],
             "fs8.fs8": ["amp_pair"], "cc.cc_union3": ["linear", "linear"],
             "cc.cc_des5y": ["linear", "linear"]}
    for name in NEW_FAST:
        for model in ("lcdm", "wcdm", "wzcdm"):
            fit = _fast_fit(name, model)
            packed = fl.pack(fit)
            h = packed.hdr
            assert [fl.KINDS[f["F_KIND"]] for f in packed.forms] == kinds[name], name
            assert h["H_NQ"] * 4 <= fl.MAX_RALL and h["H_SIZE"] <= fl.MAX_FLOATS
            assert max(h["H_R1"], h["H_R2"]) <= fl.MAX_RANK
            assert h["H_I_H0"] == (-1 if name == "fs8.fs8" else fit.spec.names.index("H0"))
            assert h["H_HAS_CMB"] == (name == "joint.multiprobe")
            ops, product, nbytes = fl.work_per_walker(packed)
            assert nbytes == 4 * (fit.spec.dim + 1) and ops > 0
            assert product == 2 * h["H_R1"] * h["H_R2"] * h["H_RALL"]
    # w0wacdm is no longer refused: it goes on to build its tables (built
    # and packed on a reduced grid in tests/test_torch_w0wa_joint.py)
    class Building(Exception):
        pass

    def building(*args, **kwargs):
        raise Building

    monkeypatch.setattr("cosmax_torch.models.linear_chi2.table_cached", building)
    monkeypatch.setattr("cosmax_torch.models.linear_chi2._FINALIZE_MEMO", {})
    with pytest.raises(Building):
        get_preset("joint.multiprobe", "w0wacdm", fast=True, device="cpu")


def test_cli_fast_multiprobe_on_the_cpu(tmp_path, capsys):
    from cosmax_torch import fit as fit_cli

    out = tmp_path / "run"
    rc = fit_cli.main(["--preset", "joint.multiprobe", "--model", MODEL, "--fast",
                       "--device", "cpu", "--walkers", "16", "--steps", "3", "--seed", "0",
                       "--no-plots", "--out", str(out)])
    assert rc == 0
    assert "fast path" in capsys.readouterr().out
    chain = np.load(out / "chain.npy")
    assert chain.shape[1:] == (16, 11) and np.all(np.isfinite(chain))
