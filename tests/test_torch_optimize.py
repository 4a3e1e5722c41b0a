"""cosmax_torch.samplers.optimize and cosmax_torch.compare against the JAX
package, f64 on the CPU.

* ``best_fit``, ``laplace_fit`` and ``compare_models`` on ``bao.desi``
  against the JAX package's: x to 1e-6 relative, sigma to 1e-5
  relative, chi^2_min and ln Z to 1e-6 absolute; and the published
  anchors chi^2_min 10.27 / 9.04 / 8.43 / 5.62 (lcdm / wcdm / wzcdm /
  w0wacdm) within 0.01 through ``python -m cosmax_torch.compare --device
  cpu --x64``.
* The JAX tests' cases as the port's (tests/test_optimize.py,
  tests/test_compare.py): a quadratic and Rosenbrock, Adam, the exact
  Gaussian Laplace covariance and evidence, ``laplace_fit`` with the CC
  term's log-normalisation (the mode, not the chi^2 minimum on a bound).
"""

import json

import jax
import numpy as np
import pytest
import torch

from cosmax.compare import compare_models as jax_compare_models
from cosmax.configs import get_preset as jax_preset
from cosmax.samplers.optimize import best_fit as jax_best_fit
from cosmax.samplers.optimize import laplace_fit as jax_laplace_fit
from cosmax_torch import compare
from cosmax_torch.configs import get_preset
from cosmax_torch.configs.presets import FitSpec
from cosmax_torch.likelihoods.base import ParamSpec, Term
from cosmax_torch.samplers.optimize import (
    adam_minimize,
    best_fit,
    laplace,
    laplace_fit,
    minimize_chi2,
)

F64 = torch.float64
ANCHORS = {"lcdm": 10.27, "wcdm": 9.04, "wzcdm": 8.43, "w0wacdm": 5.62}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The samplers run thousands of small tensor ops: on one intra-op
    thread each; beside other test processes a thread pool per op spins
    (a 10 s case took 450 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_minimize_quadratic():
    a = torch.diag(torch.tensor([1.0, 10.0, 100.0], dtype=F64))
    target = torch.tensor([1.0, -2.0, 0.5], dtype=F64)
    x, fval, _ = minimize_chi2(lambda x: (x - target) @ a @ (x - target), np.zeros(3), device="cpu")
    np.testing.assert_allclose(x, target.numpy(), atol=1e-6)
    assert fval < 1e-10


def test_minimize_rosenbrock():
    x, _, _ = minimize_chi2(lambda x: (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2,
                            np.array([-1.0, 1.0]), iters=200, device="cpu")
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-4)


def test_adam_minimize():
    x, losses = adam_minimize(lambda x: torch.sum((x - 3.0) ** 2), np.zeros(2), iters=2000,
                              lr=0.05)
    np.testing.assert_allclose(x.numpy(), [3.0, 3.0], atol=1e-2)
    assert losses.shape == (2000,) and losses[-1] < losses[0]


def test_laplace_gaussian_exact():
    cov_true = np.array([[2.0, 0.6], [0.6, 0.5]])
    prec = torch.as_tensor(np.linalg.inv(cov_true))
    cov, sig, corr = laplace(lambda x: -0.5 * x @ prec @ x, np.zeros(2), device="cpu")
    np.testing.assert_allclose(cov, cov_true, rtol=1e-6)
    np.testing.assert_allclose(sig, np.sqrt(np.diag(cov_true)), rtol=1e-6)
    np.testing.assert_allclose(corr[0, 1], 0.6 / np.sqrt(2.0 * 0.5), rtol=1e-6)


def test_laplace_log_evidence_gaussian_exact():
    cov = np.array([[2.0, 0.3], [0.3, 0.5]])
    prec = torch.as_tensor(np.linalg.inv(cov))

    def chi2(p):
        x = torch.stack([p["x0"], p["x1"]], dim=-1)
        return ((x @ prec) * x).sum(-1)

    spec = ParamSpec(("x0", "x1"), np.array([[-50.0, 50.0]] * 2))
    fit = FitSpec("gauss", "lcdm", spec, (Term("gauss", chi2),), lambda p: p,
                  torch.device("cpu"), F64, data_size=2)
    got = compare.laplace_log_evidence(fit, np.zeros(2))
    want = np.log(2.0 * np.pi) + 0.5 * np.linalg.slogdet(cov)[1] - 2.0 * np.log(100.0)
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.fixture(scope="module")
def desi():
    with jax.enable_x64(True):
        jfit = jax_preset("bao.desi", "lcdm")
        jbest = jax_best_fit(jfit)
        jlap = jax_laplace_fit(jfit)
        jrows = jax_compare_models("bao.desi", ["lcdm", "wzcdm"])
    return dict(tfit=get_preset("bao.desi", "lcdm", device="cpu", dtype=F64), jbest=jbest,
                jlap=jlap, jrows=jrows)


def test_best_fit_matches_jax(desi):
    (got, f, _), (want, wf, _) = best_fit(desi["tfit"]), desi["jbest"]
    for n in want:
        assert got[n] == pytest.approx(want[n], rel=1e-6)
    assert f == pytest.approx(wf, abs=1e-6)
    assert f == pytest.approx(10.27, abs=0.01)


def test_laplace_fit_matches_jax(desi):
    (got, chi2, corr), (want, wchi2, wcorr) = laplace_fit(desi["tfit"]), desi["jlap"]
    for n, (v, s) in want.items():
        assert got[n][0] == pytest.approx(v, rel=1e-6)
        assert got[n][1] == pytest.approx(s, rel=1e-5)
    assert chi2 == pytest.approx(wchi2, abs=1e-6)
    np.testing.assert_allclose(corr, wcorr, atol=1e-5)
    assert corr[0, 1] < -0.2  # h and Om anticorrelate along the ridge


def test_compare_models_matches_jax(desi):
    rows = {r["model"]: r for r in compare.compare_models(
        "bao.desi", ["lcdm", "wzcdm"], device="cpu", dtype=F64)}
    for w in desi["jrows"]:
        r = rows[w["model"]]
        assert r["chi2_min"] == pytest.approx(w["chi2_min"], abs=1e-6)
        assert r["log_evidence"] == pytest.approx(w["log_evidence"], abs=1e-6)
        assert r["dlog_evidence"] == pytest.approx(w["dlog_evidence"], abs=1e-6)
        assert (r["k"], r["n"]) == (w["k"], w["n"])
        for n, (v, s) in w["params"].items():
            assert r["params"][n][0] == pytest.approx(v, rel=1e-6)
            assert r["params"][n][1] == pytest.approx(s, rel=1e-5)


def test_compare_cli_anchors(tmp_path, capsys):
    out = tmp_path / "c.json"
    assert compare.main(["--preset", "bao.desi", "--device", "cpu", "--x64",
                         "--json", str(out)]) == 0
    rows = {r["model"]: r for r in json.loads(out.read_text())}
    for model, want in ANCHORS.items():
        assert rows[model]["chi2_min"] == pytest.approx(want, abs=0.01), model
    assert "ln Z - ln Z_lcdm" in capsys.readouterr().out


def test_laplace_fit_with_norm_terms():
    """The CC term's -N ln f normalisation: the mode, not the chi^2
    minimum on the f_cc bound; the Laplace sigmas track the published
    widths (cosmic_chronometers/cc.py:171-178: H0 3.8, f 0.09)."""
    params, chi2_at_map, _ = laplace_fit(get_preset("cc.cc", "lcdm", device="cpu", dtype=F64))
    h0_map, h0_sig = params["H0"]
    f_map, f_sig = params["f_cc"]
    assert h0_map == pytest.approx(67.1, abs=1.0)
    assert f_map == pytest.approx(0.67, abs=0.04)
    assert h0_sig == pytest.approx(3.8, rel=0.2)
    assert f_sig == pytest.approx(0.09, rel=0.2)
    assert np.isfinite(chi2_at_map)
