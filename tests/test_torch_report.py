"""The port's reports (``cosmax_torch.report``, ``fit --out``) against the
JAX package's on the CPU: derived posteriors on the same flat samples in
f64 (1e-10 relative), residual statistics at the same medians (1e-9),
the HTML Hubble diagram byte for byte, the corner plot's contour levels,
each figure rendered, and the files ``fit --out`` writes."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cosmax.configs import get_preset as jax_preset
from cosmax.report import html as jax_html
from cosmax.report import summary as jax_summary
from cosmax_torch.configs import get_preset
from cosmax_torch.report import html, plots, summary

F64 = torch.float64
# (preset, model, options, the point the samples scatter about)
DERIVED = [
    ("cmb.cmb", "lcdm", dict(compression="chen"), dict(H0=67.4, Om=0.3167, Obh2=0.02236)),
    ("cmb.cmb", "lcdm", dict(compression="union3"), dict(H0=67.39, Om=0.3148, Obh2=0.02236)),
    ("fs8.fs8", "lcdm", {}, dict(Om=0.268, sigma8=0.789, f_err=0.78)),
    ("bao.desi", "lcdm", {}, dict(h=0.690, Om=0.298)),
]
RESIDUALS = [
    ("bao.desi", "lcdm", dict(h=0.690, Om=0.298)),
    ("bao.desi", "wzcdm", dict(h=0.670, Om=0.308, w0=-0.832)),
    ("cc.cc", "lcdm", dict(H0=67.1, Om=0.317, f_cc=0.70)),
    ("sn.union3", "lcdm", dict(dM=-0.070, Om=0.357)),
    ("sn.pantheon", "wcdm", dict(M=-19.35, Om=0.33, w0=-0.9)),
]


def _fits(name, model, kw):
    with jax.enable_x64(True):
        jfit = jax_preset(name, model, **kw)
    return jfit, get_preset(name, model, device="cpu", dtype=F64, **kw)


def _close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], rtol)
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("name,model,kw,centre", DERIVED, ids=lambda v: str(v)[:20])
def test_derived_posteriors_match_jax(name, model, kw, centre):
    jfit, fit = _fits(name, model, kw)
    rng = np.random.default_rng(7)
    mid = np.array([centre[n] for n in fit.spec.names])
    flat = mid * (1.0 + 0.01 * rng.standard_normal((2000, mid.size)))
    with jax.enable_x64(True):
        want = jax_summary.derived_posteriors(jfit, flat)
    got = summary.derived_posteriors(fit, flat)
    assert want  # each case derives something
    _close(got, want, 1e-10)


@pytest.mark.parametrize("name,model,point", RESIDUALS, ids=lambda v: str(v)[:16])
def test_residual_stats_match_jax(name, model, point):
    jfit, fit = _fits(name, model, {})
    medians = np.array([point[n] for n in fit.spec.names])
    with jax.enable_x64(True):
        want = jax_summary._residual_stats(jfit, medians)
    got = summary._residual_stats(fit, medians)
    assert want
    _close(got, want, 1e-9)


@pytest.mark.parametrize("name,model,point", [RESIDUALS[0], RESIDUALS[3]],
                         ids=lambda v: str(v)[:16])
def test_fast_path_theory_hooks_match_the_parity_terms(name, model, point):
    """The fast fit's hooks (BAO's theory curve; the emulated SN term's
    basis expansion) give the residual statistics of the parity terms:
    the SN basis sits within its Chebyshev truncation of the dense
    trapezoid (1e-3 relative)."""
    fast = get_preset(name, model, fast=True, device="cpu", dtype=F64)
    parity = get_preset(name, model, device="cpu", dtype=F64)
    medians = np.array([point[n] for n in parity.spec.names])
    _close(summary._residual_stats(fast, medians), summary._residual_stats(parity, medians),
           1e-3)


def test_residual_stats_skip_terms_without_hooks():
    """A term whose meta lacks the plot contract has no residual block;
    another error surfaces."""
    from dataclasses import replace

    fit = get_preset("bao.desi", "lcdm", device="cpu", dtype=F64)
    bare = replace(fit.terms[0], meta={k: v for k, v in fit.terms[0].meta.items()
                                       if k != "theory_curve"})
    assert summary._residual_stats(replace(fit, terms=(bare,)), np.array([0.69, 0.298])) == {}
    broken = replace(fit.terms[0], meta=dict(fit.terms[0].meta,
                                             theory_curve=lambda p, z, q: 1 / 0))
    with pytest.raises(ZeroDivisionError):
        summary._residual_stats(replace(fit, terms=(broken,)), np.array([0.69, 0.298]))


def test_format_summary_prints_the_new_blocks():
    fit = get_preset("bao.desi", "lcdm", device="cpu", dtype=F64)
    text = summary.format_summary(dict(
        legend="DESI", preset="bao.desi", model="lcdm",
        params={"h": dict(median=0.69, plus=0.01, minus=0.01)},
        derived=summary.derived_posteriors(fit, np.array([[0.69, 0.3], [0.7, 0.29]])),
        residual_stats=summary._residual_stats(fit, np.array([0.69, 0.298])),
        chi2={"bao": 10.27}, chi2_total=10.27, dof=11, acceptance_fraction=0.3,
        autocorr_time=None, gelman_rubin=[1.0]))
    assert "Omh2 (derived)" in text and "bao: R^2=" in text


def test_hubble_diagram_html_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(0.01, 2.0, 60))
    mu = 5 * np.log10(z * 4400) + 25 + rng.normal(0, 0.1, 60)
    tz = np.linspace(0.01, 2.0, 40)
    tm = 5 * np.log10(tz * 4400) + 25
    for kw in (dict(), dict(x_scale="linear", title="T <&>", y_label="m [mag]")):
        jax_html.hubble_diagram_html(z, mu, 0.1, tz, tm, tmp_path / "a.html", **kw)
        html.hubble_diagram_html(z, mu, 0.1, tz, tm, tmp_path / "b.html", **kw)
        assert (tmp_path / "a.html").read_bytes() == (tmp_path / "b.html").read_bytes()


def test_contour_levels_equal_jax():
    from cosmax.report import plots as jax_plots

    rng = np.random.default_rng(4)
    for hist in (rng.random((30, 30)), np.outer(np.hanning(40), np.hanning(40)),
                 np.pad(np.ones((1, 1)), 5)):
        assert plots._contour_levels(hist, plots.LEVELS) == jax_plots._contour_levels(
            hist, jax_plots.LEVELS)


def test_each_figure_renders(tmp_path):
    rng = np.random.default_rng(5)
    samples = rng.normal(size=(40, 16, 3))
    figs = {
        "corner": plots.corner(samples.reshape(-1, 3), labels=["a", "b", "c"]),
        "trace": plots.trace(samples, labels=["a", "b", "c"]),
        "sn": plots.predictions_sn(np.linspace(0.01, 1, 30), np.linspace(33, 44, 30), 0.1,
                                   np.linspace(0.01, 1, 30), np.linspace(33, 44, 30)),
        "bao": plots.predictions_bao(np.array([0.3, 0.5, 0.5, 0.7]),
                                     np.array([8.0, 13.0, 22.0, 17.0]), np.full(4, 0.2),
                                     np.array([0, 1, 2, 1]), lambda zg, q: zg * 20.0 + q),
        "cc": plots.predictions_cc(np.linspace(0.1, 2, 20), np.linspace(70, 200, 20),
                                   np.full(20, 10.0), np.linspace(0, 2, 50),
                                   np.linspace(67, 200, 50)),
        "hist": plots.residual_histogram(rng.normal(0, 0.15, 500)),
    }
    for name, fig in figs.items():
        path = tmp_path / f"{name}.png"
        fig.savefig(path)
        plots.plt.close(fig)
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fit_out_writes_the_jax_set_of_files(tmp_path):
    """``fit --out`` without ``--no-plots`` on ``bao.desi`` (CPU, 32
    walkers x 20 steps): the files ``cosmax.fit --out`` writes, and a
    summary with the derived and residual blocks."""
    from cosmax_torch import fit as fit_cli

    out = tmp_path / "run"
    assert fit_cli.main(["--preset", "bao.desi", "--model", "lcdm", "--walkers", "32",
                         "--steps", "20", "--seed", "0", "--device", "cpu",
                         "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == sorted(
        ["summary.json", "chain.npy", "corner.png", "trace.png", "predictions_bao.png"])
    summ = json.loads((out / "summary.json").read_text())
    assert "Omh2" in summ["derived"] and set(summ["residual_stats"]) == {"bao"}
    assert np.load(out / "chain.npy").shape == (10, 32, 2)


def test_fit_out_sn_html_without_plots(tmp_path):
    """With ``--no-plots`` an SN fit still gets its HTML Hubble diagram
    (numpy only)."""
    from cosmax_torch import fit as fit_cli

    out = tmp_path / "run"
    assert fit_cli.main(["--preset", "sn.union3", "--model", "lcdm", "--walkers", "16",
                         "--steps", "4", "--device", "cpu", "--no-plots",
                         "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["chain.npy", "predictions_sn.html", "summary.json"]


def test_fit_out_refuses_before_sampling_without_matplotlib(tmp_path, monkeypatch, capsys):
    import sys

    from cosmax_torch import fit as fit_cli

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "run"
    with pytest.raises(SystemExit):
        fit_cli.main(["--preset", "bao.desi", "--device", "cpu", "--out", str(out)])
    assert "matplotlib" in capsys.readouterr().err
    assert not out.exists()
