"""Plotting (counterpart of ``cosmax/report/plots.py``): corner, trace,
and prediction / residual figures, on numpy inputs.

Self-contained matplotlib implementations (the ``corner`` package is not
a dependency) with the reference's settings: quantiles [0.159, 0.5,
0.841], 100 bins, smooth=2.0, 2D contour levels (0.393, 0.864) = 1 and
2 sigma in 2D (bao/desi.py:173-195), trace plots per dimension,
Hubble-diagram / H(z) / BAO prediction and residual panels
(sn/plotting.py, bao/plot_predictions.py,
cosmic_chronometers/plot_predictions.py).

The module imports matplotlib (with the Agg backend) and scipy.ndimage
when it is imported; ``cosmax_torch.fit`` imports it only when it writes
figures (as the GP and field CLIs import matplotlib only in ``main``), so
the rest of the port runs without matplotlib.
"""

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
from scipy.ndimage import gaussian_filter, gaussian_filter1d

from cosmax_torch.data.loaders import QTY_DH, QTY_DM, QTY_DV

QUANTILES = (0.159, 0.5, 0.841)
LEVELS = (0.393, 0.864)  # 1 and 2 sigma in 2D


def _contour_levels(hist, fractions):
    """Density levels enclosing the given probability fractions.

    Deduplicated and strictly increasing: for a sharply concentrated
    posterior both fractions can land on the same smoothed-density
    value, and ``ax.contour`` raises on non-increasing levels — degrade
    to fewer levels instead of crashing the whole corner plot."""
    flat = np.sort(hist.ravel())[::-1]
    cum = np.cumsum(flat)
    cum /= cum[-1]
    levels = sorted(flat[np.searchsorted(cum, f)] for f in fractions)
    return list(np.unique(levels))


def corner(flat_samples, labels=None, bins=100, smooth=2.0, fig=None):
    """Corner plot of [N, D] samples. ``fig`` reuses a caller-supplied
    figure (its existing axes are drawn over — the overlay idiom of the
    ``corner`` package); by default a new figure is created."""
    flat = np.asarray(flat_samples)
    ndim = flat.shape[1]
    labels = labels or [f"p{i}" for i in range(ndim)]
    if fig is not None:
        axes = np.asarray(fig.axes).reshape(ndim, ndim)
    else:
        fig, axes = plt.subplots(
            ndim, ndim, figsize=(2.2 * ndim, 2.2 * ndim)
        )
    axes = np.atleast_2d(axes)
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                h, edges = np.histogram(flat[:, i], bins=bins)
                h = gaussian_filter1d(h.astype(float), smooth)
                centers = 0.5 * (edges[1:] + edges[:-1])
                ax.plot(centers, h, color="k", lw=1)
                q = np.quantile(flat[:, i], QUANTILES)
                for v in q:
                    ax.axvline(v, color="k", ls="--", lw=0.8)
                ax.set_title(
                    f"{labels[i]} = {q[1]:.3f}"
                    f"$^{{+{q[2]-q[1]:.3f}}}_{{-{q[1]-q[0]:.3f}}}$",
                    fontsize=9,
                )
                ax.set_yticks([])
            else:
                h, xe, ye = np.histogram2d(flat[:, j], flat[:, i], bins=bins)
                h = gaussian_filter(h, smooth)
                xc = 0.5 * (xe[1:] + xe[:-1])
                yc = 0.5 * (ye[1:] + ye[:-1])
                ax.contour(
                    xc, yc, h.T, levels=_contour_levels(h, LEVELS),
                    colors="k", linewidths=0.8,
                )
            if i == ndim - 1:
                ax.set_xlabel(labels[j], fontsize=9)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i], fontsize=9)
            elif j > 0:
                ax.set_yticklabels([])
    fig.tight_layout()
    return fig


def trace(samples, labels=None):
    """Per-dimension walker traces (bao/desi.py:188-195)."""
    samples = np.asarray(samples)  # [T, W, D]
    ndim = samples.shape[-1]
    labels = labels or [f"p{i}" for i in range(ndim)]
    fig, axes = plt.subplots(ndim, 1, figsize=(16, 1.5 * ndim), squeeze=False)
    for n in range(ndim):
        ax = axes[n, 0]
        ax.plot(samples[:, :, n], alpha=0.3, lw=0.5)
        ax.set_ylabel(labels[n])
        ax.set_xlim(0, samples.shape[0])
    fig.tight_layout()
    return fig


def predictions_sn(z, obs_mag, err, theory_z, theory_mag, title=""):
    """Hubble diagram with residual panel (sn/plotting.py:8-69)."""
    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(8, 7), sharex=True,
        gridspec_kw={"height_ratios": [3, 1]},
    )
    ax1.errorbar(z, obs_mag, yerr=err, fmt=".", ms=2, alpha=0.4, label="data")
    ax1.plot(theory_z, theory_mag, "r-", lw=1.2, label="model")
    ax1.set_ylabel("m / mu [mag]")
    ax1.set_title(title)
    ax1.legend()
    ax1.set_xscale("log")
    interp = np.interp(z, theory_z, theory_mag)
    ax2.errorbar(z, obs_mag - interp, yerr=err, fmt=".", ms=2, alpha=0.4)
    ax2.axhline(0, color="r", lw=1)
    ax2.set_xlabel("z")
    ax2.set_ylabel("residual")
    fig.tight_layout()
    return fig


def predictions_bao(z, values, errors, quantities, theory_fn, title=""):
    """Colored per-quantity BAO panel (bao/plot_predictions.py:17-46)."""
    fig, ax = plt.subplots(figsize=(8, 5))
    colors = {QTY_DV: "tab:blue", QTY_DM: "tab:orange", QTY_DH: "tab:green"}
    names = {QTY_DV: "$D_V/r_d$", QTY_DM: "$D_M/r_d$", QTY_DH: "$D_H/r_d$"}
    z_grid = np.linspace(max(z.min() * 0.8, 0.01), z.max() * 1.1, 100)
    for q in (QTY_DV, QTY_DM, QTY_DH):
        mask = quantities == q
        if not mask.any():
            continue
        ax.errorbar(
            z[mask], values[mask], yerr=errors[mask], fmt="o", ms=4,
            color=colors[q], label=names[q],
        )
        ax.plot(z_grid, theory_fn(z_grid, q), color=colors[q], lw=1)
    ax.set_xlabel("z")
    ax.set_ylabel("distance ratio")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    return fig


def predictions_cc(z, h_obs, err, theory_z, theory_h, title=""):
    """H(z) curve + residuals (cosmic_chronometers/plot_predictions.py)."""
    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(8, 7), sharex=True,
        gridspec_kw={"height_ratios": [3, 1]},
    )
    ax1.errorbar(z, h_obs, yerr=err, fmt="o", ms=4, alpha=0.7)
    ax1.plot(theory_z, theory_h, "r-")
    ax1.set_ylabel("H(z) [km/s/Mpc]")
    ax1.set_title(title)
    interp = np.interp(z, theory_z, theory_h)
    ax2.errorbar(z, h_obs - interp, yerr=err, fmt="o", ms=4, alpha=0.7)
    ax2.axhline(0, color="r")
    ax2.set_xlabel("z")
    ax2.set_ylabel("residual")
    fig.tight_layout()
    return fig


def residual_histogram(residuals, title=""):
    """Histogram + normal fit (sn/plotting.py:44-69)."""
    from scipy.stats import norm

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(residuals, bins=40, density=True, alpha=0.6)
    mu, sig = norm.fit(residuals)
    x = np.linspace(residuals.min(), residuals.max(), 200)
    ax.plot(x, norm.pdf(x, mu, sig), "r-", lw=1.5,
            label=f"N({mu:.3f}, {sig:.3f})")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    return fig
