"""Posterior summaries (counterpart of ``cosmax/report/summary.py``):
median +/- percentile errors, chi^2 at the median, dof, acceptance,
autocorrelation time, ESS, R-hat, the correlation matrix, the derived
parameters (Om h^2, z_eq, z*, z_drag, r_drag, r* and r_d at the median,
S8) where the sampled parameters allow them, and R^2, RMSD, skewness and
kurtosis of each plottable probe's residuals at the median, as a
JSON-able dict.

The derived posteriors are elementwise fitting formulae on the host's
float64 samples; the sound horizons at the median and the residuals'
theory come from the terms' hooks on the fit's device, converted to
numpy once.
"""

import numpy as np
import torch

from cosmax_torch.data.loaders import QTY_DH, QTY_DM, QTY_DV
from cosmax_torch.models import recombination as rec
from cosmax_torch.samplers.diagnostics import (
    autocorr_time,
    correlation_matrix,
    effective_samples,
    gelman_rubin,
    percentile_summary,
)


def _scalar_stats(x):
    p16, p50, p84 = np.percentile(x, [15.9, 50, 84.1])
    return {"median": p50, "plus": p84 - p50, "minus": p50 - p16}


def at_medians(fit, medians):
    """The derived parameter dict of one walker, the point ``medians``
    [D] on the fit's device and dtype ([1] tensors)."""
    theta = torch.as_tensor(np.asarray(medians, dtype=np.float64)[None, :], device=fit.device)
    return fit.derive(fit.spec.unpack(theta.to(fit.dtype)))


def derived_posteriors(fit, flat):
    """Derived-parameter posteriors of the flat samples [N, D] (the
    reference's cmb/cmb.py:98-116 and fs8/fs8.py:159-160 for S8)."""
    names = fit.spec.names
    cols = {n: flat[:, i] for i, n in enumerate(names)}
    out = {}
    comp = next(
        (t.meta.get("compression") for t in fit.terms if t.meta.get("compression")),
        None,
    )
    if "H0" in cols or "h" in cols:
        h = cols["h"] if "h" in cols else cols["H0"] / 100.0
        if "Om" in cols:
            omh2 = cols["Om"] * h**2
            out["Omh2"] = _scalar_stats(omh2)
            if comp is not None:
                # z_eq = -1 + wm / (Or h^2), per sample (cmb/cmb.py:101)
                out["z_eq"] = _scalar_stats(-1.0 + omh2 / comp.omega_r_h2())
            if "Obh2" in cols:
                wb = cols["Obh2"]
                # z* follows the compression's variant; z_drag is always
                # the Aizpuru A2 formula, even for the union3 compression,
                # whose z* is Hu-Sugiyama (data_union3_compression.py:88-103)
                zs_fn = (
                    rec.z_star_hu
                    if comp is not None and comp.z_star_variant == "hu"
                    else rec.z_star
                )
                out["z_star"] = _scalar_stats(zs_fn(wb, omh2))
                out["z_drag"] = _scalar_stats(rec.z_drag(wb, omh2))
                out["r_drag"] = _scalar_stats(rec.r_drag_aizpuru(wb, omh2))
                if comp is not None:
                    # r* / r_d from the sound-horizon integral at the
                    # posterior median, as the reference prints them
                    # (cmb/cmb.py:115-116)
                    p = at_medians(fit, [np.median(cols[n]) for n in names])
                    h0 = p["H0"] if "H0" in p else 100.0 * p["h"]
                    wb_m, wm_m = float(np.median(wb)), float(np.median(omh2))
                    for key, zz in (
                        ("r_star_median", float(zs_fn(wb_m, wm_m))),
                        ("r_d_median", float(rec.z_drag(wb_m, wm_m))),
                    ):
                        rs = rec.sound_horizon(
                            torch.full_like(h0, zz), p, fit.model, h0,
                            torch.full_like(h0, wb_m), o_gamma_h2=comp.o_gamma_h2,
                        )
                        out[key] = {"median": float(rs[0]), "plus": 0.0, "minus": 0.0}
    if "sigma8" in cols and "Om" in cols:
        out["S8"] = _scalar_stats(cols["sigma8"] * np.sqrt(cols["Om"] / 0.3))
    return out


def _host(x):
    return x.detach().cpu().double().numpy()


def residual_theory(term, p):
    """The theory vector [N] of a plottable term at the one walker of
    ``p`` (its data points, in their order): the SN magnitudes, each BAO
    point's own quantity, H(z) at the CC redshifts. ``None`` for a term
    of another kind; a ``KeyError`` where its meta lacks the plot hooks."""
    kind = term.meta.get("plot_kind")
    if kind == "sn":
        return _host(term.meta["theory_mag"](p)[0])
    if kind == "bao":
        z, qty = term.meta["z"], term.meta["quantity"]
        curve = term.meta["theory_curve"]
        theory = np.empty(z.shape, dtype=np.float64)
        for q in (QTY_DV, QTY_DM, QTY_DH):
            rows = qty == q
            if rows.any():
                theory[rows] = _host(curve(p, z[rows], q)[0])
        return theory
    if kind == "cc":
        return _host(term.meta["theory_curve"](p, term.meta["z"])[0])
    return None


def _residual_stats(fit, medians):
    """R^2, RMSD, skewness and kurtosis of each plottable probe's
    residuals at the posterior median (the reference prints these per
    run: sn/pantheon.py:116-142, bao/desi.py:151-162)."""
    from scipy import stats as sstats

    p = at_medians(fit, medians)
    out = {}
    for term in fit.terms:
        try:
            theory = residual_theory(term, p)
            if theory is None:
                continue
            values = np.asarray(term.meta["values"])
            resid = values - theory
            ss_res = float(np.sum(resid**2))
            ss_tot = float(np.sum((values - values.mean()) ** 2))
            out[term.name] = dict(
                r2=1.0 - ss_res / ss_tot,
                rmsd=float(np.sqrt(np.mean(resid**2))),
                skewness=float(sstats.skew(resid)),
                kurtosis=float(sstats.kurtosis(resid)),
            )
        except KeyError:
            # a term whose meta lacks the plot contract has no residual
            # block; anything else (signature drift, bad medians) must
            # surface, not silently drop the statistics
            continue
    return out


def summarize(fit, chain, discard: int = None, thin: int = 1) -> dict:
    """Summary dict for a finished chain."""
    discard = fit.burn_in if discard is None else discard
    samples = chain.samples.detach().cpu().numpy()[discard::thin]
    flat = samples.reshape(-1, samples.shape[-1])
    names = fit.spec.names

    summ = percentile_summary(flat, names)
    medians = np.array([summ[n][0] for n in names])
    theta = torch.as_tensor(medians[None, :], device=fit.device).to(fit.dtype)
    chis = {k: float(v[0]) for k, v in fit.chi2_breakdown()(theta).items()}
    logp = float(fit.log_prob()(theta)[0])

    try:
        taus = autocorr_time(samples)
        ess = float(effective_samples(samples, taus))
        taus = taus.tolist()
    except (ValueError, FloatingPointError, ZeroDivisionError):
        taus, ess = None, None

    return {
        "preset": fit.name,
        "model": fit.model,
        "legend": " + ".join(str(t.meta.get("legend", t.name)) for t in fit.terms),
        "params": {
            n: {"median": float(m), "plus": float(p), "minus": float(mi)}
            for n, (m, p, mi) in summ.items()
        },
        "chi2": chis,
        "chi2_total": float(sum(chis.values())),
        "log_prob_at_median": logp,
        "dof": fit.dof,
        "acceptance_fraction": chain.acceptance_fraction,
        "autocorr_time": taus,
        "effective_samples": ess,
        "gelman_rubin": gelman_rubin(samples).tolist(),
        "correlation_matrix": correlation_matrix(flat).tolist(),
        "derived": derived_posteriors(fit, flat),
        "residual_stats": _residual_stats(fit, medians),
        "n_samples": int(flat.shape[0]),
    }


def format_summary(summary: dict) -> str:
    """Human-readable block in the reference's print style."""
    lines = [
        f"{summary['legend']}  [{summary['preset']} / {summary['model']}]",
        "-" * 60,
    ]
    for name, s in summary["params"].items():
        lines.append(f"{name}: {s['median']:.4f} +{s['plus']:.4f} -{s['minus']:.4f}")
    for name, s in summary.get("derived", {}).items():
        lines.append(
            f"{name} (derived): {s['median']:.4f} +{s['plus']:.4f} -{s['minus']:.4f}"
        )
    chi_parts = ", ".join(f"{k}={v:.2f}" for k, v in summary["chi2"].items())
    lines.append(f"Chi squared: {summary['chi2_total']:.2f} ({chi_parts})")
    lines.append(f"Degs of freedom: {summary['dof']}")
    for tname, rs in summary.get("residual_stats", {}).items():
        lines.append(
            f"{tname}: R^2={rs['r2']:.4f} RMSD={rs['rmsd']:.3f} "
            f"skew={rs['skewness']:.3f} kurtosis={rs['kurtosis']:.3f}"
        )
    lines.append(f"Acceptance fraction: {summary['acceptance_fraction']:.3f}")
    if summary["autocorr_time"] is not None:
        taus = ", ".join(f"{t:.1f}" for t in summary["autocorr_time"])
        lines.append(f"Autocorrelation time: [{taus}]")
        lines.append(f"Effective samples: {summary['effective_samples']:.0f}")
    rhat = ", ".join(f"{r:.4f}" for r in summary["gelman_rubin"])
    lines.append(f"Gelman-Rubin R-hat: [{rhat}]")
    return "\n".join(lines)
