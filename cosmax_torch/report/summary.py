"""Posterior summaries (counterpart of ``cosmax/report/summary.py``):
median +/- percentile errors, chi^2 at the median, dof, acceptance,
autocorrelation time, ESS, R-hat and the correlation matrix, as a
JSON-able dict.

Not ported yet: the ``derived`` parameter posteriors and the
``residual_stats`` block (ROADMAP.md queue 1, item 13).
"""

import numpy as np
import torch

from cosmax_torch.samplers.diagnostics import (
    autocorr_time,
    correlation_matrix,
    effective_samples,
    gelman_rubin,
    percentile_summary,
)


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
    chi_parts = ", ".join(f"{k}={v:.2f}" for k, v in summary["chi2"].items())
    lines.append(f"Chi squared: {summary['chi2_total']:.2f} ({chi_parts})")
    lines.append(f"Degs of freedom: {summary['dof']}")
    lines.append(f"Acceptance fraction: {summary['acceptance_fraction']:.3f}")
    if summary["autocorr_time"] is not None:
        taus = ", ".join(f"{t:.1f}" for t in summary["autocorr_time"])
        lines.append(f"Autocorrelation time: [{taus}]")
        lines.append(f"Effective samples: {summary['effective_samples']:.0f}")
    rhat = ", ".join(f"{r:.4f}" for r in summary["gelman_rubin"])
    lines.append(f"Gelman-Rubin R-hat: [{rhat}]")
    return "\n".join(lines)
