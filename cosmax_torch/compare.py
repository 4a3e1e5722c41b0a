"""Dark-energy model comparison: ``python -m cosmax_torch.compare``
(counterpart of ``cosmax/compare.py``).

For each model family: the LM-Newton point fit and the Laplace
approximation (``samplers.optimize``), and a table of

    chi2_min, Δchi2 vs ΛCDM, k (sampled parameters), AIC, BIC,
    and the Laplace log-evidence (uniform prior over the preset's
    bounds box)

in seconds, with no MCMC. ``--sampled-evidence`` adds the stepping-stone
evidence (``samplers.evidence``), which runs on the fast preset as the
reference's does.

Like every entry point of the port it takes ``--device`` (default
``cuda``: float32, the chi^2 kernel's autograd Function in the Hessians,
the fused kernel's values in the stepping stone) and ``--x64`` (float64,
CPU only): ``--device cpu --x64`` is the f64 host analysis that the JAX
package's ``compare`` always runs.

    python -m cosmax_torch.compare --preset bao.desi
    python -m cosmax_torch.compare --preset bao.desi --device cpu --x64
    python -m cosmax_torch.compare --preset bao.desi --models lcdm,wzcdm \\
        --sampled-evidence --replicates 2
"""

import argparse
import json
import sys

import numpy as np


def laplace_log_evidence(fit, x_map):
    """ln Z under the Laplace approximation with the preset's uniform
    prior: ln Z = logL(map) - ln V + (D/2) ln 2pi + 0.5 ln det cov.
    Exact for a Gaussian likelihood whose mass lies inside the box."""
    import torch

    from cosmax_torch.samplers.optimize import fit_laplace

    cov, _, _ = fit_laplace(fit, x_map)
    d = fit.spec.dim
    theta = torch.as_tensor(np.asarray(x_map, dtype=np.float64)[None, :], device=fit.device)
    with torch.no_grad():
        log_l_map = float(fit.differentiable_log_prob()(theta.to(fit.dtype))[0])
    bounds = np.asarray(fit.spec.bounds, dtype=np.float64)
    log_volume = float(np.sum(np.log(bounds[:, 1] - bounds[:, 0])))
    sign, logdet = np.linalg.slogdet(cov)
    if sign <= 0:
        raise ValueError("Laplace covariance not positive definite")
    return log_l_map - log_volume + 0.5 * d * np.log(2.0 * np.pi) + 0.5 * logdet


def compare_models(
    preset: str,
    models,
    fast: bool = False,
    sampled_evidence: bool = False,
    seed: int = 0,
    n_replicates: int = 4,
    ss_until_stable: float = None,
    device="cuda",
    dtype=None,
    **preset_kwargs,
):
    """Point-fit + Laplace comparison across model families.

    Returns a list of per-model dicts (chi2_min, dchi2, k, aic, bic,
    log_evidence, params). With ``sampled_evidence=True`` each row also
    carries the stepping-stone ``log_evidence_ss`` and
    ``log_evidence_ss_err`` (the cross-replicate scatter of
    ``n_replicates`` independent tempered ladders), run on the fast
    preset.
    """
    from cosmax_torch.configs import get_preset
    from cosmax_torch.samplers.optimize import chi2_total, fit_laplace, map_fit

    rows = []
    for model in models:
        fit = get_preset(preset, model, fast=fast, device=device, dtype=dtype, **preset_kwargs)
        # posterior mode, not raw-chi2 minimum: identical for pure-chi2
        # fits, required for f_cc / scatter likelihoods
        best, _, _ = map_fit(fit)
        x = np.asarray([best[n] for n in fit.spec.names], dtype=np.float64)
        _, sig, _ = fit_laplace(fit, x)
        chi2_min = chi2_total(fit, x)
        k = fit.spec.dim
        n = fit.data_size
        row = dict(
            model=model,
            chi2_min=chi2_min,
            k=k,
            n=n,
            aic=chi2_min + 2.0 * k,
            bic=chi2_min + k * float(np.log(n)) if n else None,
            log_evidence=laplace_log_evidence(fit, x),
            params={name: (float(v), float(s)) for name, v, s in zip(fit.spec.names, x, sig)},
        )
        if sampled_evidence:
            from cosmax_torch.samplers.evidence import stepping_stone_log_evidence

            ss_fit = fit if fast else get_preset(preset, model, fast=True, device=device,
                                                 dtype=dtype, **preset_kwargs)
            res = stepping_stone_log_evidence(
                ss_fit.value_and_grad(), ss_fit.spec.bounds, seed=seed,
                n_replicates=n_replicates, dtype=ss_fit.dtype, device=ss_fit.device,
                **({"until_stable": ss_until_stable} if ss_until_stable is not None else {}),
            )
            row["log_evidence_ss"] = res.log_evidence
            row["log_evidence_ss_err"] = res.error
            row["ss_per_replicate"] = [float(t) for t in res.per_replicate]
            row["ss_acceptance"] = res.acceptance
            row["ss_max_rung_rhat"] = float(np.max(res.rung_rhat))
            if res.converged is not None:
                row["ss_converged"] = bool(res.converged)
                row["ss_history"] = [list(h) for h in res.history]
                row["ss_budget"] = [res.n_warmup, res.n_samples]
        rows.append(row)
    base = next((r for r in rows if r["model"] == "lcdm"), rows[0])
    for r in rows:
        r["dchi2"] = r["chi2_min"] - base["chi2_min"]
        r["dlog_evidence"] = r["log_evidence"] - base["log_evidence"]
        if sampled_evidence:
            r["dlog_evidence_ss"] = r["log_evidence_ss"] - base["log_evidence_ss"]
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="cosmax_torch.compare", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", required=True)
    p.add_argument("--models", default="lcdm,wcdm,wzcdm,w0wacdm",
                   help="comma-separated model families")
    p.add_argument("--fast", action="store_true",
                   help="use the fast-path (emulated) likelihoods")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the table as JSON")
    p.add_argument("--sampled-evidence", action="store_true",
                   help="also compute the evidence by stepping-stone sampling "
                        "(tempered-ladder HMC) next to the Laplace one")
    p.add_argument("--replicates", type=int, default=4,
                   help="independent stepping-stone ladders; the printed ± is "
                        "their cross-replicate scatter")
    p.add_argument("--ss-until-stable", type=float, default=None, metavar="NATS",
                   help="double the stepping-stone budget until the replicate-mean "
                        "ln Z moves less than NATS between budgets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--x64", action="store_true", help="float64 (CPU only)")
    args = p.parse_args(argv)

    import torch

    rows = compare_models(
        args.preset,
        [m.strip() for m in args.models.split(",") if m.strip()],
        fast=args.fast, sampled_evidence=args.sampled_evidence,
        seed=args.seed, n_replicates=args.replicates,
        ss_until_stable=args.ss_until_stable, device=args.device,
        dtype=torch.float64 if args.x64 else None,
    )
    ss_hdr = "  ss: ln Z - ln Z_lcdm" if args.sampled_evidence else ""
    hdr = (f"{'model':10s} {'chi2_min':>9s} {'dchi2':>7s} {'k':>2s} "
           f"{'AIC':>9s} {'BIC':>9s} {'ln Z - ln Z_lcdm':>17s}{ss_hdr}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        bic = f"{r['bic']:9.2f}" if r["bic"] is not None else "      n/a"
        ss = ""
        if args.sampled_evidence:
            ss = (f"  {r['dlog_evidence_ss']:+12.2f} ±{r['log_evidence_ss_err']:.2f}"
                  f"  rhat={r['ss_max_rung_rhat']:.3f}")
            if "ss_converged" in r:
                ss += (f"  {'converged' if r['ss_converged'] else 'NOT converged'}"
                       f" @ warmup={r['ss_budget'][0]},samples={r['ss_budget'][1]}")
        print(f"{r['model']:10s} {r['chi2_min']:9.2f} {r['dchi2']:+7.2f} "
              f"{r['k']:2d} {r['aic']:9.2f} {bic} {r['dlog_evidence']:+17.2f}{ss}")
        best = "  ".join(f"{n}={v:.4g}±{s:.2g}" for n, (v, s) in r["params"].items())
        print(f"           {best}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"# wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
