#!/usr/bin/env python3
"""Transcription / reproducibility pre-check of the ``CASES`` rows, on the
port (the port of ``tools/precheck_rows.py``).

    python3 tools/torch_precheck_rows.py [--only SUBSTRING] [--refine]

For every row of ``CASES`` (``tools/torch_validate.py``, a copy of the JAX
sweep's table) it evaluates the parity-path chi^2 at the PUBLISHED
medians in float64 on the host and prints it against the published
chi^2. Sampled parameters the row does not publish (e.g. dM in
``bao.desi_union3_omh2``) are profiled out by scipy's Nelder-Mead over the
preset's bounds, with the JAX tool's options. A |delta| beyond ``FLAG``
flags either a transcription slip in ``CASES`` or a published row that the
current reference code cannot reproduce. ``--refine`` adds, for a flagged
row, the chi^2 minimum over the publication-rounding box (``refine_case``).

The evaluation runs in float64 on the CPU, as the JAX tool pins its host:
the float32 chi^2 error on the sharp CMB joints is ~0.1-0.5, larger than
the deltas being checked. The card plays no part here.
"""

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))  # the repo root (cosmax_torch)
sys.path.insert(0, _HERE)  # tools/ (torch_validate.CASES)

from torch_validate import CASES, _label as label  # noqa: E402

# ~0.3-0.4 is the natural scale of published-median rounding on the
# multi-nuisance joints; transcription slips give deltas of tens
FLAG = 0.6


def _half_last_digit(v):
    """Half of the published value's last printed decimal: the radius of
    its rounding interval."""
    s = f"{v:g}"
    dec = len(s.split(".")[1]) if "." in s else 0
    return 0.5 * 10.0 ** (-dec)


def _parity_chi2(name, model, kwargs):
    """(the fit, x [D] -> total chi^2) of the preset's parity path in
    float64 on the CPU."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset

    fit = get_preset(name, model, fast=False, device="cpu", dtype=torch.float64, **kwargs)
    breakdown = fit.chi2_breakdown()

    def chi2(x):
        theta = torch.as_tensor(np.asarray(x, dtype=np.float64)[None, :])
        with torch.no_grad():
            return float(sum(breakdown(theta).values())[0])

    return fit, chi2


def refine_case(name, model, kwargs, published, chi2_pub, extra=None):
    """Minimum chi^2 over the publication-rounding box around the
    published medians (each published parameter within half its last
    printed digit; unpublished sampled parameters free over their
    bounds). If the box minimum reaches the published chi^2 the row is
    rounding-consistent; if not, the published row came from another
    variant of the code."""
    import numpy as np
    from scipy.optimize import minimize

    fit, chi2 = _parity_chi2(name, model, kwargs)
    x0, lo, hi = [], [], []
    for i, p in enumerate(fit.spec.names):
        if p in published:
            med = published[p][0]
            r = _half_last_digit(med)
            x0.append(med)
            lo.append(med - r)
            hi.append(med + r)
        else:
            a, b = fit.spec.bounds[i]
            x0.append(0.5 * (a + b))
            lo.append(a)
            hi.append(b)
    res = minimize(chi2, np.array(x0), method="Nelder-Mead", bounds=list(zip(lo, hi)),
                   options={"xatol": 1e-9, "fatol": 1e-10, "maxiter": 20000, "maxfev": 40000})
    return float(res.fun)


def check_case(name, model, kwargs, published, chi2_pub, extra=None):
    """(chi^2 at the published medians, {profiled parameter: value}): the
    parameters the row does not publish minimised by Nelder-Mead from
    their bounds' midpoint."""
    import numpy as np
    from scipy.optimize import minimize

    fit, chi2 = _parity_chi2(name, model, kwargs)
    names = list(fit.spec.names)
    fixed = {p: med for p, (med, _sig) in published.items() if p in names}
    free = [p for p in names if p not in fixed]

    def chi2_at(x_free):
        vals = dict(fixed)
        vals.update(zip(free, x_free))
        return chi2([vals[p] for p in names])

    if not free:
        return chi2_at([]), {}
    lo = [fit.spec.bounds[names.index(p), 0] for p in free]
    hi = [fit.spec.bounds[names.index(p), 1] for p in free]
    x0 = np.array([0.5 * (a + b) for a, b in zip(lo, hi)])
    res = minimize(chi2_at, x0, method="Nelder-Mead",
                   options={"xatol": 1e-6, "fatol": 1e-8, "maxiter": 4000})
    return float(res.fun), dict(zip(free, [float(v) for v in res.x]))


def precheck(only=None, refine=False):
    """Check every ``CASES`` row whose label holds ``only``, printing one
    line a row; returns a dict a row (label, chi2, chi2_pub, delta,
    flagged, profiled; ``error`` for a row that raised, ``box_min`` with
    ``refine`` on a flagged row)."""
    rows = []
    for case in CASES:
        lab = label(case)
        if only and only not in lab:
            continue
        chi2_pub = case[4]
        if chi2_pub is None:
            print(f"{lab:60s}  (no published chi2)")
            continue
        try:
            chi2, prof = check_case(*case)
        except Exception as e:  # a row that fails to evaluate counts as flagged
            print(f"{lab:60s}  ERROR {e}")
            rows.append(dict(label=lab, error=str(e), flagged=True))
            continue
        d = chi2 - chi2_pub
        flagged = abs(d) >= FLAG
        row = dict(label=lab, chi2=chi2, chi2_pub=chi2_pub, delta=d, flagged=flagged,
                   profiled=prof)
        extra = f"  profiled {prof}" if prof else ""
        if flagged and refine:
            row["box_min"] = refine_case(*case)
            reach = "rounding-consistent" if row["box_min"] <= chi2_pub + 0.15 else "NOT reachable"
            extra += f"  rounding-box min {row['box_min']:.3f} ({reach})"
        print(f"{lab:60s}  chi2@pub {chi2:8.3f}  pub {chi2_pub:8.2f}  "
              f"d {d:+.3f}{'  <-- CHECK' if flagged else ''}{extra}", flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=None, help="check only the rows whose label holds this")
    ap.add_argument("--refine", action="store_true",
                    help="for rows beyond the flag threshold, also minimize chi2 over the "
                         "publication-rounding box (see refine_case)")
    args = ap.parse_args(argv)
    rows = precheck(args.only, args.refine)
    print(f"\n{sum(r['flagged'] for r in rows)} rows flagged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
