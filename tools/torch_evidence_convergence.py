#!/usr/bin/env python3
"""Flagship-scale stepping-stone convergence measurement on the port (the
port of ``tools/evidence_convergence.py``).

    python3 tools/torch_evidence_convergence.py [--preset bao.desi_cmb_des5y]
        [--model lcdm] [--replicates 4] [--threshold 0.1]
        [--golden-mult 16] [--seed 0] [--device cuda] [--x64]

Quantifies the absolute-ln Z systematic of the evidence ladder
(``cosmax_torch.samplers.evidence.SteppingStone``) at default budgets on
the flagship joint (``bao.desi_cmb_des5y``: |ln L| ~ 1e3, a sharp
posterior) by comparing three runs:

1. ``default``: the static default budget (n_warmup = n_samples = 300),
   R independent replicate ladders;
2. ``until_stable``: the budget-doubling mode starting from the default
   budget: doubles (warmup, samples) until the replicate-mean ln Z moves
   less than ``--threshold`` nats between consecutive budgets;
3. ``golden``: one long run (``--golden-mult`` times the default budget)
   whose estimate stands in for the truth.

Each stage prints one JSON line (ln Z, its error, the replicates, the
worst rung's split R-hat, the acceptance, the seconds and the fused
kernel's launches), then a summary whose ``pass`` is
|until_stable - golden| <= max(2 (err_s + err_g), threshold). The exit
code is 0 on a pass.

As ``cosmax_torch.compare`` does, it takes ``--device`` (default ``cuda``:
float32, the fused kernel's value in every leapfrog step) and ``--x64``
(float64, CPU only). The likelihood is the preset's fast path, the prior
the uniform box of its bounds. The three stages take three distinct
seeds, drawn from ``--seed`` by numpy's ``SeedSequence``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stage_record(label, res, seconds, launches):
    """The JSON line of one stage (the JAX tool's keys, plus the fused
    kernel's launches)."""
    import numpy as np

    rec = {
        "stage": label,
        "log_evidence": round(res.log_evidence, 4),
        "error": round(res.error, 4),
        "per_replicate": [round(float(t), 4) for t in res.per_replicate],
        "max_rung_rhat": round(float(np.max(res.rung_rhat)), 4),
        "acceptance": round(res.acceptance, 3),
        "wall_s": round(seconds, 1),
        "fused_launches": launches,
    }
    if res.converged is not None:
        rec["converged"] = bool(res.converged)
        rec["history"] = [[int(w), int(s), round(z, 4), round(e, 4)]
                          for (w, s, z, e) in res.history]
    return rec


def summary_record(default, stable, golden, threshold):
    """The summary line from the three stages' (ln Z, error)."""
    d_def = default.log_evidence - golden.log_evidence
    d_stable = stable.log_evidence - golden.log_evidence
    tol = 2.0 * (stable.error + golden.error)
    return {
        "stage": "summary",
        "default_minus_golden": round(d_def, 4),
        "until_stable_minus_golden": round(d_stable, 4),
        "tolerance_2err": round(tol, 4),
        "pass": bool(abs(d_stable) <= max(tol, threshold)),
    }


def run(argv=None):
    """The three stages and the summary: returns their four records."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="bao.desi_cmb_des5y")
    ap.add_argument("--model", default="lcdm")
    ap.add_argument("--replicates", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--golden-mult", type=int, default=16)
    ap.add_argument("--base-warmup", type=int, default=300)
    ap.add_argument("--base-samples", type=int, default=300)
    ap.add_argument("--max-doublings", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--x64", action="store_true", help="float64 (CPU only)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob
    from cosmax_torch.samplers.evidence import SteppingStone

    fit = get_preset(args.preset, args.model, fast=True, device=args.device,
                     dtype=torch.float64 if args.x64 else None)
    bounds = np.asarray(fit.spec.bounds, dtype=np.float64)
    ss = SteppingStone(fit.value_and_grad(), bounds, dtype=fit.dtype, device=fit.device)
    print(f"# {args.preset} [{args.model}] rungs={ss.n_rungs} chains={ss.n_chains} "
          f"dim={ss.ndim} R={args.replicates} device={fit.device} dtype={fit.dtype}",
          flush=True)
    seed_def, seed_stable, seed_gold = (
        int(s) for s in np.random.SeedSequence(args.seed).generate_state(3))
    base = dict(n_warmup=args.base_warmup, n_samples=args.base_samples,
                n_replicates=args.replicates)
    stages = (
        ("default", seed_def, base),
        ("until_stable", seed_stable, dict(base, until_stable=args.threshold,
                                           max_doublings=args.max_doublings)),
        ("golden", seed_gold, dict(base, n_warmup=args.base_warmup * args.golden_mult,
                                   n_samples=args.base_samples * args.golden_mult)),
    )
    results, records = [], []
    for label, seed, kw in stages:
        before = fused_log_prob.LAUNCHES
        t0 = time.perf_counter()
        res = ss.run(seed, **kw)
        rec = stage_record(label, res, time.perf_counter() - t0, fused_log_prob.LAUNCHES - before)
        print(json.dumps(rec), flush=True)
        results.append(res)
        records.append(rec)
    summary = summary_record(*results, args.threshold)
    print(json.dumps(summary), flush=True)
    return records + [summary]


def main(argv=None):
    return 0 if run(argv)[-1]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
