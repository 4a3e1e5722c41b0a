#!/usr/bin/env python3
"""Per-term time ablation of a preset's joint log-likelihood on the card
(the port of ``tools/profile_terms.py``).

    python3 tools/torch_profile_terms.py [--preset bao.desi_cmb_des5y]
        [--model wzcdm] [--walkers 131072] [--iters 50] [--parity]
        [--device cuda]

Times the batched ``fit.log_prob()`` with each term removed in turn; the
difference attributes the time per probe. On the fast path (the default)
the fit without a term is packed again without it, so every variant is
one launch of the fused kernel; on the parity path (``--parity``) the
per-term functions are summed as usual (the dense SN terms through the
chi^2 kernel). Each of ``ROUNDS`` rounds times every variant over
``--iters`` back-to-back calls, with CUDA events on the card
(``time.perf_counter`` on the CPU); a term's time is the median over the
rounds of its difference within a round, printed with its least and most.
Walkers are drawn near the box centre as ``bench.py`` draws them. The
kernels' launch counts over the whole ablation are printed too.
"""

import argparse
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUNDS = 5


def _walkers(fit, n, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    mid, span = 0.5 * (lo + hi), 0.05 * (hi - lo)
    theta = mid + span * rng.standard_normal((n, fit.spec.dim))
    return torch.as_tensor(theta, device=fit.device).to(fit.dtype)


def _ms(fn, iters, on_card):
    """ms a call over ``iters`` back-to-back calls."""
    import torch

    if on_card:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = 1e3 * (time.perf_counter() - t0)
    return ms / iters


def profile_terms(preset="bao.desi_cmb_des5y", model="wzcdm", walkers=131072, iters=50,
                  fast=True, device="cuda", fit=None):
    """{"full_ms", "terms": {name: (ms without it, ms it takes)},
    "spread": {name: (least, most ms it takes in a round)}, "launches":
    {kernel: count}} of the ablation (``fit`` reuses a built preset).

    Each of ``ROUNDS`` rounds times the full fit and every fit without one
    term back to back; a term's time is the median over the rounds of the
    full time less the time without it in the same round, so a drift of
    the clocks between rounds does not enter the difference."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob, whitened_chi2

    if fit is None:
        fit = get_preset(preset, model, fast=fast, device=device)
    on_card = fit.device.type == "cuda"
    theta = _walkers(fit, walkers)
    fused_log_prob.LAUNCHES = whitened_chi2.LAUNCHES = 0

    variants = {None: fit}
    for term in fit.terms:
        variants[term.name] = replace(fit, terms=tuple(t for t in fit.terms if t is not term))
    lps = {k: f.log_prob() for k, f in variants.items()}
    times = {k: [] for k in lps}
    with torch.no_grad():
        for lp in lps.values():
            lp(theta)  # warm-up (a first call builds and caches what it needs)
        for _ in range(ROUNDS):
            for k, lp in lps.items():
                times[k].append(_ms(lambda: lp(theta), iters, on_card))
    full = np.asarray(times.pop(None))
    terms, spread = {}, {}
    for name, t in times.items():
        share = full - np.asarray(t)
        terms[name] = (float(np.median(t)), float(np.median(share)))
        spread[name] = (float(share.min()), float(share.max()))
    launches = dict(fused_log_prob=fused_log_prob.LAUNCHES, whitened_chi2=whitened_chi2.LAUNCHES)
    return dict(preset=fit.name, model=fit.model, fast=fit.fast, walkers=walkers, iters=iters,
                rounds=ROUNDS, full_ms=float(np.median(full)), terms=terms, spread=spread,
                launches=launches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="bao.desi_cmb_des5y")
    ap.add_argument("--model", default="wzcdm")
    ap.add_argument("--walkers", type=int, default=131072)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--fast", action="store_true", default=True)
    ap.add_argument("--parity", dest="fast", action="store_false")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    out = profile_terms(args.preset, args.model, args.walkers, args.iters, args.fast,
                        args.device)
    w, full = out["walkers"], out["full_ms"]
    print(f"{out['preset']} [{out['model']}] {'fast' if out['fast'] else 'parity'} path, "
          f"{w} walkers: full ({len(out['terms'])} terms) {full:.4f} ms a call, "
          f"{w / (full * 1e-3):.3e} evals/s")
    for name, (without, share) in out["terms"].items():
        lo, hi = out["spread"][name]
        print(f"  {name:12s}: {share:+8.4f} ms ({100 * share / full:5.1f}% of total; "
              f"{without:.4f} ms without it; rounds {lo:+.4f} to {hi:+.4f})")
    print("  launches: " + ", ".join(f"{k} {v}" for k, v in out["launches"].items()))
    return out


if __name__ == "__main__":
    main()
