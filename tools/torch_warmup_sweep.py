#!/usr/bin/env python3
"""HMC warmup seed-robustness sweep on the port (the port of
``tools/warmup_sweep.py``).

    python3 tools/torch_warmup_sweep.py [--preset bao.desi_union3]
        [--model w0wacdm] [--seeds 20] [--chains 128] [--warmup 800]
        [--device cuda]
    python3 tools/torch_warmup_sweep.py --suite [--seeds 20]

Measures the warmup seed-failure rate of ``cosmax_torch.samplers.HMCSampler``
on the fast path (one fused-kernel launch for the value of each gradient
evaluation): for each seed, a MAP + Laplace jittered start
(``map_jitter_init``), the warmup and a few draws. A warmup fails its health
check when more than 20% of the chains need the end-of-warmup
rejuvenation; the sampler then retries the warmup (at most twice).

Prints one line a seed (rejuvenated count, retries, divergent
trajectories, seconds, gradient evaluations a second) and one JSON
summary a posterior: the seeds whose first warmup failed the health check
(the seeds with retries: a retry fires iff the first warmup failed) and
the seeds still unhealthy after the retries.

``--suite`` sweeps the three distinct hard posteriors of the JAX tool: the
w0waCDM banana of the BAO + SN joint, the CMB-sharpened flagship, and the
nuisance-heavy CC + SN joint with its f_cc / H0 / r_d ridge.

Seed s seeds the start's normal draws (a CPU generator) with 2s and the
sampler with 2s + 1: torch's generators are not jax's, so the seeds match
the JAX tool's in number, not in draws. The
fit runs on ``--device`` (the card unless the caller asks for the CPU).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the three qualitatively distinct warmup stressors (see the module's doc)
SUITE = [
    ("bao.desi_union3", "w0wacdm"),   # the banana (historically worst)
    ("bao.desi_cmb_des5y", "lcdm"),   # flagship: CMB-sharpened joint
    ("cc.cc_union3", "lcdm"),         # nuisance-heavy: f_cc/H0/rd ridge
]


def sweep(preset, model, seeds, chains, warmup, samples, device="cuda"):
    """Sweep ``seeds`` seeds on one posterior; returns the summary dict
    (the JAX tool's keys, plus ``device``, ``gradient_evals_per_s`` over
    the sweep and ``per_seed``)."""
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.samplers import HMCSampler
    from cosmax_torch.samplers.optimize import map_jitter_init

    fit = get_preset(preset, model, fast=True, device=device)
    sampler = HMCSampler(fit.value_and_grad(), fit.spec.bounds, chains, dtype=fit.dtype,
                         device=fit.device)
    print(f"# {preset} [{model}], {chains} chains, warmup {warmup}, device {fit.device}")

    first_fail = 0
    exhausted = 0
    per_seed = []
    evals, seconds = 0, 0.0
    for seed in range(seeds):
        gen = torch.Generator()
        gen.manual_seed(2 * seed)
        initial = map_jitter_init(fit, gen, chains)
        sampler.n_grad_evals = 0
        t0 = time.perf_counter()
        _, chain = sampler.run(2 * seed + 1, samples, n_warmup=warmup, initial=initial)
        chain.samples[-1, :1].cpu()
        dt = time.perf_counter() - t0
        n_rej = sampler.n_rejuvenated
        n_ret = sampler.warmup_retries
        n_div = chain.n_divergent
        frac = n_rej / chains
        # a retry happened iff the FIRST warmup failed the health check
        first_fail += n_ret > 0
        exhausted += n_ret >= 2 and frac > 0.2
        evals += sampler.n_grad_evals
        seconds += dt
        print(f"seed {seed:2d}: rejuvenated {n_rej:4d}/{chains} ({frac:5.1%}), retries {n_ret}, "
              f"divergent {n_div}, {dt:.1f}s, {sampler.n_grad_evals} gradient evaluations "
              f"({sampler.n_grad_evals / dt:.1f}/s)", flush=True)
        per_seed.append(dict(seed=seed, rejuvenated=n_rej, retries=n_ret, divergent=n_div,
                             seconds=dt, gradient_evals=sampler.n_grad_evals))
    summary = {
        "preset": preset, "model": model,
        "seeds": seeds, "chains": chains,
        "warmup": warmup,
        "first_warmup_failures": first_fail,  # == seeds with retries
        "seeds_still_unhealthy_after_retries": exhausted,
        "device": str(fit.device),
        "gradient_evals_per_s": evals / seconds if seconds else None,
    }
    print(json.dumps(summary), flush=True)
    return dict(summary, per_seed=per_seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="bao.desi_union3")
    ap.add_argument("--model", default="w0wacdm")
    ap.add_argument("--suite", action="store_true", help="sweep all three stressor posteriors")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=800)
    ap.add_argument("--samples", type=int, default=8,
                    help="post-warmup draws (tiny: health is a warmup property)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    jobs = SUITE if args.suite else [(args.preset, args.model)]
    for preset, model in jobs:
        sweep(preset, model, args.seeds, args.chains, args.warmup, args.samples,
              device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
