"""Command-line entry point of the port (counterpart of ``cosmax/fit.py``).

Examples::

    python -m cosmax_torch.fit --preset bao.desi --model lcdm --device cuda
    python -m cosmax_torch.fit --preset bao.desi_cmb_des5y --model wzcdm \
        --steps 2200 --walkers 150 --seed 42 --out results/flagship --no-plots
    python -m cosmax_torch.fit --preset bao.desi_cmb_des5y --model wzcdm --fast
    python -m cosmax_torch.fit --preset bao.desi_cmb_des5y --model w0wacdm --fast
    python -m cosmax_torch.fit --preset joint.multiprobe --model w0wacdm --fast
    python -m cosmax_torch.fit --preset cc.cc --model lcdm --fast
    python -m cosmax_torch.fit --preset bao.desi_bbn --model lcdm --fast
    python -m cosmax_torch.fit --preset bao.desi_des5y --model w0wacdm --fast
    python -m cosmax_torch.fit --preset sn.pantheon_shoes --model wzcdm --fast
    python -m cosmax_torch.fit --preset qsr.des5y --model wzcdm --fast
    python -m cosmax_torch.fit --preset cmb.cmb --model lcdm --fast
    python -m cosmax_torch.fit --preset bao.desi --model lcdm --sampler hmc \
        --walkers 512 --steps 400 --warmup 200
    python -m cosmax_torch.fit --preset bao.desi_cmb_des5y --fast \
        --checkpoint run.npz --checkpoint-every 100
    python -m cosmax_torch.fit --list

``--fast`` takes every preset in every model (``cmb.cmb`` and
``cc.cc_cmb`` are lcdm whatever the model); ``--list`` prints each
preset with its note from the static index ``_preset_index.py``.

Takes the flags of ``cosmax.fit`` plus ``--device`` (default ``cuda``).
``--sampler hmc`` runs the gradient sampler (MAP-jitter init, warmup
``--warmup``, default the burn-in; its gradients by autograd, the values
on the fast path from the fused kernel); ``--checkpoint`` checkpoints
and resumes either sampler. Plots are not ported yet: ``--out`` without
``--no-plots`` raises and names the ROADMAP item. Prints the
reference-style summary block; with ``--out`` and ``--no-plots`` writes
summary.json and chain.npy.
"""

import argparse
import json
import os
import sys
import time

_NOT_PORTED = "is not ported yet (ROADMAP.md queue 1, item {})"


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="cosmax_torch.fit", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--preset", help="preset name, e.g. bao.desi")
    p.add_argument("--model", default="wzcdm",
                   choices=["lcdm", "wcdm", "wzcdm", "w0wacdm"])
    p.add_argument("--steps", type=int, default=None,
                   help="override preset n_steps (incl. burn-in)")
    p.add_argument("--walkers", type=int, default=None)
    p.add_argument("--burn-in", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--thin", type=int, default=1)
    p.add_argument("--moves", default=None, choices=[None, "reference", "stretch"],
                   help="override move mixture")
    p.add_argument("--sampler", default="ensemble", choices=["ensemble", "hmc"])
    p.add_argument("--warmup", type=int, default=None, help="hmc only")
    p.add_argument("--max-leapfrog", type=int, default=32, help="hmc only")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--fast", action="store_true",
                   help="emulated fast path: the fused log-prob kernel on the card")
    p.add_argument("--x64", action="store_true",
                   help="float64 parity mode (CPU only)")
    p.add_argument("--synthetic-sys", action="store_true",
                   help="add the deterministic synthetic systematic covariance "
                        "to SN datasets whose published one is absent")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--list", action="store_true", help="list presets")
    args = p.parse_args(argv)

    if args.list:
        # the static index: building the registry loads every dataset
        from cosmax_torch._preset_index import PRESET_NOTES

        for name in sorted(PRESET_NOTES):
            print(f"{name:28s} {PRESET_NOTES[name]}")
        return 0
    if not args.preset:
        p.error("--preset is required (or --list)")
    if args.out and not args.no_plots:
        raise NotImplementedError(
            "plots under --out " + _NOT_PORTED.format(13) + "; pass --no-plots"
        )

    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.report import format_summary, summarize
    from cosmax_torch.samplers import EnsembleSampler
    from cosmax_torch.samplers.ensemble import default_moves, stretch_only, uniform_init

    dtype = torch.float64 if args.x64 else None
    fit = get_preset(args.preset, args.model, fast=args.fast,
                     synthetic_sys=args.synthetic_sys, device=args.device, dtype=dtype)
    n_walkers = args.walkers if args.walkers is not None else fit.n_walkers
    n_steps = args.steps if args.steps is not None else fit.n_steps
    burn_in = args.burn_in if args.burn_in is not None else fit.burn_in
    if burn_in >= n_steps and args.burn_in is None and args.sampler == "ensemble":
        # a --steps override below the preset's burn-in would keep no
        # samples: scale the preset's burn-in down (an explicit
        # --burn-in is kept as given and fails below). HMC's warmup is
        # separate from its recorded draws and keeps the burn-in as given.
        burn_in = n_steps // 2
        print(f"# --steps {n_steps} <= preset burn-in {fit.burn_in}: "
              f"clamping burn-in to {burn_in}")
    if burn_in >= n_steps and args.sampler == "ensemble":
        p.error(f"--burn-in {burn_in} must be < steps ({n_steps}): "
                "no samples would remain")
    if n_walkers < 4:
        p.error(f"--walkers must be >= 4 (got {n_walkers})")
    if n_steps < 1:
        p.error(f"--steps must be >= 1 (got {n_steps})")
    if args.thin < 1:
        p.error(f"--thin must be >= 1 (got {args.thin})")
    if args.checkpoint_every < 1:
        p.error(f"--checkpoint-every must be >= 1 (got {args.checkpoint_every})")
    seed = args.seed if args.seed is not None else (fit.seed or 0)
    moves = (
        stretch_only() if args.moves == "stretch"
        else default_moves() if args.moves == "reference"
        else fit.moves
    )
    if n_walkers % 2:
        n_walkers += 1

    print(f"# {fit.name} [{fit.model}]  {fit.note}")
    print(f"# params: {', '.join(fit.spec.names)}")
    device_name = (
        torch.cuda.get_device_name(fit.device) if fit.device.type == "cuda" else "cpu"
    )
    on = (f"device: {fit.device} ({device_name}), dtype {fit.dtype}"
          f"{', fast path' if fit.fast else ''}")
    if args.sampler == "hmc":
        chain, summary = _run_hmc(args, fit, n_walkers, n_steps, burn_in, seed, on)
        if chain is None:
            return 0
        discard = 0
    else:
        print(f"# {n_walkers} walkers x {n_steps} steps (burn-in {burn_in}), "
              f"seed {seed}, {on}")
        sampler = EnsembleSampler(fit.log_prob(), n_walkers, fit.spec.dim, moves=moves)
        gen = torch.Generator(device=fit.device)
        gen.manual_seed(seed)
        initial = uniform_init(gen, fit.spec.bounds, n_walkers, fit.dtype, fit.device)

        t0 = time.perf_counter()
        start_step = 0
        if args.checkpoint:
            from cosmax_torch.samplers.checkpoints import run_with_checkpoints

            state, chain, start_step = run_with_checkpoints(
                sampler, seed + 1, initial, n_steps, args.checkpoint,
                every=args.checkpoint_every, thin=args.thin,
            )
            if chain is None:
                print("# checkpoint already covers the requested steps; nothing to do")
                return 0
            if start_step:
                print(f"# resumed from step {start_step}; chain holds the "
                      f"post-resume segments only")
        else:
            state, chain = sampler.run(initial, n_steps, seed=seed + 1, thin=args.thin)
        chain.samples.cpu()  # waits for the device
        dt = time.perf_counter() - t0
        evals = (n_steps - start_step) * n_walkers
        print(f"# sampled {evals} log-prob evals in {dt:.1f}s ({evals / dt:.0f} evals/s)")

        # burn-in is an absolute step count; offset by what a resumed
        # chain already skipped (the merged chain starts at start_step)
        discard = max(0, burn_in - start_step) // args.thin
        summary = summarize(fit, chain, discard=discard)
        summary["walltime_sec"] = dt
        summary["evals_per_sec"] = evals / dt
    summary["device"] = device_name
    print(format_summary(summary))

    if args.out:
        import numpy as np

        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2, default=float)
        np.save(os.path.join(args.out, "chain.npy"), chain.samples.cpu().numpy()[discard:])
        print(f"# wrote {args.out}/summary.json, chain.npy")
    return 0


def _run_hmc(args, fit, n_chains, n_steps, burn_in, seed, on):
    """The ``--sampler hmc`` branch: (chain, summary), or (None, None)
    when a checkpoint already covers the run."""
    import numpy as np
    import torch

    from cosmax_torch.report import summarize
    from cosmax_torch.samplers.diagnostics import split_gelman_rubin
    from cosmax_torch.samplers.ensemble import uniform_init
    from cosmax_torch.samplers.hmc import HMCSampler
    from cosmax_torch.samplers.optimize import map_jitter_init

    warmup = args.warmup if args.warmup is not None else burn_in
    n_record = max(1, n_steps - burn_in)
    print(f"# hmc: {n_chains} chains x {n_record} samples (warmup {warmup}), seed {seed}, {on}")
    sampler = HMCSampler(fit.value_and_grad(), fit.spec.bounds, n_chains,
                         max_leapfrog=args.max_leapfrog, dtype=fit.dtype, device=fit.device)
    gen = torch.Generator()
    gen.manual_seed(seed)
    try:
        # MAP + Laplace-covariance jitter: robust for the posteriors that
        # occupy ~1e-4 of the box (see map_jitter_init)
        initial = map_jitter_init(fit, gen, n_chains)
    except (ValueError, RuntimeError, np.linalg.LinAlgError) as e:
        print(f"# map init failed ({e}); falling back to uniform")
        initial = uniform_init(gen, fit.spec.bounds, n_chains, fit.dtype).to(fit.device)
    t0 = time.perf_counter()
    start = 0
    if args.checkpoint:
        from cosmax_torch.samplers.checkpoints import run_hmc_with_checkpoints

        state, chain, start = run_hmc_with_checkpoints(
            sampler, seed + 1, n_record, args.checkpoint, every=args.checkpoint_every,
            n_warmup=warmup, initial=initial,
        )
        if chain is None:
            print("# checkpoint already covers the requested steps; nothing to do")
            return None, None
        if start:
            print(f"# resumed from recorded draw {start}; chain holds the post-resume "
                  "segments only")
    else:
        state, chain = sampler.run(seed + 1, n_record, n_warmup=warmup, initial=initial)
    chain.samples.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    div_per_chain = chain.divergences_per_chain.cpu().numpy()
    n_div = int(div_per_chain.sum())
    print(f"# sampled {n_record - start} post-warmup steps in {dt:.1f}s, "
          f"{sampler.n_grad_evals} gradient evaluations of {n_chains} chains "
          f"({sampler.n_grad_evals / dt:.1f}/s; step size {np.max(sampler.step_size):.4g}, "
          f"divergent trajectories {n_div} "
          f"across {int((div_per_chain > 0).sum())} chains, warmup retries "
          f"{sampler.warmup_retries}, rejuvenated chains {sampler.n_rejuvenated})")
    if sampler.warmup_retries:
        print(f"# WARNING: warmup needed {sampler.warmup_retries} "
              f"retr{'y' if sampler.warmup_retries == 1 else 'ies'} (ensemble escaped "
              "during adaptation); inspect split R-hat before trusting the run")
    summary = summarize(fit, chain, discard=0)
    summary["walltime_sec"] = dt
    summary["sampler"] = {
        "kind": "hmc",
        "step_size": np.asarray(sampler.step_size).tolist(),
        "inv_mass": np.asarray(sampler.inv_mass).tolist(),
        "divergent_trajectories": n_div,
        "divergences_per_chain": div_per_chain.tolist(),
        "split_gelman_rubin": split_gelman_rubin(chain.samples.cpu().numpy()).tolist(),
        "rejuvenated_chains": int(sampler.n_rejuvenated),
        "warmup_retries": sampler.warmup_retries,
        "gradient_evals": sampler.n_grad_evals,
    }
    return chain, summary


if __name__ == "__main__":
    sys.exit(main())
