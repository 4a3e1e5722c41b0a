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
and resumes either sampler. Prints the reference-style summary block
(with the derived parameters and the residual statistics). With
``--out`` it writes summary.json, chain.npy and, for each SN term, the
interactive Hubble diagram ``predictions_<term>.html`` (numpy only); and
unless ``--no-plots``, corner.png, trace.png and ``predictions_<term>.png``
for each SN, BAO and CC term, with matplotlib. Where matplotlib cannot be
imported, ``--out`` without ``--no-plots`` fails before anything is built
or sampled.
"""

import argparse
import json
import os
import sys
import time


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
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            p.error(f"--out without --no-plots draws its figures with matplotlib, which "
                    f"cannot be imported here ({e}); pass --no-plots")

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
        _write_outputs(args, fit, chain, summary, discard)
    return 0


def _write_outputs(args, fit, chain, summary, discard):
    """summary.json, chain.npy, the SN terms' HTML Hubble diagrams and,
    unless ``--no-plots``, the corner, trace and prediction figures."""
    import numpy as np

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    samples = chain.samples.cpu().numpy()
    np.save(os.path.join(args.out, "chain.npy"), samples[discard:])
    if not args.no_plots:
        import matplotlib.pyplot as plt

        from cosmax_torch.report import plots

        names = list(fit.spec.names)
        flat = samples[discard:].reshape(-1, samples.shape[-1])
        for fig, name, dpi in ((plots.corner(flat, labels=names), "corner.png", 120),
                               (plots.trace(samples, labels=names), "trace.png", 100)):
            fig.savefig(os.path.join(args.out, name), dpi=dpi)
            plt.close(fig)
    written = _predictions(fit, summary, args.out, plots=not args.no_plots)
    print(f"# wrote {args.out}/summary.json, chain.npy"
          + ("" if args.no_plots else ", corner.png, trace.png")
          + "".join(f", {w}" for w in written))


def _predictions(fit, summary, out_dir, plots=True):
    """Per-probe predictions at the posterior median: each SN term's
    interactive Hubble diagram (HTML, numpy only) and, with ``plots``,
    each SN, BAO and CC term's prediction and residual figure (the
    reference's plot_predictions / plot_bao_predictions /
    plot_cc_predictions panels). The theory comes from the terms' hooks
    on the fit's device. One panel's failure is printed and does not
    stop the others or the finished fit. Returns the files written."""
    import numpy as np

    from cosmax_torch.report.html import hubble_diagram_html
    from cosmax_torch.report.summary import at_medians, residual_theory

    if plots:
        from cosmax_torch.report import plots as figs
    medians = np.array([summary["params"][n]["median"] for n in fit.spec.names])
    p = at_medians(fit, medians)
    written = []
    for term in fit.terms:
        kind = term.meta.get("plot_kind")
        if kind not in ("sn", "bao", "cc") or (kind != "sn" and not plots):
            continue
        title = str(term.meta.get("legend", term.name))
        z, values, errors = term.meta["z"], term.meta["values"], term.meta["errors"]
        try:
            if kind == "sn":
                order = np.argsort(z)
                theory = residual_theory(term, p)
                # the interactive counterpart of the reference's
                # CheckButtons error-bar toggle (sn/plotting.py:29-40)
                name = f"predictions_{term.name}.html"
                hubble_diagram_html(z, values, errors, z[order], theory[order],
                                    os.path.join(out_dir, name), title=title)
                written.append(name)
                if not plots:
                    continue
                fig = figs.predictions_sn(z, values, errors, z[order], theory[order], title=title)
            elif kind == "bao":
                curve = term.meta["theory_curve"]
                fig = figs.predictions_bao(
                    z, values, errors, term.meta["quantity"],
                    lambda zg, q: curve(p, zg, q)[0].detach().cpu().double().numpy(),
                    title=title,
                )
            else:
                zg = np.linspace(0.0, float(z.max()) * 1.05, 200)
                h = term.meta["theory_curve"](p, zg)[0].detach().cpu().double().numpy()
                fig = figs.predictions_cc(z, values, errors, zg, h, title=title)
            name = f"predictions_{term.name}.png"
            fig.savefig(os.path.join(out_dir, name), dpi=120)
            figs.plt.close(fig)
            written.append(name)
        except Exception as e:  # one panel must never kill a finished fit
            print(f"# prediction plot for {term.name} failed: {e}")
    return written


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
        initial = uniform_init(gen, fit.spec.bounds, n_chains, fit.dtype, "cpu").to(fit.device)
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
