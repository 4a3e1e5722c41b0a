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
    python -m cosmax_torch.fit --list

``--fast`` takes every preset in every model (``cmb.cmb`` and
``cc.cc_cmb`` are lcdm whatever the model); ``--list`` prints each
preset with its note from the static index ``_preset_index.py``.

Takes the flags of ``cosmax.fit`` plus ``--device`` (default ``cuda``).
Flags whose code is not ported yet raise and name the ROADMAP item.
Prints the reference-style summary block; with ``--out`` and
``--no-plots`` writes summary.json and chain.npy.
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
    if args.sampler == "hmc":
        raise NotImplementedError("--sampler hmc " + _NOT_PORTED.format(11))
    if args.checkpoint:
        raise NotImplementedError("--checkpoint " + _NOT_PORTED.format(11))
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
    if burn_in >= n_steps and args.burn_in is None:
        # a --steps override below the preset's burn-in would keep no
        # samples: scale the preset's burn-in down (an explicit
        # --burn-in is kept as given and fails below)
        burn_in = n_steps // 2
        print(f"# --steps {n_steps} <= preset burn-in {fit.burn_in}: "
              f"clamping burn-in to {burn_in}")
    if burn_in >= n_steps:
        p.error(f"--burn-in {burn_in} must be < steps ({n_steps}): "
                "no samples would remain")
    if n_walkers < 4:
        p.error(f"--walkers must be >= 4 (got {n_walkers})")
    if n_steps < 1:
        p.error(f"--steps must be >= 1 (got {n_steps})")
    if args.thin < 1:
        p.error(f"--thin must be >= 1 (got {args.thin})")
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
    print(f"# {n_walkers} walkers x {n_steps} steps (burn-in {burn_in}), "
          f"seed {seed}, device: {fit.device} ({device_name}), dtype {fit.dtype}"
          f"{', fast path' if fit.fast else ''}")

    sampler = EnsembleSampler(fit.log_prob(), n_walkers, fit.spec.dim, moves=moves)
    gen = torch.Generator(device=fit.device)
    gen.manual_seed(seed)
    initial = uniform_init(gen, fit.spec.bounds, n_walkers, fit.dtype, fit.device)

    t0 = time.perf_counter()
    state, chain = sampler.run(initial, n_steps, seed=seed + 1, thin=args.thin)
    samples_host = chain.samples.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    evals = n_steps * n_walkers
    print(f"# sampled {evals} log-prob evals in {dt:.1f}s ({evals / dt:.0f} evals/s)")

    discard = burn_in // args.thin
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
        np.save(os.path.join(args.out, "chain.npy"), samples_host.numpy()[discard:])
        print(f"# wrote {args.out}/summary.json, chain.npy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
