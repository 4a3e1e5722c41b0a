"""GP reconstruction of H(z): ``python -m cosmax_torch.gp [--out DIR]``
(counterpart of ``python -m cosmax.gp``).

Replaces the reference's ``python cosmic_chronometers/cc_gp.py`` (5000
Adam iterations; cc_gp_Hz.png / cc_gp_qz.png, cc_gp.py:96-134). Runs on
the card unless ``--device cpu``. Writes ``gp_summary.json`` first, then
the three figures with matplotlib: where matplotlib cannot be imported
the numbers are written and the command fails, naming it.
"""

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="results/cc_gp")
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--grid", type=int, default=100)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    import numpy as np

    from cosmax_torch.data import load_cc
    from cosmax_torch.gp import reconstruct_hz

    ds = load_cc()
    out = reconstruct_hz(ds.z, ds.values, ds.cov, n_grid=args.grid, iters=args.iters,
                         device=args.device)
    info = out["info"]
    print(
        f"outputscale={info['outputscale']:.1f}  "
        f"lengthscale={info['lengthscale']:.3f}  "
        f"noise_scale={info['noise_scale']:.4f}"
    )
    print(f"GP H0 = {out['h_mean'][0]:.1f} +- {out['h_std'][0]:.1f} km/s/Mpc")
    print(f"q(0) = {out['q'][0]:.3f}")

    os.makedirs(args.out, exist_ok=True)
    z, hm, hs = out["z_grid"], out["h_mean"], out["h_std"]
    with open(os.path.join(args.out, "gp_summary.json"), "w") as f:
        json.dump(
            dict(
                outputscale=info["outputscale"],
                lengthscale=info["lengthscale"],
                noise_scale=info["noise_scale"],
                H0=float(hm[0]),
                H0_sigma=float(hs[0]),
                q0=float(out["q"][0]),
            ),
            f,
            indent=2,
        )
    print(f"wrote {args.out}/gp_summary.json")
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"the figures need matplotlib, which cannot be imported here ({e})")

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # H(z) band plot (cc_gp.py:108-128)
    scale = info["noise_scale"]
    plt.figure(figsize=(8, 5))
    plt.errorbar(
        ds.z, ds.values, yerr=np.sqrt(np.diag(ds.cov) * scale), fmt=".",
        capsize=2, label="CCH",
    )
    plt.plot(z, hm, label="GP mean")
    plt.fill_between(z, hm - hs, hm + hs, alpha=0.5, label=r"$1\sigma$")
    plt.fill_between(z, hm - 2 * hs, hm + 2 * hs, alpha=0.3, label=r"$2\sigma$")
    plt.xlabel("z")
    plt.ylabel("H(z) [km/s/Mpc]")
    plt.title(f"GP $H_0$: {hm[0]:.1f} ± {hs[0]:.1f} km/s/Mpc")
    plt.legend()
    plt.grid(True)
    plt.savefig(os.path.join(args.out, "cc_gp_Hz.png"), dpi=150)
    plt.close()

    # q(z) plot (cc_gp.py:96-105)
    plt.figure(figsize=(8, 5))
    plt.plot(z, out["q"], label="GP q(z)")
    plt.axhline(0, color="gray", linestyle="--")
    plt.xlabel("z")
    plt.ylabel("q(z)")
    plt.title("Deceleration parameter from GP")
    plt.legend()
    plt.grid(True)
    plt.savefig(os.path.join(args.out, "cc_gp_qz.png"), dpi=150)
    plt.close()

    # predictive-covariance heatmap (cc_gp.py:130-134)
    plt.figure(figsize=(6, 5))
    plt.imshow(out["h_cov"], cmap="hot", interpolation="none")
    plt.colorbar()
    plt.title("Covariance Matrix")
    plt.savefig(os.path.join(args.out, "cc_gp_cov.png"), dpi=150)
    plt.close()
    print(f"wrote {args.out}/cc_gp_Hz.png, cc_gp_qz.png, cc_gp_cov.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
