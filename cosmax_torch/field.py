"""Quintessence-reconstruction figures: ``python -m cosmax_torch.field``
(counterpart of ``python -m cosmax.field``).

Replaces the reference's offline ``python field.py`` visualisation
(field.py:41-104): given best-fit (Om, w0) from a wzCDM fit — the
reference hard-codes its BAO+CC+DES5Y result Om=0.307, w0=-0.833
(field.py:13-15) — reconstruct the scalar field and write the five
figures: phi(a), V(phi), V(a), the kinetic term vs cosmic time, and
phi(t).

Best-fit values can also be pulled from a ``summary.json`` written by
``python -m cosmax_torch.fit --out`` (``--summary DIR_OR_FILE``). The
reconstruction runs on the card unless ``--device cpu``; the figures need
matplotlib.
"""

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--om", type=float, default=0.307,
                   help="matter density (reference field.py:13)")
    p.add_argument("--w0", type=float, default=-0.833,
                   help="wzCDM equation-of-state parameter (field.py:15)")
    p.add_argument("--or", dest="o_r", type=float, default=4e-5,
                   help="radiation density (field.py:14)")
    p.add_argument("--summary", default=None,
                   help="summary.json (or its directory) from a "
                        "cosmax_torch fit; overrides --om/--w0 with the "
                        "posterior medians")
    p.add_argument("--out", default="results/field")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    om, w0 = args.om, args.w0
    if args.summary:
        path = args.summary
        if os.path.isdir(path):
            path = os.path.join(path, "summary.json")
        with open(path) as f:
            summ = json.load(f)
        params = summ["params"]
        om = params["Om"]["median"]
        if "w0" not in params:
            raise SystemExit(
                "the summary has no w0 — quintessence reconstruction "
                "needs a wzCDM fit (--model wzcdm)"
            )
        w0 = params["w0"]["median"]
        print(f"# using posterior medians from {path}: Om={om:.4f}, w0={w0:.4f}")

    if w0 <= -1.0:
        raise SystemExit(
            f"w0 = {w0:.4f} <= -1: the quintessence reconstruction is "
            "undefined for phantom dark energy — dphi/da ~ sqrt(rho (1+w)) "
            "needs 1 + w(a) > 0 (field.py reconstructs the reference's "
            "BAO+CC+DES5Y best fit w0 = -0.833). Pass a non-phantom w0."
        )

    import numpy as np
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cosmax_torch.models.scalar_field import reconstruct

    rec = reconstruct(om, w0, o_r=args.o_r, device=args.device)
    a, phi, t = rec["a"], rec["phi"], rec["t"]
    os.makedirs(args.out, exist_ok=True)

    def fig():
        return plt.figure(figsize=(8, 5))

    def save(name):
        plt.legend()
        plt.grid(True)
        plt.savefig(os.path.join(args.out, name), dpi=150)
        plt.close()

    # phi(a) (field.py:41-53)
    fig()
    plt.plot(a, phi, label=r"$\phi(a)$")
    plt.axvline(x=1, color="r", linestyle="--", label="Current time")
    plt.xlabel(r"$a$")
    plt.ylabel(r"$\phi(a)$")
    plt.xlim(0, 2)
    plt.ylim(0, float(phi.max()))
    plt.title(r"Scalar Field $\phi(a)$")
    save("field_phi_a.png")

    # V(phi) (field.py:55-63)
    fig()
    plt.plot(rec["phi_grid"], rec["v_of_phi"], label=r"$V(\phi)$")
    plt.xlabel(r"$\phi$")
    plt.ylabel(r"$V(\phi)$")
    plt.title(r"Scalar Field Potential $V(\phi)$")
    save("field_v_phi.png")

    # V(a) (field.py:65-72)
    fig()
    plt.plot(a, rec["v_of_a"], label=r"$V(a)$")
    plt.xlabel(r"$a$")
    plt.ylabel(r"$V(a)$")
    plt.title(r"Scalar Field Potential $V(a)$")
    save("field_v_a.png")

    # kinetic term vs t (field.py:80-95)
    kin = 0.5 * rec["dphi_dt"] ** 2
    fig()
    plt.plot(t, kin, label="Kinetic term")
    plt.axvline(x=t[int(np.argmax(kin))], color="g", linestyle="--",
                label="Max speed", alpha=0.5)
    plt.xlabel("t")
    plt.ylabel(r"0.5 $\left(\frac{d\phi}{dt}\right)^2$")
    plt.title(r"Scalar Field Kinetic Term $\left(\frac{d\phi}{dt}\right)^2$")
    save("field_kinetic_t.png")

    # phi(t) (field.py:98-104)
    t_grid = np.linspace(float(t.min()), float(t.max()), 1000)
    fig()
    plt.plot(t_grid, np.interp(t_grid, t, phi), label=r"$\phi(t)$")
    plt.xlabel(r"$t$")
    plt.ylabel(r"$\phi(t)$")
    plt.title(r"Scalar Field $\phi$ vs Time $t$")
    save("field_phi_t.png")

    print(f"wrote {args.out}/field_phi_a.png, field_v_phi.png, "
          "field_v_a.png, field_kinetic_t.png, field_phi_t.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
