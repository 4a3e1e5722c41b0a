#!/usr/bin/env python3
"""The float32 error of the JAX package's own fast path, on the CPU, at the
walkers where ``chip_smoke.py`` phase 16 reads the port's kernel.

    python3 reference_f32_error.py [PRESET ...]

For each preset of ``chip_smoke.QSR_PUBLISHED`` (qsr.desi, qsr.des5y_desi)
in w0wacdm: the reference's fast build and evaluation in float32 (x64 off,
the precision it runs in on a TPU) against the same in float64, on the
4,096 float32 walkers within 1% of the box about the published point
(``chip_smoke.published_walkers``), as max|f32 - f64| over max|f64| of the
whole logp and of the BAO term's -chi^2/2 alone. Phase 16 prints the
port's kernel and plain version against the port's f64 CPU fast path on
the same walkers. A measurement on the CPU, nothing held; JAX never runs
on a card here.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

from chip_smoke import QSR_PUBLISHED, published_walkers  # noqa: E402
from cosmax.configs import get_preset  # noqa: E402


def _evaluate(name, x64, walkers=None):
    """(walkers, whole logp, BAO -chi^2/2) of the fast build, float64 out."""
    with jax.enable_x64(x64):
        fit = get_preset(name, "w0wacdm", fast=True, synthetic_sys=True)
        if walkers is None:
            walkers = published_walkers(fit)
        theta = jnp.asarray(walkers.astype(np.float64) if x64 else walkers)
        lp = jax.jit(jax.vmap(fit.log_prob()))(theta)
        bao = jax.jit(jax.vmap(fit.chi2_breakdown()))(theta)["bao"]
        return walkers, np.asarray(lp, np.float64), -0.5 * np.asarray(bao, np.float64)


def main(names):
    for name in names:
        t0 = time.perf_counter()
        with threadpool_limits(1):
            walkers, lp64, bao64 = _evaluate(name, True)
            _, lp32, bao32 = _evaluate(name, False, walkers)
        gaps = [float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                for a, b in ((lp32, lp64), (bao32, bao64))]
        print(f"{name}/w0wacdm, JAX fast path on the CPU, f32 vs f64 at {len(walkers)} "
              f"published-point walkers (of max|logp|): whole {gaps[0]:.3e}, bao alone "
              f"{gaps[1]:.3e}; all finite {bool(np.isfinite(lp32).all())}; "
              f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(QSR_PUBLISHED)))
