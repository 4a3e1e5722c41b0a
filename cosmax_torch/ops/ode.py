"""Fixed-step RK4 on a static grid (counterpart of ``cosmax/ops/ode.py``).

The reference replaced scipy's adaptive ``solve_ivp`` (fs8/fs8.py:52-59)
with classic RK4 on a static grid and a fixed number of substeps per
interval; the port keeps the grid and the substeps. The state carries a
leading walker axis ([W, n]); the loop over the grid is a plain Python
loop, one step after another, as ``lax.scan`` runs it.
"""

import numpy as np
import torch


def _steps(ts, substeps: int):
    """(t0, dt) of every RK4 step along the static grid ``ts``, in order:
    each interval split into ``substeps`` equal steps."""
    ts = np.asarray(ts, dtype=np.float64)
    for t0, t1 in zip(ts[:-1].tolist(), ts[1:].tolist()):
        dt = (t1 - t0) / substeps
        for i in range(substeps):
            yield t0 + i * dt, dt


def rk4_times(ts, substeps: int = 4) -> list:
    """The distinct times at which :func:`rk4` evaluates ``f``, in the
    order of first use, as the same Python floats; a right-hand side
    whose coefficients depend on t alone can tabulate them once."""
    seen = {}
    for t0, dt in _steps(ts, substeps):
        for t in (t0, t0 + dt / 2, t0 + dt):
            seen.setdefault(t, None)
    return list(seen)


def rk4(f, y0: torch.Tensor, ts, substeps: int = 4) -> torch.Tensor:
    """Classic RK4 along the static grid ``ts`` (1-D, numpy); each grid
    interval is split into ``substeps`` steps. ``f(t, y) -> dy/dt`` takes
    t as a Python float and y [..., n]. Returns y at every grid point,
    [..., len(ts), n]."""
    out = [y0]
    y = y0
    for k, (t0, dt) in enumerate(_steps(ts, substeps)):
        k1 = f(t0, y)
        k2 = f(t0 + dt / 2, torch.add(y, k1, alpha=dt / 2))
        k3 = f(t0 + dt / 2, torch.add(y, k2, alpha=dt / 2))
        k4 = f(t0 + dt, torch.add(y, k3, alpha=dt))
        # y + dt/6 (k1 + 2 k2 + 2 k3 + k4), in four operations
        y = torch.add(y, torch.add(k1 + k4, k2 + k3, alpha=2), alpha=dt / 6)
        if (k + 1) % substeps == 0:
            out.append(y)
    return torch.stack(out, dim=-2)
