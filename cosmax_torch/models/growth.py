"""Linear growth of structure for the fsigma8 likelihood (counterpart of
``cosmax/models/growth.py``).

The reference's growth system, including its simplification dH^2/da =
-3 Om / a^4 (the matter-only derivative of E^2, even for evolving dark
energy; fs8/fs8.py:41), which parity requires keeping:

    delta''(a) = -(3/a + H'/H) delta' + (3/2) (Om / a^5) / E^2 * delta

integrated by RK4 on a in logspace(-3, 0, 1000) from y0 = [a0, 1] with
4 substeps per interval; fsigma8(z) = sigma8 * a * delta'(a) / delta(1)
with linear interpolation on the same grid (fs8/fs8.py:63-69).

The system is linear in y with coefficients that depend on a and the
parameters only, so they are evaluated once for every time the RK4 loop
visits (one batched E^2 over [times, W]); the loop itself then costs a
few walker-batched operations a stage.
"""

import numpy as np
import torch

from cosmax_torch.models.background import e2_of_z
from cosmax_torch.ops.ode import rk4, rk4_times
from cosmax_torch.ops.quadrature import interp_apply, interp_weights

A_GRID = np.logspace(-3.0, 0.0, 1000)
SUBSTEPS = 4  # RK4 steps per interval of A_GRID


def growth_solution(params, model):
    """Integrate the growth ODE on ``A_GRID`` for [W] walker parameters
    (``Om``, the dark-energy parameters, and ``Or`` when present).
    Returns (a_grid [n] numpy, delta [W, n], ddelta_da [W, n])."""
    a_grid = A_GRID
    om = params["Om"]
    times = rk4_times(a_grid, SUBSTEPS)
    col = {t: i for i, t in enumerate(times)}
    # the times down the first axis and the walkers along the second, so
    # that each time's coefficients are one contiguous [W] row
    a = torch.as_tensor(np.asarray(times), device=om.device).to(om.dtype)[:, None]
    e2 = e2_of_z(1.0 / a - 1.0, params, model)  # [times, W]
    dhh_da = -3.0 * om / a**4  # reference fs8/fs8.py:41
    hprime_over_h = 0.5 * dhh_da / e2
    c1 = (-(3.0 / a + hprime_over_h)).unbind(0)
    c2 = (1.5 * (om / a**5) / e2).unbind(0)

    def rhs(t, y):
        j = col[t]
        y0, y1 = y.unbind(-1)
        return torch.stack([y1, torch.addcmul(c2[j] * y0, c1[j], y1)], dim=-1)

    y0 = torch.stack([torch.full_like(om, float(a_grid[0])), torch.ones_like(om)], dim=-1)
    ys = rk4(rhs, y0, a_grid, substeps=SUBSTEPS)  # [W, n, 2]
    return a_grid, ys[..., 0], ys[..., 1]


def growth_elems_per_walker() -> int:
    """Elements of the largest per-walker temporary of
    :func:`growth_solution` (the coefficient tables over the RK4 times)."""
    return len(rk4_times(A_GRID, SUBSTEPS))


def growth_curve(z, params, model):
    """a * delta'(a) / delta(a=1) at static redshifts ``z`` (numpy) for
    [W] walker parameters -> [W, len(z)]: fsigma8 / sigma8."""
    a_grid, delta, ddelta = growth_solution(params, model)
    a_z = 1.0 / (1.0 + np.asarray(z, dtype=np.float64))
    idx, t = interp_weights(a_z, a_grid)
    dev = delta.device
    dd = interp_apply(
        ddelta, torch.as_tensor(idx, device=dev), torch.as_tensor(t, device=dev).to(delta.dtype)
    )
    return torch.as_tensor(a_z, device=dev).to(delta.dtype) * dd / delta[:, -1:]


def fsigma8(z, params, model):
    """fsigma8(z) = sigma8 * a * delta'(a) / delta(a=1) -> [W, len(z)]
    (reference fs8/fs8.py:65-69). params needs 'Om', 'sigma8' (+ DE)."""
    return params["sigma8"][:, None] * growth_curve(z, params, model)
