"""Quadrature primitives (counterpart of ``cosmax/ops/quadrature.py``).

Nodes, weights and trapezoid grids are built once in float64 numpy and
turned into tensors when a term is built; evaluation is an elementwise
integrand pass plus a weighted reduction (or a ``cumsum``) on the last
axis, with any leading walker axes broadcast.
"""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def gauss_legendre(order: int):
    """(nodes, weights) on [-1, 1], float64 numpy, cached."""
    x, w = np.polynomial.legendre.leggauss(order)
    return x, w


def gl_nodes_01(order: int):
    """(nodes, weights) rescaled to [0, 1]."""
    x, w = gauss_legendre(order)
    return 0.5 * (x + 1.0), 0.5 * w


def gl_integrate_01(f, order: int, dtype=None, device="cuda"):
    """integral_0^1 f(t) dt with an order-``order`` GL rule, the nodes a
    ``dtype`` tensor on ``device`` (float32 on the card by default).
    ``f`` takes the nodes [order]; for parameter batches, close over the
    batch and let the integrand broadcast (nodes on the last axis)."""
    from cosmax_torch.device import resolve

    device, dtype = resolve(device, dtype)
    t, w = gl_nodes_01(order)
    t = torch.as_tensor(t, device=device).to(dtype)
    w = torch.as_tensor(w, device=device).to(dtype)
    return torch.sum(f(t) * w, dim=-1)


def cumtrapz(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cumulative trapezoid along the last axis with initial=0, matching
    ``scipy.integrate.cumulative_trapezoid(y, x, initial=0)``; one
    ``torch.cumsum``."""
    dx = torch.diff(x.to(y.dtype))
    seg = 0.5 * dx * (y[..., 1:] + y[..., :-1])
    zero = torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
    return torch.cat([zero, torch.cumsum(seg, dim=-1)], dim=-1)


def trapz_grid_weights(z_points, n_base: int, dynamic: bool = True):
    """Padded (grid, weights) reproducing the reference's per-point
    trapezoid rule ``np.trapz(f(x), x)`` with
    ``x = np.linspace(0, z_i, max(n_base, int(n_base * z_i)))``.

    Returns float64 numpy ``grid[N, L]`` and ``w[N, L]``; padding weights
    are 0 and padding nodes repeat the endpoint, so the integrand stays
    finite. ``dynamic=False`` gives every row exactly ``n_base`` points.
    """
    z_points = np.atleast_1d(np.asarray(z_points, dtype=np.float64))
    if dynamic:
        sizes = [max(n_base, int(n_base * z)) for z in z_points]
    else:
        sizes = [n_base for _ in z_points]
    L = max(sizes)
    grid = np.zeros((len(z_points), L), dtype=np.float64)
    w = np.zeros((len(z_points), L), dtype=np.float64)
    for i, (z, m) in enumerate(zip(z_points, sizes)):
        x = np.linspace(0.0, z, num=m)
        grid[i, :m] = x
        grid[i, m:] = x[-1]
        dx = np.diff(x)
        wi = np.zeros(m)
        wi[:-1] += 0.5 * dx
        wi[1:] += 0.5 * dx
        w[i, :m] = wi
    return grid, w


def interp_weights(x, xp):
    """Build-time (index, weight) for linear interpolation at static
    points ``x`` on a static ascending grid ``xp``, reproducing
    ``jnp.interp``: ``i = clip(searchsorted(xp, x, 'right'), 1, len-1)``,
    so a point on the right endpoint lerps the last interval with
    weight 1. Points outside the grid clamp to its end values.
    Returns int64 ``i`` and float64 ``t`` with
    ``f(x) = fp[i-1] + t * (fp[i] - fp[i-1])``."""
    x = np.asarray(x, dtype=np.float64)
    xp = np.asarray(xp, dtype=np.float64)
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    t = np.where(dx == 0.0, 0.0, (x - xp[i - 1]) / np.where(dx == 0.0, 1.0, dx))
    t = np.where(x < xp[0], 0.0, t)
    t = np.where(x > xp[-1], 1.0, t)
    i = np.where(x < xp[0], 1, i)
    return i.astype(np.int64), t


def interp_apply(fp: torch.Tensor, idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp[..., M]`` with precomputed
    ``interp_weights``: two gathers and one FMA per point."""
    lo = fp[..., idx - 1]
    return lo + t * (fp[..., idx] - lo)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp`` on the ascending grid ``xp`` at the
    points ``x`` (1-D tensors), the torch counterpart of ``jnp.interp`` /
    ``np.interp``: ``i = clip(searchsorted(xp, x, 'right'), 1, len-1)``,
    an interval of zero width (|dx| at most the spacing of eps) takes its
    left value, and points outside the grid clamp to its end values."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    flat = torch.abs(dx) <= np.spacing(torch.finfo(xp.dtype).eps)
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, torch.ones_like(dx), dx))
                    * (fp[i] - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
