"""Background distances (counterpart of ``cosmax/models/distances.py``).

Redshifts are static tensors on the trailing axes; walker parameters
carry a leading batch axis and are expanded to broadcast against them.

* ``comoving_distance_trapz`` — the parity path: the reference's padded
  per-point trapezoid grids (``ops.quadrature.trapz_grid_weights``).
* ``make_prefix_comoving_integral`` — shared GL panels between sorted
  static targets plus a prefix sum (the BAO ``('gl', order)`` grid).
* ``comoving_distance_gl`` — Gauss-Legendre per point (plotting curves).
* ``sn_comoving_integral``, ``apparent_magnitude``, ``h0_free_log_dl`` —
  the reference's SN distance path (cumulative trapezoid on a grid,
  interpolated at the SNe), public helpers beside the SN terms' own.
"""

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.models.background import e_of_z, expand_params, hubble
from cosmax_torch.ops.quadrature import cumtrapz, gl_nodes_01, interp_apply, interp_weights


def hubble_distance(z, params, model):
    """D_H(z) = c / H(z) [Mpc]; z [N], params [W] -> [W, N]."""
    return C_KM_S / hubble(z, expand_params(params, z.dim()), model)


def comoving_integral_gl(z, params, model, order: int = 64):
    """Dimensionless int_0^z dz'/E(z') by order-``order`` GL per point;
    z [N], params [W] -> [W, N]."""
    t, w = gl_nodes_01(order)
    t = torch.as_tensor(t, dtype=z.dtype, device=z.device)
    w = torch.as_tensor(w, dtype=z.dtype, device=z.device)
    nodes = z[..., None] * t  # [N, order]
    integ = 1.0 / e_of_z(nodes, expand_params(params, nodes.dim()), model)
    return z * torch.sum(integ * w, dim=-1)


def comoving_distance_gl(z, params, model, order: int = 64):
    """D_M(z) = c/H0 * int_0^z dz'/E(z') [Mpc]; z [N] -> [W, N]."""
    h0 = expand_params(params, z.dim())["H0"]
    return (C_KM_S / h0) * comoving_integral_gl(z, params, model, order)


def make_prefix_comoving_integral(z_points, model, device, dtype, order: int = 8):
    """Shared-panel prefix quadrature for a static batch of targets:
    int_0^{z_i} dz/E for every z_i with one panel of ``order`` GL nodes
    between consecutive sorted z's and a prefix sum (``cumsum`` + gather).
    Build-time numpy; returns ``fn(params [W]) -> I [W, len(z_points)]``
    in the original order."""
    z_points = np.atleast_1d(np.asarray(z_points, dtype=np.float64))
    perm = np.argsort(z_points)
    edges = np.concatenate([[0.0], z_points[perm]])
    t, w = gl_nodes_01(order)
    widths = np.diff(edges)
    nodes = torch.as_tensor(edges[:-1, None] + widths[:, None] * t[None, :], device=device)
    weights = torch.as_tensor(widths[:, None] * w[None, :], device=device)
    nodes, weights = nodes.to(dtype), weights.to(dtype)
    inv_perm = torch.as_tensor(np.argsort(perm), device=device)

    def integral(params):
        integ = 1.0 / e_of_z(nodes, expand_params(params, 2), model)
        segments = torch.sum(integ * weights, dim=-1)
        return torch.cumsum(segments, dim=-1)[..., inv_perm]

    return integral


def comoving_distance_trapz(params, model, grid, weights):
    """D_M over precomputed trapezoid grids [N, L] -> [W, N]. With
    [W] parameters this evaluates H on a [W, N, L] grid: callers bound
    W (``likelihoods.base.make_log_prob`` evaluates in walker chunks)."""
    integ = C_KM_S / hubble(grid, expand_params(params, grid.dim()), model)
    return torch.sum(integ * weights, dim=-1)


def volume_distance(z, dh, dm):
    """D_V = (z * D_H * D_M^2)^{1/3}."""
    return (z * dh * dm**2) ** (1.0 / 3.0)


def sn_comoving_integral(params, model, z_grid, z_data):
    """int_0^{z_data} dz/E by the cumulative trapezoid on the grid
    ``z_grid`` [G] plus linear interpolation at the static ``z_data`` [N]:
    the reference's SN path (sn/pantheon.py:32-35, sn/union3.py:28-31).
    Dimensionless (no c/H0 factor); params [W] -> [W, N]."""
    inv_e = 1.0 / e_of_z(z_grid, expand_params(params, z_grid.dim()), model)
    idx, t = interp_weights(torch.as_tensor(z_data).detach().cpu().double().numpy(),
                            z_grid.detach().cpu().double().numpy())
    idx = torch.as_tensor(idx, device=z_grid.device)
    t = torch.as_tensor(t, device=z_grid.device).to(inv_e.dtype)
    return interp_apply(cumtrapz(inv_e, z_grid), idx, t)


def apparent_magnitude(params, model, z_grid, z_data, one_plus_z_hel, h0, mag_offset):
    """m(z) = offset + 25 + 5 log10((1+z_hel) (c/H0) I(z)), every
    reference SN convention: Pantheon+'s absolute magnitude M with a free
    H0 (sn/pantheon.py:35), Union3 / DES5Y's Delta_M at H0 = 70
    (sn/union3.py:33-36, sn/des5y.py:27-31; Union3 passes
    one_plus_z_hel = 1 + z_cmb). ``h0`` is a float, or [W, 1] beside [W]
    params."""
    integral = sn_comoving_integral(params, model, z_grid, z_data)
    dl = one_plus_z_hel * (C_KM_S / h0) * integral
    return mag_offset + 25.0 + 5.0 * torch.log10(dl)


def h0_free_log_dl(params, model, z_grid, z_data, one_plus_z_hel):
    """5 log10((1+z_hel) I(z)) with c/H0 absorbed into the magnitude
    offset: the reference's H0-free SN parameterisation
    (bao/desi_des5y.py:34-37)."""
    integral = sn_comoving_integral(params, model, z_grid, z_data)
    return 5.0 * torch.log10(one_plus_z_hel * integral)
