"""Quintessence reconstruction of the wzCDM dark-energy fluid
(counterpart of ``cosmax/models/scalar_field.py``).

Given best-fit (Om, w0) from a wzCDM fit, reconstruct the scalar field
phi(a) and its potential V(phi) that reproduce

    w(a) = -1 + 2 (1+w0) a^3 / (1+a^3),
    rho_de(a) = (2 / (1+a^3))^{2 (1+w0)}   (field.py:20-24, natural units)

via  V(a) = (1 - w) rho/2  and  dphi/da = sqrt(rho (1+w)) / (a H(a))
(field.py:26-28), with phi(a) a cumulative-trapezoid integral on a
2000-point grid in a in [1e-3, 3] (field.py:17,30). ``w_de``, ``rho_de``
and ``hubble_of_a`` are elementwise and take numpy arrays or tensors;
``reconstruct`` runs on the card unless the caller asks for the CPU.
"""

import numpy as np
import torch

from cosmax_torch.device import resolve
from cosmax_torch.ops.quadrature import cumtrapz, interp

A_GRID = np.linspace(1e-3, 3.0, 2000)


def one_plus_w(a, w0):
    """1 + w(a), formed without the cancellation of 1 + (-1 + x): at
    small a, x ~ a^3 is below float32's resolution of -1."""
    return 2.0 * (1.0 + w0) * a**3 / (1.0 + a**3)


def w_de(a, w0):
    return -1.0 + one_plus_w(a, w0)


def rho_de(a, w0):
    return (2.0 / (1.0 + a**3)) ** (2.0 * (1.0 + w0))


def hubble_of_a(a, om, w0, o_r=4e-5, h0=1.0):
    e2 = om * a**-3 + o_r * a**-4 + (1.0 - om) * rho_de(a, w0)
    return h0 * (torch.sqrt(e2) if isinstance(e2, torch.Tensor) else np.sqrt(e2))


def reconstruct(om: float, w0: float, o_r: float = 4e-5, a_grid=None, device="cuda",
                dtype=None) -> dict:
    """phi(a), V(a), dphi/dt, t(a) and V on a uniform phi grid --
    everything field.py:17-38 computes -- as numpy arrays, computed on
    ``device`` in ``dtype``."""
    device, dtype = resolve(device, dtype)
    a = torch.as_tensor(A_GRID if a_grid is None else np.asarray(a_grid), device=device).to(dtype)
    w = w_de(a, w0)
    rho = rho_de(a, w0)
    h = hubble_of_a(a, om, w0, o_r)
    v_of_a = 0.5 * (1.0 - w) * rho
    # rho (1 + w) from 1 + w itself, not from w (float32 on the card)
    dphi_da = torch.sqrt(torch.clamp(rho * one_plus_w(a, w0), min=0.0)) / (a * h)
    phi = cumtrapz(dphi_da, a)
    dphi_dt = dphi_da * h * a
    # cosmic time t(a) = int da / (a H) (field.py:74-75, H0 = 1 units)
    t = cumtrapz(1.0 / (a * h), a)
    phi_grid = torch.linspace(float(phi.min()), float(phi.max()), a.shape[0], device=device,
                              dtype=dtype)
    # V(phi) by interpolating the monotone a(phi)
    a_of_phi = interp(phi_grid, phi, a)
    v_of_phi = 0.5 * (1.0 - w_de(a_of_phi, w0)) * rho_de(a_of_phi, w0)

    def host(x):
        return x.cpu().double().numpy()

    return dict(a=host(a), phi=host(phi), v_of_a=host(v_of_a), dphi_dt=host(dphi_dt),
                t=host(t), phi_grid=host(phi_grid), v_of_phi=host(v_of_phi))
