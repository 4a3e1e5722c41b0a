"""Recombination and drag-epoch fitting formulae and the sound horizon
(counterpart of ``cosmax/models/recombination.py``).

The fitting formulae (arXiv:2106.00428 eqs A2/A4/8, Hu & Sugiyama 1996,
Eisenstein & Hu, DESI DR2 eq 2) are elementwise in (wb, wm) and take [W]
tensors.
``sound_horizon`` and ``comoving_distance_to`` are fixed-order
Gauss-Legendre integrals whose upper limit z* is itself per walker: the
nodes get a trailing axis, [W] -> [W, order], and the parameters are
expanded to match.
"""

import torch

from cosmax_torch.constants import C_KM_S, O_GAMMA_H2
from cosmax_torch.models.background import e_of_z, expand_params
from cosmax_torch.ops.quadrature import gl_nodes_01


def z_star(wb, wm):
    """Redshift of photon decoupling, arXiv:2106.00428 eq A4."""
    return (391.672 * wm ** (-0.372296) + 937.422 * wb ** (-0.97966)) / (
        wm ** (-0.0192951) * wb ** (-0.93681)
    ) + wm ** (-0.731631)


def z_star_hu(wb, wm):
    """Hu & Sugiyama 1996 eq 1."""
    g1 = 0.0783 * wb**-0.238 / (1.0 + 39.5 * wb**0.763)
    g2 = 0.560 / (1.0 + 21.1 * wb**1.81)
    return 1048.0 * (1.0 + 0.00124 * wb**-0.738) * (1.0 + g1 * wm**g2)


def z_drag(wb, wm):
    """Drag epoch, arXiv:2106.00428 eq A2."""
    return (
        1.0 + 428.169 * wb**0.256459 * wm**0.616388 + 925.56 * wm**0.751615
    ) * wm**-0.714129


def z_drag_hu(wb, wm):
    """Eisenstein & Hu drag redshift."""
    b1 = 0.313 * wm**-0.419 * (1.0 + 0.607 * wm**0.674)
    b2 = 0.238 * wm**0.223
    return (1345.0 * wm**0.251 / (1.0 + 0.659 * wm**0.828)) * (1.0 + b1 * wb**b2)


def r_drag_aizpuru(wb, wm):
    """Sound horizon at the drag epoch, arXiv:2106.00428 eq 8. Mpc."""
    a1, a2, a3 = 0.00257366, 0.05032, 0.013
    a4, a5, a6 = 0.7720642, 0.24346362, 0.00641072
    a7, a8, a9 = 0.5350899, 32.7525, 0.315473
    term_a = 1.0 / (a1 * wb**a2 + a3 * wb**a4 * wm**a5 + a6 * wm**a7)
    return term_a - a8 / wm**a9


def r_drag_desi(wb, wm, n_eff=3.044):
    """DESI DR2 fitting form, arXiv:2503.14738 eq 2. Mpc."""
    return 147.05 * (0.02236 / wb) ** 0.13 * (0.1432 / wm) ** 0.23 * (3.04 / n_eff) ** 0.1


def _nodes(z, order):
    t, w = gl_nodes_01(order)
    t = torch.as_tensor(t, dtype=z.dtype, device=z.device)
    w = torch.as_tensor(w, dtype=z.dtype, device=z.device)
    return t, w


def sound_horizon(z, params, model, h0, wb, order: int = 128, o_gamma_h2=O_GAMMA_H2):
    """r_s(z) = int_0^{a(z)} c da / (a^2 H(1/a-1) sqrt(3 (1+Rb a))) [Mpc]
    by GL in the scale factor; ``params`` must carry 'Or'. z, h0, wb are
    [W] tensors (or 0-d) -> [W]."""
    t, w = _nodes(z, order)
    rb = (3.0 * wb / (4.0 * o_gamma_h2))[..., None]
    a_end = (1.0 / (1.0 + z))[..., None]
    a = a_end * t
    wq = a_end * w
    ez = e_of_z(1.0 / a - 1.0, expand_params(params, 1), model)
    integ = C_KM_S / (a**2 * ez * torch.sqrt(3.0 * (1.0 + rb * a)))
    return torch.sum(integ * wq, dim=-1) / h0


def comoving_distance_to(z, params, model, h0, order: int = 64):
    """D_C(z) = int_{ln a*}^{0} c du / (a H(1/a-1)) [Mpc] by GL in ln a;
    z, h0 [W] -> [W]."""
    t, w = _nodes(z, order)
    u0 = torch.log(1.0 / (1.0 + z))[..., None]  # ln a*
    u = u0 * (1.0 - t)
    a = torch.exp(u)
    wq = -u0 * w
    ez = e_of_z(1.0 / a - 1.0, expand_params(params, 1), model)
    integ = C_KM_S / (a * ez)
    return torch.sum(integ * wq, dim=-1) / h0
