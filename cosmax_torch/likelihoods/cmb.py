"""CMB distance-prior (compressed) likelihoods (counterpart of
``cosmax/likelihoods/cmb.py``).

Four published compressions, each with its prior vector, inverse
covariance and radiation constants:

* ``chen``   — Chen+2018 arXiv:1808.05724, observables (R, lA, wb)
* ``act``    — Planck+ACT, Bansal+2025 arXiv:2502.07185, (R, lA, wb)
* ``desi``   — DESI DR2 arXiv:2503.14738, (theta*, wb, wm)
* ``union3`` — Rubin+ arXiv:2311.12098, (R, 100 theta*, wb)

r_s(z*) is GL-48 in the scale factor and D_C(z*) GL-24 in ln a
(``models.recombination``). The 3 x 3 whitening is a plain torch product.
``build_theta_star_term`` is the Gaussian prior on 100 theta* alone, from
the same three quantities.
"""

from dataclasses import dataclass

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.likelihoods.base import Term
from cosmax_torch.models import recombination
from cosmax_torch.ops.linalg import whitening_operator


@dataclass(frozen=True)
class Compression:
    name: str
    priors: np.ndarray
    inv_cov: np.ndarray
    o_gamma_h2: float
    n_eff: float
    observables: str  # 'R_lA_wb' | 'theta_wb_wm' | 'R_100theta_wb'
    # z* fitting formula: Aizpuru A4 everywhere except the Union3
    # compression, which uses Hu & Sugiyama 1996
    z_star_variant: str = "aizpuru"

    def omega_r_h2(self) -> float:
        return self.o_gamma_h2 * (1.0 + 0.2271 * self.n_eff)


_OG_STD = (0.75 / 31500.0) * (2.7255 / 2.7) ** 4

COMPRESSIONS = {
    "chen": Compression(
        name="chen",
        priors=np.array([1.750235, 301.4707, 0.02235976]),
        inv_cov=np.array(
            [
                [94392.3971, -1360.4913, 1664517.2916],
                [-1360.4913, 161.4349, 3671.618],
                [1664517.2916, 3671.618, 79719182.5162],
            ]
        ),
        o_gamma_h2=_OG_STD,
        n_eff=3.046,
        observables="R_lA_wb",
    ),
    "act": Compression(
        name="act",
        priors=np.array([1.7504, 301.77, 0.022371]),
        inv_cov=np.linalg.inv(
            1e-8
            * np.array(
                [
                    [1559.83, -1325.41, -36.45],
                    [-1325.41, 714691.80, 269.77],
                    [-36.45, 269.77, 2.10],
                ]
            )
        ),
        o_gamma_h2=_OG_STD,
        n_eff=3.044,
        observables="R_lA_wb",
    ),
    "desi": Compression(
        name="desi",
        priors=np.array([0.01041, 0.02223, 0.14208]),
        inv_cov=np.linalg.inv(
            1e-9
            * np.array(
                [
                    [0.006621, 0.12444, -1.1929],
                    [0.12444, 21.344, -94.001],
                    [-1.1929, -94.001, 1488.4],
                ]
            )
        ),
        o_gamma_h2=_OG_STD,
        n_eff=3.044,
        observables="theta_wb_wm",
    ),
    "union3": Compression(
        name="union3",
        priors=np.array([1.7492768568335353, 1.039233410719115, 0.02239245]),
        inv_cov=np.array(
            [
                [92701.58172970748, 348041.8137694254, 1613445.8550364415],
                [348041.8137694254, 13114681.644682042, -3019007.1687636944],
                [1613445.8550364415, -3019007.1687636944, 80842256.32398143],
            ]
        ),
        o_gamma_h2=2.4729e-5,
        n_eff=3.04,
        observables="R_100theta_wb",
        z_star_variant="hu",
    ),
}


def cmb_observables(
    comp: Compression, p: dict, model: str, order: int = None,
    rs_order: int = 48, dc_order: int = 24,
):
    """The compression's observables at walker parameters ``p`` ([W]
    tensors: H0, Om, Obh2, and 'Or') -> [W, 3]."""
    if order is not None:  # explicit single order overrides both
        rs_order = dc_order = order
    h0, om, wb = p["H0"], p["Om"], p["Obh2"]
    wm = om * (h0 / 100.0) ** 2
    z_star_fn = (
        recombination.z_star_hu
        if comp.z_star_variant == "hu"
        else recombination.z_star
    )
    zstar = z_star_fn(wb, wm)
    rs_star = recombination.sound_horizon(
        zstar, p, model, h0, wb, order=rs_order, o_gamma_h2=comp.o_gamma_h2
    )
    dm_star = recombination.comoving_distance_to(zstar, p, model, h0, order=dc_order)
    if comp.observables == "R_lA_wb":
        r = torch.sqrt(om) * h0 * dm_star / C_KM_S
        la = torch.pi * dm_star / rs_star
        return torch.stack([r, la, wb], dim=-1)
    if comp.observables == "theta_wb_wm":
        theta = rs_star / dm_star
        return torch.stack([theta, wb, wm], dim=-1)
    if comp.observables == "R_100theta_wb":
        r = torch.sqrt(om) * h0 * dm_star / C_KM_S
        theta100 = 100.0 * rs_star / dm_star
        return torch.stack([r, theta100, wb], dim=-1)
    raise ValueError(comp.observables)


def build_cmb_term(
    compression: str, model: str, device, dtype=torch.float32,
    order: int = None, name: str = None,
) -> Term:
    comp = COMPRESSIONS[compression]
    priors = torch.as_tensor(comp.priors, device=device).to(dtype)
    linv = torch.as_tensor(
        np.ascontiguousarray(whitening_operator(np.linalg.inv(comp.inv_cov))),
        device=device,
    ).to(dtype)

    def chi2(p):
        delta = priors - cmb_observables(comp, p, model, order)
        wht = delta @ linv.T
        return torch.sum(wht * wht, dim=-1)

    return Term(
        name=name or f"cmb_{compression}",
        chi2=chi2,
        elems_per_walker=48,
        meta=dict(
            n=3, legend=f"CMB compression ({compression})", compression=comp, model=model,
            # GL orders of r_s and D_C, for the fused kernel's packer
            orders=(order, order) if order is not None else (48, 24),
        ),
    )


def build_theta_star_term(
    model: str,
    theta_100: float = 1.04110,
    theta_100_err: float = 0.00031,
    rs_order: int = 48,
    dc_order: int = 24,
    o_gamma_h2: float = _OG_STD,
    name: str = "theta_star",
    z_star: str = "aizpuru",
) -> Term:
    """Gaussian prior on 100 theta* = 100 r_s(z*) / D_C(z*) alone
    (reference bao/desi_omh2_theta_star.py:19-20,88-95;
    bao/desi_bbn_theta_star.py:17 uses err 0.00053). ``z_star`` picks the
    decoupling-redshift formula: "aizpuru" (A4) or "hu" (Hu & Sugiyama,
    the variant of the published desi_omh2_theta_star rows)."""
    zstar_fn = {"aizpuru": recombination.z_star, "hu": recombination.z_star_hu}[z_star]

    def chi2(p):
        h0, om, wb = p["H0"], p["Om"], p["Obh2"]
        wm = om * (h0 / 100.0) ** 2
        zstar = zstar_fn(wb, wm)
        rs_star = recombination.sound_horizon(
            zstar, p, model, h0, wb, order=rs_order, o_gamma_h2=o_gamma_h2
        )
        dm_star = recombination.comoving_distance_to(zstar, p, model, h0, order=dc_order)
        theory = 100.0 * rs_star / dm_star
        return ((theta_100 - theory) / theta_100_err) ** 2

    return Term(
        name=name,
        chi2=chi2,
        elems_per_walker=48,
        meta=dict(
            n=1, model=model, orders=(rs_order, dc_order),
            # for the fused kernel's packer: the CMB block's theta* kind
            theta_star=dict(theta_100=theta_100, sigma=theta_100_err, z_star=z_star,
                            o_gamma_h2=o_gamma_h2),
        ),
    )
