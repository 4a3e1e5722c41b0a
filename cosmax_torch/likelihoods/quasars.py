"""Standardised-quasar likelihood, Lusso+2020 binned Hubble diagram
(counterpart of ``cosmax/likelihoods/quasars.py``).

A diagonal Gaussian with an intrinsic scatter ``s`` added in quadrature
and a magnitude offset ``dM_qsr``:

    chi^2 = sum d_i^2 / (sigma_i^2 + s^2),
    log L = -0.5 (chi^2 + sum ln(sigma_i^2 + s^2))

(reference quasars/qsr_desi.py:68-80), with H0 fixed.

* Parity path: the distance modulus by the fixed-H0 cumulative
  trapezoid on a 3000-point grid, interpolated at the bins
  (qsr_desi.py:25-32).
* Fast path: the curve mu(z_i; theta) - mu_ref depends on the geometry
  only, so it rides the preset bundle's shared contraction
  (``models.linear_chi2.make_curve_values``), tabulated by prefix
  Gauss-Legendre panels of order 16 in f64; mu_ref comes from the same
  quadrature at Om = 0.3, w0 = -1. The data minus mu_ref is folded in
  f64 at build time, so that the f32 runtime does not cancel the 40-mag
  values.
"""

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods.base import Term
from cosmax_torch.likelihoods.fastmode import fast_mode
from cosmax_torch.models.background import e_of_z, expand_params
from cosmax_torch.ops.quadrature import cumtrapz, interp_apply, interp_weights

BUILD_ORDER = 16  # GL panels of the fast path's build tables
H0 = 70.0  # km/s/Mpc, fixed (qsr_desi.py:29)
GRID_NUM = 3000  # points of the parity path's trapezoid grid
OFFSET, SCATTER = "dM_qsr", "s"  # the magnitude offset and the intrinsic scatter


def build_quasar_term(
    z,
    mu,
    sigma_mu,
    model: str,
    *,
    device,
    dtype=torch.float32,
) -> Term:
    z = np.asarray(z, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    sigma_sq = np.asarray(sigma_mu, dtype=np.float64) ** 2
    meta = dict(n=z.size, legend=f"Quasars - {z.size} bins")

    if fast_mode():
        from cosmax_torch.models.distances import make_prefix_comoving_integral
        from cosmax_torch.models.linear_chi2 import _hash_arrays, make_curve_values

        def mu_of(integral):
            return 25.0 + 5.0 * torch.log10((1.0 + torch.as_tensor(z)) * (C_KM_S / H0) * integral)

        prefix = make_prefix_comoving_integral(z, model, "cpu", torch.float64, BUILD_ORDER)
        p_ref = {k: torch.tensor([v], dtype=torch.float64)
                 for k, v in dict(Om=0.3, w0=-1.0, wa=0.0).items()}
        mu_ref = mu_of(prefix(p_ref))[0].numpy()

        def curve_fn(flat, to_params):
            integral = prefix(to_params(torch.as_tensor(flat, dtype=torch.float64)))
            return (mu_of(integral) - torch.as_tensor(mu_ref)).numpy()

        dmu = make_curve_values(
            model, curve_fn, "qsr", (_hash_arrays(z, mu_ref), H0, BUILD_ORDER),
            device, dtype,
        )
        d_ref = mu - mu_ref  # f64, before the cast
        c = constants_from_numpy(dict(d_ref=d_ref, sigma_sq=sigma_sq), device, dtype)

        def residual(p):
            return c["d_ref"] - dmu(p) - p[OFFSET][:, None]

        # what the fused kernel's packer reads
        meta.update(curve_values=dmu, d_ref=d_ref, sigma_sq=sigma_sq,
                    offset=OFFSET, scatter=SCATTER)
        elems = z.size
    else:
        z_grid = np.linspace(0.0, z.max(), num=GRID_NUM)
        idx, t = interp_weights(z, z_grid)
        c = constants_from_numpy(
            dict(z=z, mu=mu, sigma_sq=sigma_sq, z_grid=z_grid, interp_idx=idx, interp_t=t),
            device, dtype,
        )

        def residual(p):
            inv_e = 1.0 / e_of_z(c["z_grid"], expand_params(p, 1), model)
            integral = interp_apply(cumtrapz(inv_e, c["z_grid"]), c["interp_idx"], c["interp_t"])
            mu_th = 25.0 + 5.0 * torch.log10((1.0 + c["z"]) * (C_KM_S / H0) * integral)
            return c["mu"] - mu_th - p[OFFSET][:, None]

        elems = GRID_NUM

    def variance(p):
        return c["sigma_sq"] + (p[SCATTER] ** 2)[:, None]

    def chi2(p):
        return torch.sum(residual(p) ** 2 / variance(p), dim=-1)

    def log_norm(p):
        return -0.5 * torch.sum(torch.log(variance(p)), dim=-1)

    return Term(name="quasars", chi2=chi2, log_norm=log_norm, elems_per_walker=elems,
                meta=dict(meta, constants=c))
