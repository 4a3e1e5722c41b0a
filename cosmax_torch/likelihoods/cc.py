"""Cosmic-chronometer H(z) likelihood with the error-rescaling nuisance f
(counterpart of ``cosmax/likelihoods/cc.py``).

The reference fits a scale factor on the CC covariance with two
conventions, both reproduced:

* ``divide``: chi^2 = f^-2 d^T C^-1 d, normalisation N ln 2pi + ln|C|
  + 2N ln f (cosmic_chronometers/cc.py:40-55);
* ``multiply``: chi^2 = f^2 d^T C^-1 d, normalisation N ln 2pi + ln|C|
  - 2N ln f (cosmic_chronometers/cc_des5y.py:58-79).

With ``f_param=None`` the plain Gaussian chi^2 is used, with no
normalisation (the "CC without f" variant of the cc.py docstring).

* Parity path: H(z) = H0 E(z) per walker and the whitened residual
  (the CUDA chi^2 kernel on the card).
* Fast path (``fast_mode()``): the whitened residual Linv (H_obs - H0
  E(z_i; theta)) is linear in H0, so ``models.linear_chi2`` tabulates
  Linv E on the family's grid with beta = H0 and beta_ref = 70.
"""

import numpy as np
import torch

from cosmax_torch.data.loaders import CovDataset
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods.base import Term, grid_like
from cosmax_torch.likelihoods.fastmode import fast_mode
from cosmax_torch.models.background import e_of_z, expand_params, hubble
from cosmax_torch.ops.linalg import chi2_from_whitener


def build_cc_term(
    dataset: CovDataset,
    model: str,
    convention: str = "divide",
    *,
    device,
    dtype=torch.float32,
    f_param="f_cc",
) -> Term:
    """``f_param`` names the error-rescaling parameter, or is None for
    the plain chi^2."""
    z = np.asarray(dataset.z, dtype=np.float64)
    h_obs = np.asarray(dataset.values, dtype=np.float64)
    linv = dataset.linv
    n = dataset.n
    if convention not in ("divide", "multiply"):
        raise ValueError(convention)

    def theory_curve(p, z_grid):
        """H(z) [km/s/Mpc] on ``z_grid`` at the walkers of ``p``: [W, N]."""
        return hubble(grid_like(p, z_grid), expand_params(p, 1), model)

    meta = dict(n=n, legend=dataset.legend, plot_kind="cc", z=z, values=h_obs,
                errors=np.sqrt(np.diag(dataset.cov)), theory_curve=theory_curve)

    if fast_mode():
        from cosmax_torch.models.linear_chi2 import _hash_arrays, make_linear_chi2

        def curve_fn(flat, to_params):
            p = to_params(torch.as_tensor(flat, dtype=torch.float64))
            e = e_of_z(torch.as_tensor(z), expand_params(p, 1), model).numpy()
            return e @ np.asarray(linv).T

        u0 = np.asarray(linv, np.float64) @ h_obs
        base_chi2 = make_linear_chi2(
            model,
            curve_fn,
            tag=f"cc-{model}",
            key_extra=_hash_arrays(z, h_obs, linv),
            u0_c=u0,
            u0_sq=float(u0 @ u0),
            device=device,
            dtype=dtype,
            beta_fn=lambda p: p["H0"],
            beta_ref=70.0,
        )
        # beta = H0, for the fused kernel's packer
        meta.update(linear_chi2=base_chi2, beta="H0")
    else:
        c = constants_from_numpy(dict(z=z, values=h_obs, linv=linv), device, dtype)

        def base_chi2(p):
            return chi2_from_whitener(c["linv"], c["values"] - hubble(c["z"], expand_params(p, 1), model))

        meta.update(constants=c)

    if f_param is None:
        return Term(name="cc", chi2=base_chi2, meta=meta)

    power = -2.0 if convention == "divide" else 2.0
    # the constant part folded at build time in f64, so that the f32
    # runtime does not round the large N ln 2pi + ln|C|
    const_norm = -0.5 * (n * np.log(2.0 * np.pi) + dataset.log_det)
    sign = 1.0 if convention == "divide" else -1.0

    def chi2(p):
        f = p[f_param]
        return (f**power) * base_chi2(p)

    def log_norm(p):
        return const_norm - sign * n * torch.log(p[f_param])

    # chi2 * f^power and log_norm = const + coef * ln f, for the packer
    meta.update(rescale=dict(param=f_param, power=power, ln_const=const_norm,
                             ln_coef=-sign * n))
    return Term(name="cc", chi2=chi2, log_norm=log_norm, meta=meta)
