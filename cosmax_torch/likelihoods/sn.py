"""Type Ia supernova likelihood, dense method (counterpart of
``cosmax/likelihoods/sn.py``).

Theory: one cumulative-trapezoid integral of 1/E on a fixed grid shared
by all SNe, interpolated at the data redshifts, then the whitened
residual against the full N x N factor (the CUDA chi^2 kernel on the
card). The grid and the data redshifts are static, so the interpolation
indices and lerp weights are built once in f64 numpy and the runtime
interpolation is two gathers and an FMA.
"""

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.data.loaders import CovDataset
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods.base import Term
from cosmax_torch.models.background import e_of_z, expand_params
from cosmax_torch.ops.linalg import chi2_from_whitener
from cosmax_torch.ops.quadrature import cumtrapz, interp_apply, interp_weights


def build_sn_term(
    dataset: CovDataset,
    model: str,
    mag_param: str = "M",
    h0="H0",
    device="cpu",
    dtype=torch.float32,
    use_z_hel: bool = True,
    grid_num: int = 1000,
    name: str = "sn",
    method: str = "dense",
) -> Term:
    """h0: a float fixes H0; the name of a sampled parameter reads it
    from the dict; None gives the H0-free form where ``mag_param``
    absorbs 5 log10(c/H0) + 25."""
    if method in ("emulated", "compressed"):
        raise NotImplementedError(
            f"SN method {method!r} needs the emulator build and bundle/fast "
            "mode (ROADMAP.md queue 1, items 4-5), not ported yet"
        )
    if method != "dense":
        raise ValueError(f"unknown SN method {method!r}")
    if h0 is not None and not isinstance(h0, str):
        h0 = float(h0)
    z_cmb = np.asarray(dataset.z_cmb, dtype=np.float64)
    mags = np.asarray(dataset.values, dtype=np.float64)
    one_plus_z_hel = 1.0 + np.asarray(
        dataset.z_hel if use_z_hel else dataset.z_cmb, dtype=np.float64
    )
    # the grid ends exactly at max(z_cmb): that point lerps the last
    # interval with weight 1, as jnp.interp does
    z_grid = np.linspace(0.0, z_cmb.max(), num=grid_num)
    idx, t = interp_weights(z_cmb, z_grid)
    c = constants_from_numpy(
        dict(
            linv=dataset.linv,
            values=mags,
            one_plus_z_hel=one_plus_z_hel,
            z_grid=z_grid,
            interp_idx=idx,
            interp_t=t,
        ),
        device,
        dtype,
    )

    def theory_mag(p):
        inv_e = 1.0 / e_of_z(c["z_grid"], expand_params(p, 1), model)
        integral = interp_apply(cumtrapz(inv_e, c["z_grid"]), c["interp_idx"], c["interp_t"])
        if h0 is None:
            mu = 25.0 + 5.0 * torch.log10(c["one_plus_z_hel"] * C_KM_S * integral)
        else:
            h0_val = p[h0][:, None] if isinstance(h0, str) else h0
            mu = 25.0 + 5.0 * torch.log10(
                c["one_plus_z_hel"] * (C_KM_S / h0_val) * integral
            )
        return mu + p[mag_param][:, None]

    def chi2(p):
        return chi2_from_whitener(c["linv"], c["values"] - theory_mag(p))

    return Term(
        name=name,
        chi2=chi2,
        elems_per_walker=max(grid_num, z_cmb.size),
        meta=dict(
            n=dataset.n,
            legend=dataset.legend,
            theory_mag=theory_mag,
            values=mags,
            plot_kind="sn",
            z=z_cmb,
            errors=np.sqrt(np.diag(dataset.cov)),
            constants=c,
        ),
    )
