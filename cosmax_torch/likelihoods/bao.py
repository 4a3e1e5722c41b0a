"""BAO likelihood (counterpart of ``cosmax/likelihoods/bao.py``).

Theory: D_V/r_d, D_M/r_d, D_H/r_d per data point, selected by one-hot
masks of the integer quantity codes, against a dense covariance
whitened at build time; chi^2 goes through ``chi2_from_whitener`` (the
CUDA kernel on the card).

r_d treatments: ``rd_fn(p) -> Mpc`` with ``rd_fixed`` or ``rd_param``.
"""

from typing import Callable

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.data.loaders import QTY_DH, QTY_DM, QTY_DV, CovDataset
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods.base import Term
from cosmax_torch.models.distances import (
    comoving_distance_trapz,
    hubble_distance,
    make_prefix_comoving_integral,
    volume_distance,
)
from cosmax_torch.ops.linalg import chi2_from_whitener
from cosmax_torch.ops.quadrature import trapz_grid_weights


def rd_fixed(value: float = 147.09) -> Callable:
    return lambda p: value


def rd_param(name: str = "rd") -> Callable:
    return lambda p: p[name]


def build_bao_term(
    dataset: CovDataset,
    model: str,
    rd_fn: Callable,
    device,
    dtype=torch.float32,
    grid: tuple = ("gl", 64),
    name: str = "bao",
) -> Term:
    """grid: ('dyn_trapz', n_base) or ('fixed_trapz', n) — the parity
    paths matching the reference's per-script trapezoids — or
    ('gl', order), GL per data point."""
    if grid[0] == "emu":
        raise NotImplementedError(
            "BAO grid ('emu',) needs the emulator build and bundle/fast mode "
            "(ROADMAP.md queue 1, items 4-5), not ported yet"
        )
    z = np.asarray(dataset.z, dtype=np.float64)
    qty = np.asarray(dataset.quantity)
    values = np.asarray(dataset.values, dtype=np.float64)
    arrays = dict(
        z=z,
        values=values,
        linv=dataset.linv,
        mask_dv=(qty == QTY_DV).astype(np.float64),
        mask_dm=(qty == QTY_DM).astype(np.float64),
        mask_dh=(qty == QTY_DH).astype(np.float64),
    )

    kind = grid[0]
    if kind in ("dyn_trapz", "fixed_trapz"):
        tgrid, tw = trapz_grid_weights(z, grid[1], dynamic=(kind == "dyn_trapz"))
        arrays.update(grid=tgrid, weights=tw)
        elems = tgrid.size
    elif kind == "gl":
        # shared-panel prefix quadrature over the unique data redshifts,
        # 8-node panels as in the reference
        z_unique, z_inverse = np.unique(z, return_inverse=True)
        panel_order = max(8, grid[1] // 8)
        arrays.update(z_inverse=z_inverse)
        elems = z_unique.size * panel_order
    else:
        raise ValueError(f"unknown grid mode {grid!r}")
    c = constants_from_numpy(arrays, device, dtype)

    if kind == "gl":
        prefix_integral = make_prefix_comoving_integral(
            z_unique, model, device, dtype, order=panel_order
        )

        def dm_of(p):
            h0 = p["H0"][:, None] if isinstance(p["H0"], torch.Tensor) else p["H0"]
            return (C_KM_S / h0) * prefix_integral(p)[..., c["z_inverse"]]

    else:

        def dm_of(p):
            return comoving_distance_trapz(p, model, c["grid"], c["weights"])

    def chi2(p):
        dh = hubble_distance(c["z"], p, model)
        dm = dm_of(p)
        dv = volume_distance(c["z"], dh, dm)
        rd = rd_fn(p)
        if isinstance(rd, torch.Tensor) and rd.dim() > 0:
            rd = rd[:, None]
        theory = (c["mask_dh"] * dh + c["mask_dm"] * dm + c["mask_dv"] * dv) / rd
        return chi2_from_whitener(c["linv"], c["values"] - theory)

    return Term(
        name=name,
        chi2=chi2,
        elems_per_walker=elems,
        meta=dict(
            n=dataset.n,
            legend=dataset.legend,
            plot_kind="bao",
            z=z,
            values=values,
            errors=np.sqrt(np.diag(dataset.cov)),
            quantity=qty,
            constants=c,
        ),
    )
