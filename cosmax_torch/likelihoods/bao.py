"""BAO likelihood (counterpart of ``cosmax/likelihoods/bao.py``).

Theory: D_V/r_d, D_M/r_d, D_H/r_d per data point, selected by one-hot
masks of the integer quantity codes, against a dense covariance
whitened at build time; chi^2 goes through ``chi2_from_whitener`` (the
CUDA kernel on the card).

r_d treatments: ``rd_fn(p) -> Mpc``, each a frozen dataclass whose fields
the fused log-prob kernel's packer reads: a fixed r_d (``rd_fixed``), a
sampled one (``rd_param``; times 100 for the H0-free ``rd_h`` of
bao.desi_des5y), r_d h sampled (``rd_over_h``), the drag-epoch fitting
formulae of (wb, wm) (``rd_from_r_drag``) and the sound horizon at
z_drag integrated from the background (``rd_from_z_drag``).

The ``('emu',)`` grid (the fast path, and the grid of every BAO term
built in fast mode) uses that each observable is homogeneous of degree
1 in c/H0: the whitened theory vector is beta(p) * t_hat(theta) with
beta = (c/H0)/r_d(p), and t_hat a smooth function of the dark-energy
parameters that ``models.linear_chi2`` tabulates at build time.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.data.loaders import QTY_DH, QTY_DM, QTY_DV, CovDataset
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods.base import Term, grid_like
from cosmax_torch.likelihoods.fastmode import GL_ORDER, fast_mode
from cosmax_torch.models import recombination
from cosmax_torch.models.distances import (
    comoving_distance_gl,
    comoving_distance_trapz,
    hubble_distance,
    make_prefix_comoving_integral,
    volume_distance,
)
from cosmax_torch.ops.linalg import chi2_from_whitener
from cosmax_torch.ops.quadrature import trapz_grid_weights


@dataclass(frozen=True)
class RdFixed:
    """A fixed r_d in Mpc."""

    value: float

    def __call__(self, p):
        return self.value


@dataclass(frozen=True)
class RdParam:
    """r_d read from the sampled parameter ``name``, times ``scale``
    (bao.desi_des5y samples rd_h and fixes H0 = 1: r_d = 100 rd_h)."""

    name: str
    scale: float = 1.0

    def __call__(self, p):
        return p[self.name] if self.scale == 1.0 else p[self.name] * self.scale


@dataclass(frozen=True)
class RdOverH:
    """r_d = rd_h / h from the sampled product ``name`` = r_d h."""

    name: str = "rd_h"

    def __call__(self, p):
        return p[self.name] / (p["H0"] / 100.0)


@dataclass(frozen=True)
class RdFromRDrag:
    """r_d from a fitting formula of (wb, wm): ``which`` "aizpuru"
    (arXiv:2106.00428 eq 8) or "desi" (arXiv:2503.14738 eq 2, with
    ``n_eff``)."""

    which: str = "aizpuru"
    n_eff: float = 3.04

    def __post_init__(self):
        if self.which not in ("aizpuru", "desi"):
            raise ValueError(self.which)

    def __call__(self, p):
        wm = p["Om"] * (p["H0"] / 100.0) ** 2
        if self.which == "aizpuru":
            return recombination.r_drag_aizpuru(p["Obh2"], wm)
        return recombination.r_drag_desi(p["Obh2"], wm, self.n_eff)


@dataclass(frozen=True)
class RdFromZDrag:
    """r_d = r_s(z_drag(wb, wm)), GL of ``order`` nodes in the scale
    factor with this model's radiation-aware E(z) (needs 'Or' and
    'Obh2')."""

    model: str
    order: int = 128

    def __call__(self, p):
        wm = p["Om"] * (p["H0"] / 100.0) ** 2
        zd = recombination.z_drag(p["Obh2"], wm)
        return recombination.sound_horizon(zd, p, self.model, p["H0"], p["Obh2"], self.order)


def rd_fixed(value: float = 147.09) -> RdFixed:
    return RdFixed(value)


def rd_param(name: str = "rd") -> RdParam:
    return RdParam(name)


def rd_over_h(name: str = "rd_h") -> RdOverH:
    return RdOverH(name)


def rd_from_r_drag(which: str = "aizpuru", n_eff: float = 3.04) -> RdFromRDrag:
    return RdFromRDrag(which, n_eff)


def rd_from_z_drag(model: str, order: int = 128) -> RdFromZDrag:
    return RdFromZDrag(model, order)


def build_bao_term(
    dataset: CovDataset,
    model: str,
    rd_fn: Callable,
    device,
    dtype=torch.float32,
    grid: tuple = ("gl", GL_ORDER),
    name: str = "bao",
) -> Term:
    """grid: ('dyn_trapz', n_base) or ('fixed_trapz', n) — the parity
    paths matching the reference's per-script trapezoids —, ('gl',
    order), GL per data point, or ('emu',), the emulated fast path
    (always taken in fast mode)."""
    if fast_mode():
        grid = ("emu",)
    z = np.asarray(dataset.z, dtype=np.float64)
    qty = np.asarray(dataset.quantity)
    values = np.asarray(dataset.values, dtype=np.float64)
    meta = dict(
        n=dataset.n,
        legend=dataset.legend,
        plot_kind="bao",
        z=z,
        values=values,
        errors=np.sqrt(np.diag(dataset.cov)),
        quantity=qty,
        theory_curve=_theory_curve(model, rd_fn),
    )
    if grid[0] == "emu":
        return _build_emulated_bao(dataset, model, rd_fn, device, dtype, name, meta)
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
        name=name, chi2=chi2, elems_per_walker=elems, meta=dict(meta, constants=c),
    )


def _theory_curve(model, rd_fn):
    def theory_curve(p, z_grid, which):
        """Smooth D_{V,M,H}/r_d curve for plotting and the residual
        statistics (``which`` a quantity code): [W, len(z_grid)] at the
        walkers of ``p``, on their device, by GL-64 per point."""
        zg = grid_like(p, z_grid)
        dh = hubble_distance(zg, p, model)
        dm = comoving_distance_gl(zg, p, model, order=64)
        table = {QTY_DV: volume_distance(zg, dh, dm), QTY_DM: dm, QTY_DH: dh}
        rd = rd_fn(p)
        if isinstance(rd, torch.Tensor) and rd.dim() > 0:
            rd = rd[:, None]
        return table[int(which)] / rd

    return theory_curve


def _build_emulated_bao(dataset, model, rd_fn, device, dtype, name, meta):
    """chi^2 of the ('emu',) grid: t_hat at H0 = c, r_d = 1 (dh_hat =
    1/E, dm_hat = int dz/E by 16-node build panels, dv_hat their
    cube-root mix), whitened, tabulated by ``make_linear_chi2`` with
    beta = c/(H0 r_d) and beta_ref = c/(70 * 147.09)."""
    from cosmax_torch.models.background import e_of_z, expand_params
    from cosmax_torch.models.linear_chi2 import _hash_arrays, make_linear_chi2

    z, qty, values = meta["z"], meta["quantity"], meta["values"]
    linv = dataset.linv
    z_unique, z_inverse = np.unique(z, return_inverse=True)
    masks = np.stack([(qty == q).astype(np.float64) for q in (QTY_DH, QTY_DM, QTY_DV)])

    def curve_fn(flat, to_params):
        prefix = make_prefix_comoving_integral(z_unique, model, "cpu", torch.float64, order=16)
        p = to_params(torch.as_tensor(flat, dtype=torch.float64))
        zt = torch.as_tensor(z)
        dhh = (1.0 / e_of_z(zt, expand_params(p, 1), model)).numpy()
        dmh = prefix(p).numpy()[:, z_inverse]
        dvh = np.cbrt(z * dmh * dmh * dhh)
        t_hat = masks[0] * dhh + masks[1] * dmh + masks[2] * dvh
        return t_hat @ np.asarray(linv).T

    u0 = np.asarray(linv, np.float64) @ values
    chi2 = make_linear_chi2(
        model,
        curve_fn,
        tag=f"bao-{model}",
        key_extra=_hash_arrays(z, values, qty.astype(np.float64), linv),
        u0_c=u0,
        u0_sq=float(u0 @ u0),
        device=device,
        dtype=dtype,
        beta_fn=lambda p: C_KM_S / (p["H0"] * rd_fn(p)),
        beta_ref=C_KM_S / (70.0 * 147.09),
    )
    # rd_fn is one of the dataclasses above, for the fused kernel's packer
    return Term(name=name, chi2=chi2, meta=dict(meta, linear_chi2=chi2, rd=rd_fn))
