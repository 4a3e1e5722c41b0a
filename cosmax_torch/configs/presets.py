"""Preset registry (counterpart of ``cosmax/configs/presets.py``).

Ported so far: ``bao.desi``, the three BAO + CMB + SN joints
(``bao.desi_cmb_pantheon``, ``bao.desi_cmb_union3`` and the flagship
``bao.desi_cmb_des5y``), the all-probe ``joint.multiprobe``, ``fs8.fs8``,
``cc.cc_union3`` and ``cc.cc_des5y`` (both f conventions of the CC
term) and ``cc.cc`` (CC with the Om h^2 prior), each on the parity path
and on the fast path (``fast=True``) in all four models (lcdm, wcdm,
wzcdm, w0wacdm). Each preset reproduces the reference script's parameter
order, bounds, grids, r_d treatment and radiation constants. The model
is an argument: for 'lcdm' w0 is dropped from the sampled vector, for
'w0wacdm' a wa parameter (-3, 2) follows w0.

Build-time constants are f64 numpy, turned into tensors once per preset
on the chosen device and dtype. A fast preset's ``log_prob`` is the
fused log-prob (``ops/kernels/fused_log_prob.py``): one CUDA kernel
launch per call on the card.
"""

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cosmax_torch.data.loaders import (
    load_bao,
    load_cc,
    load_fs8,
    load_quasars,
    load_sn,
    use_synthetic_sys,
)
from cosmax_torch.device import resolve
from cosmax_torch.likelihoods import bao as bao_mod
from cosmax_torch.likelihoods import cc as cc_mod
from cosmax_torch.likelihoods import cmb as cmb_mod
from cosmax_torch.likelihoods import fs8 as fs8_mod
from cosmax_torch.likelihoods import priors as priors_mod
from cosmax_torch.likelihoods import quasars as qsr_mod
from cosmax_torch.likelihoods import sn as sn_mod
from cosmax_torch.likelihoods.base import ParamSpec, make_chi2_breakdown, make_log_prob
from cosmax_torch.likelihoods.fastmode import use_fast_mode
from cosmax_torch.models.linear_chi2 import set_scope_domains
from cosmax_torch.samplers.ensemble import default_moves

WA_BOUNDS = (-3.0, 2.0)


@dataclass(frozen=True)
class FitSpec:
    """A fully specified fit: sampled parameters, likelihood terms, and
    the reference sampler configuration, with constants on ``device``."""

    name: str
    model: str
    spec: ParamSpec
    terms: tuple
    derive: Callable
    device: torch.device
    dtype: torch.dtype
    n_walkers: int = 150
    n_steps: int = 2200
    burn_in: int = 200
    moves: tuple = None
    seed: Optional[int] = None
    note: str = ""
    data_size: int = 0
    fast: bool = False

    def log_prob(self):
        """``theta [W, D] -> logp [W]``. A fast preset packs its constants
        once here and evaluates the fused log-prob; the parity path sums
        the per-term torch functions."""
        if self.fast:
            from cosmax_torch.ops.kernels.fused_log_prob import fused_log_prob, pack

            packed = pack(self)
            return lambda theta: fused_log_prob(packed, theta)
        return make_log_prob(self.spec, self.terms, self.derive)

    def chi2_breakdown(self):
        return make_chi2_breakdown(self.spec, self.terms, self.derive)

    @property
    def dof(self) -> int:
        return self.data_size - self.spec.dim


def _adjust_params(params: Sequence[tuple], model: str):
    out = [p for p in params if not (p[0] == "w0" and model == "lcdm")]
    if model == "w0wacdm":
        idx = next((i for i, p in enumerate(out) if p[0] == "w0"), None)
        if idx is not None:
            out.insert(idx + 1, ("wa", *WA_BOUNDS))
    return out


def _spec(params) -> ParamSpec:
    names = tuple(p[0] for p in params)
    bounds = np.array([[p[1], p[2]] for p in params], dtype=np.float64)
    return ParamSpec(names=names, bounds=bounds)


@dataclass(frozen=True)
class Derive:
    """The derived parameters of a preset: H0 = h0_scale * p[h0_from]
    (unless H0 is sampled itself) and, when ``orh2`` is set, the
    radiation Or = orh2 / h^2 of the radiation-aware E(z). Its fields are
    what the fused kernel's packer reads."""

    h0_from: str = "H0"
    h0_scale: float = 1.0
    orh2: Optional[float] = None

    def __call__(self, p):
        if self.h0_from != "H0":
            p = dict(p, H0=self.h0_scale * p[self.h0_from])
        if self.orh2 is not None:
            p = dict(p, Or=self.orh2 / (p["H0"] / 100.0) ** 2)
        return p


PRESETS = {}
PRESET_NOTES = {}


def _register(name, note):
    def wrap(build_fn):
        PRESETS[name] = build_fn
        PRESET_NOTES[name] = note
        return build_fn

    return wrap


def list_presets():
    return sorted(PRESETS)


def get_preset(
    name: str,
    model: str = "wzcdm",
    fast: bool = False,
    synthetic_sys: bool = False,
    device="cuda",
    dtype=None,
) -> FitSpec:
    """Build a preset on ``device`` (float32 unless ``dtype`` says f64,
    which only the CPU takes). ``fast=True`` builds the emulated fast
    path: the preset's emulated terms share one emulator bundle over its
    own prior box. ``synthetic_sys=True`` adds the synthetic
    systematic covariance to SN datasets whose published one is absent
    (dense 1829^2 factor for DES-SN5YR; chi^2 not comparable to
    published values)."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown or unported preset {name!r}; ported: {', '.join(list_presets())}"
        )
    device, dtype = resolve(device, dtype)
    with use_synthetic_sys(synthetic_sys), use_fast_mode(fast):
        fit = PRESETS[name](model, device, dtype)
        if fast:
            # narrow the preset's bundle (not built yet: finalize runs at
            # scope exit) to its own prior box
            set_scope_domains({nm: tuple(b) for nm, b in zip(fit.spec.names, fit.spec.bounds)})
    fit = replace(fit, fast=fast)
    if fit.moves is None:
        fit = replace(fit, moves=default_moves())
    return fit


@_register("bao.desi", "bao/desi.py: rd=147.09 fixed, 300-pt dynamic trapezoids")
def _bao_desi(model, device, dtype):
    ds = load_bao("desi_dr2")
    params = _adjust_params([("h", 0.5, 0.8), ("Om", 0.1, 0.7), ("w0", -2, 0)], model)
    terms = (
        bao_mod.build_bao_term(
            ds, model, bao_mod.rd_fixed(147.09), device, dtype,
            grid=("dyn_trapz", 300),
        ),
    )
    return FitSpec(
        "bao.desi", model, _spec(params), terms, Derive("h", 100.0), device, dtype,
        data_size=ds.n, note=PRESET_NOTES["bao.desi"],
    )


def _bao_cmb_sn(name, sn_name, compression, mag, w0_hi, note, use_z_hel=True):
    @_register(name, note)
    def build(model, device, dtype):
        ds = load_bao("desi_dr2")
        sn_ds = load_sn(sn_name)
        comp = cmb_mod.COMPRESSIONS[compression]
        params = _adjust_params(
            [
                ("rd", 120, 160),
                ("H0", 60, 75),
                ("Om", 0.1, 0.6),
                ("Obh2", 0.019, 0.025),
                ("w0", -2, w0_hi),
                (mag, *((-0.7, 0.7) if mag == "dM" else (-20, -19))),
            ],
            model,
        )
        terms = (
            bao_mod.build_bao_term(
                ds, model, bao_mod.rd_param("rd"), device, dtype,
                grid=("dyn_trapz", 250),
            ),
            cmb_mod.build_cmb_term(compression, model, device, dtype),
            sn_mod.build_sn_term(
                sn_ds, model, mag, h0="H0", device=device, dtype=dtype,
                use_z_hel=use_z_hel, name="sn",
            ),
        )
        n_sn = getattr(sn_ds, "effective_sample_size", sn_ds.n)
        return FitSpec(
            name, model, _spec(params), terms, Derive(orh2=comp.omega_r_h2()),
            device, dtype,
            seed=42 if name == "bao.desi_cmb_union3" else None,
            data_size=ds.n + 3 + n_sn, note=note,
        )

    return build


_bao_cmb_sn(
    "bao.desi_cmb_pantheon", "pantheon_plus", "chen", "M", 0.0,
    "bao/desi_cmb_pantheon.py: chen compression",
)
_bao_cmb_sn(
    "bao.desi_cmb_union3", "union3", "desi", "dM", 0.5,
    "bao/desi_cmb_union3.py: desi compression, seed 42", use_z_hel=False,
)
_bao_cmb_sn(
    "bao.desi_cmb_des5y", "des5y", "desi", "dM", 0.0,
    "bao/desi_cmb_des5y.py: the flagship three-probe joint",
)


@_register("cc.cc", "cosmic_chronometers/cc.py: f^-2 rescaling + Om h^2 prior")
def _cc_cc(model, device, dtype):
    ds = load_cc()
    params = _adjust_params(
        [("H0", 50, 90), ("Om", 0.15, 0.50), ("w0", -2.5, 0), ("f_cc", 0.1, 1.5)], model
    )
    terms = (
        cc_mod.build_cc_term(ds, model, "divide", device=device, dtype=dtype),
        priors_mod.omh2_term(),
    )
    return FitSpec(
        "cc.cc", model, _spec(params), terms, Derive(), device, dtype, data_size=ds.n + 1,
        note=PRESET_NOTES["cc.cc"],
    )


def _cc_sn(name, sn_name, f_bounds, mag_bounds, h0_b, om_b, convention, note,
           use_z_hel=True):
    @_register(name, note)
    def build(model, device, dtype):
        cc_ds = load_cc()
        sn_ds = load_sn(sn_name)
        params = _adjust_params(
            [
                ("f_cc", *f_bounds),
                ("dM", *mag_bounds),
                ("H0", *h0_b),
                ("Om", *om_b),
                ("w0", -2, 0),
            ],
            model,
        )
        terms = (
            sn_mod.build_sn_term(sn_ds, model, "dM", h0="H0", device=device, dtype=dtype,
                                 use_z_hel=use_z_hel, name="sn"),
            cc_mod.build_cc_term(cc_ds, model, convention, device=device, dtype=dtype),
        )
        n_sn = getattr(sn_ds, "effective_sample_size", sn_ds.n)
        return FitSpec(
            name, model, _spec(params), terms, Derive(), device, dtype,
            data_size=cc_ds.n + n_sn, note=note,
        )

    return build


_cc_sn(
    "cc.cc_union3", "union3", (0.4, 2.5), (-0.7, 0.5), (55, 80), (0.1, 0.7), "divide",
    "cosmic_chronometers/cc_union3.py: f^-2 convention", use_z_hel=False,
)
_cc_sn(
    "cc.cc_des5y", "des5y", (0.4, 2.5), (-0.55, 0.55), (55, 80), (0.1, 0.6), "multiply",
    "cosmic_chronometers/cc_des5y.py: inverse f^2 convention (result f=1.47)",
)


@_register("fs8.fs8", "fs8/fs8.py: growth ODE + AP correction, seed 42")
def _fs8(model, device, dtype):
    ds = load_fs8()
    params = _adjust_params(
        [("Om", 0.1, 0.6), ("sigma8", 0.2, 1.2), ("w0", -2.5, 0), ("f_err", 0.1, 1.5)], model
    )
    terms = (fs8_mod.build_fs8_term(ds, model, device=device, dtype=dtype),)
    return FitSpec(
        "fs8.fs8", model, _spec(params), terms, Derive(), device, dtype,
        n_walkers=50, n_steps=1100, burn_in=100, seed=42, data_size=ds.n,
        note=PRESET_NOTES["fs8.fs8"],
    )


@_register(
    "joint.multiprobe",
    "all-probe joint (cosmax composition; BASELINE north-star config)",
)
def _joint_multiprobe(model, device, dtype):
    """DES-SN5YR + DESI DR2 BAO + CMB(desi) + cosmic chronometers +
    quasars + fsigma8 on one background cosmology; the nuisances follow
    the single-probe presets (reference presets.py:1087-1131)."""
    bao_ds = load_bao("desi_dr2")
    sn_ds = load_sn("des5y")
    cc_ds = load_cc()
    fs8_ds = load_fs8()
    _, qz, qmu, qsig = load_quasars(22)
    params = _adjust_params(
        [
            ("rd", 120, 160),
            ("H0", 60, 80),
            ("Om", 0.1, 0.6),
            ("Obh2", 0.019, 0.025),
            ("w0", -2, 0),
            ("dM", -0.7, 0.7),
            ("dM_qsr", -0.6, 0.6),
            ("s", 0.0, 1.5),
            ("f_cc", 0.1, 1.5),
            ("sigma8", 0.2, 1.2),
            ("f_err", 0.1, 1.5),
        ],
        model,
    )
    dev = dict(device=device, dtype=dtype)
    terms = (
        bao_mod.build_bao_term(bao_ds, model, bao_mod.rd_param("rd"), grid=("dyn_trapz", 250),
                               **dev),
        cmb_mod.build_cmb_term("desi", model, **dev),
        sn_mod.build_sn_term(sn_ds, model, "dM", h0="H0", name="sn", **dev),
        cc_mod.build_cc_term(cc_ds, model, "divide", **dev),
        qsr_mod.build_quasar_term(qz, qmu, qsig, model, **dev),
        fs8_mod.build_fs8_term(fs8_ds, model, **dev),
    )
    return FitSpec(
        "joint.multiprobe", model, _spec(params), terms,
        Derive(orh2=cmb_mod.COMPRESSIONS["desi"].omega_r_h2()), device, dtype,
        n_walkers=256, n_steps=2200,
        data_size=(bao_ds.n + 3 + sn_ds.effective_sample_size + cc_ds.n + qz.size + fs8_ds.n),
        note=PRESET_NOTES["joint.multiprobe"],
    )
