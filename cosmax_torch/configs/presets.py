"""Preset registry (counterpart of ``cosmax/configs/presets.py``).

All 45 of the reference's presets, each on the parity path and on the
fast path (``fast=True``) in all four models (lcdm, wcdm, wzcdm,
w0wacdm):

* the BAO family: ``bao.desi``, ``bao.sdss`` (the SDSS DR16 compilation),
  ``bao.desi_omh2``, ``bao.desi_bbn`` (r_d integrated from z_drag),
  ``bao.desi_bbn_theta_star``, ``bao.desi_omh2_theta_star`` (its
  ``z_star`` option), ``bao.desi_cc``, ``bao.desi_cmb`` (its
  ``compression`` option); the BAO + SN joints ``bao.desi_pantheon``
  (w0 sampled as exp(w0)), ``bao.desi_union3``, ``bao.desi_des5y``
  (H0-free: r_d h sampled, H0 = 1), their ``_cc`` variants, and
  ``bao.desi_union3_bbn`` / ``bao.desi_des5y_bbn`` (r_d from the drag
  fitting formulae), ``bao.desi_union3_omh2`` / ``bao.desi_des5y_omh2``;
* the BAO + CMB + SN joints ``bao.desi_cmb_pantheon``,
  ``bao.desi_cmb_union3`` and the flagship ``bao.desi_cmb_des5y``;
* the SN family: ``sn.pantheon``, ``sn.pantheon18``, ``sn.union3``,
  ``sn.union21``, ``sn.des5y`` and its binned ``sn.des5y_bins`` (a
  magnitude at a fixed H0 = 70), ``sn.pantheon_shoes`` (a sampled H0 and
  the Cepheid calibrators), and the SN + CMB fits ``sn.pantheon_cmb``,
  ``sn.union3_cmb``, ``sn.des5y_cmb`` (the radiation-aware E(z) with each
  compression's Omega_r h^2);
* the all-probe ``joint.multiprobe``, ``fs8.fs8``, the CC fits ``cc.cc``
  (CC with the Om h^2 prior), ``cc.cc_plain`` (the same without the f
  nuisance), ``cc.cc_cmb`` (always lcdm), and ``cc.cc_pantheon``,
  ``cc.cc_union3``, ``cc.cc_des5y`` (both f conventions of the CC term);
* the quasar fits (Lusso+2020, a magnitude offset and an intrinsic
  scatter, the stretch move alone; each takes ``sigma_mu_type``):
  ``qsr.pantheon`` and ``qsr.union3`` (22 bins with an SN set at a fixed
  H0 = 70), ``qsr.des5y`` (50 bins with DES-SN5YR), ``qsr.desi`` (22 bins
  with DESI BAO, H0 = 70 for every walker, a sampled r_d) and
  ``qsr.des5y_desi`` (the three probes);
* ``cmb.cmb``, a CMB compression alone (its ``compression`` option),
  always lcdm.

Each preset reproduces the reference script's parameter order, bounds,
grids, r_d treatment and radiation constants. The model is an argument:
for 'lcdm' w0 (or exp_w0) is dropped from the sampled vector, for
'w0wacdm' a wa parameter (-3, 2) follows it. ``get_preset`` passes a
preset's keyword options through.

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
from cosmax_torch.likelihoods.base import (
    ParamSpec,
    autograd_value_and_grad,
    make_chi2_breakdown,
    make_log_prob,
    walker_chunk,
)
from cosmax_torch.likelihoods.fastmode import use_fast_mode
from cosmax_torch.models.linear_chi2 import set_scope_domains
from cosmax_torch.samplers.ensemble import MoveSpec, default_moves, stretch_only

DE_PARAMS = ("w0", "wa", "exp_w0")  # the dark-energy parameters a model adds
WA_BOUNDS = (-3.0, 2.0)
W0_PARAMS = ("w0", "exp_w0")  # exp_w0: bao.desi_pantheon samples w0 as exp(w0)


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
            from cosmax_torch.utils.debugging import nan_checks_enabled, raise_on_bad_rows

            packed = pack(self)

            def log_prob(theta):
                out = fused_log_prob(packed, theta)
                if nan_checks_enabled():
                    # the fused kernel sums every term in one launch: the
                    # rows are what it can name
                    raise_on_bad_rows(out, self.spec.in_bounds(theta),
                                      f"the fused log-prob of {self.name}")
                return out

            return log_prob
        return make_log_prob(self.spec, self.terms, self.derive)

    def differentiable_log_prob(self):
        """``theta [W, D] -> logp [W]`` through the per-term torch
        functions, differentiable in theta (twice: the Hessians of
        ``samplers.optimize``) on either path. On the parity path this is
        ``log_prob()`` itself, its dense chi^2 terms through the chi^2
        kernel's autograd Function on the card; on the fast path it sums
        the emulated terms over the same bundle that the fused kernel's
        buffers are packed from (each split-grid contraction in f64 where
        the packer gives the kernel its f64 sweep)."""
        return make_log_prob(self.spec, self.terms, self.derive)

    def value_and_grad(self):
        """``theta [W, D] -> (logp [W], d logp / d theta [W, D])``, the
        batched potential of the gradient samplers.

        Parity path: autograd through ``differentiable_log_prob``; logp is
        its value. Fast path: logp comes from the fused kernel
        (``log_prob()``), the gradient from autograd through the per-term
        fast path over the same emulated terms. This keeps a sampler exact
        for the kernel's density: a leapfrog step with any deterministic
        gradient field g(y) is a composition of shears, (y, p) -> (y, p +
        eps g(y) / 2) and (y, p) -> (y + eps M^-1 p, p), so it preserves
        volume and is reversible whatever g is, and the Metropolis test on
        the kernel's values then targets the kernel's density exactly. The
        gradient's float32 error only moves the acceptance rate.

        Walkers are chunked here, forward and backward per chunk: autograd
        keeps every chunk's temporaries of ``chunked_log_like`` alive until
        the backward, so the chunk is the smallest ``walker_chunk`` of the
        terms (``TEMP_BYTES`` for a term's largest temporary)."""
        chunk = min(walker_chunk(t, self.dtype) for t in self.terms)
        grad = autograd_value_and_grad(self.differentiable_log_prob(), chunk)
        if not self.fast:
            return grad
        value = self.log_prob()

        def value_and_grad(theta):
            return value(theta), grad(theta)[1]

        return value_and_grad

    def chi2_breakdown(self):
        return make_chi2_breakdown(self.spec, self.terms, self.derive)

    @property
    def dof(self) -> int:
        return self.data_size - self.spec.dim


def _adjust_params(params: Sequence[tuple], model: str):
    out = [p for p in params if not (p[0] in W0_PARAMS and model == "lcdm")]
    if model == "w0wacdm":
        idx = next((i for i, p in enumerate(out) if p[0] in W0_PARAMS), None)
        if idx is not None:
            out.insert(idx + 1, ("wa", *WA_BOUNDS))
    return out


def _spec(params) -> ParamSpec:
    names = tuple(p[0] for p in params)
    bounds = np.array([[p[1], p[2]] for p in params], dtype=np.float64)
    return ParamSpec(names=names, bounds=bounds)


@dataclass(frozen=True)
class Derive:
    """The derived parameters of a preset: w0 = log(p[w0_log]) when
    ``w0_log`` is sampled; H0 = ``h0`` for every walker when set (the
    H0-free bao.desi_des5y), else H0 = h0_scale * p[h0_from] (unless H0
    is sampled itself); and, when ``orh2`` is set, the radiation Or =
    orh2 / h^2 of the radiation-aware E(z). Its fields are what the fused
    kernel's packer reads."""

    h0_from: str = "H0"
    h0_scale: float = 1.0
    orh2: Optional[float] = None
    h0: Optional[float] = None
    w0_log: Optional[str] = None

    def __call__(self, p):
        if self.w0_log is not None and self.w0_log in p:
            p = dict(p, w0=torch.log(p[self.w0_log]))
        if self.h0 is not None:
            p = dict(p, H0=torch.full_like(p["Om"], self.h0))
        elif self.h0_from != "H0":
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
    **kwargs,
) -> FitSpec:
    """Build a preset on ``device`` (float32 unless ``dtype`` says f64,
    which only the CPU takes). ``fast=True`` builds the emulated fast
    path: the preset's emulated terms share one emulator bundle over its
    own prior box. ``synthetic_sys=True`` adds the synthetic
    systematic covariance to SN datasets whose published one is absent
    (dense 1829^2 factor for DES-SN5YR; chi^2 not comparable to
    published values). ``kwargs`` go to the preset's builder (e.g.
    ``compression`` of bao.desi_cmb, ``z_star`` of
    bao.desi_omh2_theta_star, ``dataset`` of bao.desi)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {', '.join(list_presets())}")
    device, dtype = resolve(device, dtype)
    with use_synthetic_sys(synthetic_sys), use_fast_mode(fast):
        fit = PRESETS[name](model, device, dtype, **kwargs)
        if fast:
            # narrow the preset's bundle (not built yet: finalize runs at
            # scope exit) to its own prior box
            set_scope_domains({nm: tuple(b) for nm, b in zip(fit.spec.names, fit.spec.bounds)})
    fit = replace(fit, fast=fast)
    if fit.moves is None:
        fit = replace(fit, moves=default_moves())
    return fit


@_register("bao.desi", "bao/desi.py: rd=147.09 fixed, 300-pt dynamic trapezoids")
def _bao_desi(model, device, dtype, dataset="desi_dr2"):
    ds = load_bao(dataset)
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


ORH2_DESI = cmb_mod.COMPRESSIONS["desi"].omega_r_h2()


@_register("bao.sdss", "bao/desi.py run against the SDSS DR16 compilation")
def _bao_sdss(model, device, dtype, dataset="sdss_dr16_comp"):
    return replace(_bao_desi(model, device, dtype, dataset=dataset), name="bao.sdss",
                   note=PRESET_NOTES["bao.sdss"])


def _bao_term(ds, model, rd, device, dtype):
    """The BAO term of the DESI variants: 250-point dynamic trapezoids."""
    return bao_mod.build_bao_term(ds, model, rd, device, dtype, grid=("dyn_trapz", 250))


@_register("bao.desi_omh2", "bao/desi_omh2.py: free r_d + Planck Om h^2 prior")
def _bao_desi_omh2(model, device, dtype):
    ds = load_bao("desi_dr2")
    params = _adjust_params(
        [("h", 0.5, 0.8), ("Om", 0.1, 0.5), ("w0", -2, 0), ("rd", 130, 160)], model
    )
    terms = (_bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype), priors_mod.omh2_term())
    return FitSpec(
        "bao.desi_omh2", model, _spec(params), terms, Derive("h", 100.0), device, dtype,
        n_walkers=160, data_size=ds.n + 1, note=PRESET_NOTES["bao.desi_omh2"],
    )


@_register("bao.desi_bbn", "bao/desi_bbn.py: r_d integrated from z_drag, BBN(cyril) prior")
def _bao_desi_bbn(model, device, dtype):
    ds = load_bao("desi_dr2")
    params = _adjust_params(
        [("H0", 55, 75), ("Om", 0.17, 0.50), ("Obh2", 0.016, 0.030), ("w0", -2, 0)], model
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_from_z_drag(model), device, dtype),
        priors_mod.bbn_term("cyril"),
    )
    return FitSpec(
        "bao.desi_bbn", model, _spec(params), terms, Derive(orh2=ORH2_DESI), device, dtype,
        seed=42, data_size=ds.n + 1, note=PRESET_NOTES["bao.desi_bbn"],
    )


@_register("bao.desi_bbn_theta_star",
           "bao/desi_bbn_theta_star.py: free r_d + theta* + BBN(shonberg)")
def _bao_desi_bbn_theta(model, device, dtype):
    ds = load_bao("desi_dr2")
    params = _adjust_params(
        [("rd", 120, 160), ("H0", 55, 75), ("Om", 0.20, 0.50), ("Obh2", 0.020, 0.025),
         ("w0", -2, 0)],
        model,
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype),
        # the wider theta* error of bao/desi_bbn_theta_star.py:17, not
        # the Plik 0.00031
        cmb_mod.build_theta_star_term(model, theta_100_err=0.00053),
        priors_mod.bbn_term("shonberg"),
    )
    return FitSpec(
        "bao.desi_bbn_theta_star", model, _spec(params), terms, Derive(orh2=ORH2_DESI),
        device, dtype, seed=42, data_size=ds.n + 2,
        note=PRESET_NOTES["bao.desi_bbn_theta_star"],
    )


@_register("bao.desi_omh2_theta_star",
           "bao/desi_omh2_theta_star.py: free r_d + theta* + Om h^2 prior")
def _bao_desi_omh2_theta(model, device, dtype, z_star="aizpuru"):
    ds = load_bao("desi_dr2")
    params = _adjust_params(
        [("rd", 120, 160), ("H0", 60, 80), ("Om", 0.20, 0.50), ("Obh2", 0.015, 0.040),
         ("w0", -1.4, 0)],
        model,
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype),
        # z_star="hu" is the variant the published rows were run with
        # (their quoted z* is Hu & Sugiyama's); the default follows the
        # current reference code (Aizpuru A4)
        cmb_mod.build_theta_star_term(model, z_star=z_star),
        priors_mod.omh2_term(),
    )
    return FitSpec(
        "bao.desi_omh2_theta_star", model, _spec(params), terms, Derive(orh2=ORH2_DESI),
        device, dtype, data_size=ds.n + 2, note=PRESET_NOTES["bao.desi_omh2_theta_star"],
    )


@_register("bao.desi_cc", "bao/desi_cc.py: CC with f^-2 rescaling + logdet normalisation")
def _bao_desi_cc(model, device, dtype):
    ds = load_bao("desi_dr2")
    cc_ds = load_cc()
    params = _adjust_params(
        [("f_cc", 0.1, 1.5), ("H0", 45, 90), ("rd", 120, 175), ("Om", 0.2, 0.7),
         ("w0", -2, 1)],
        model,
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype),
        cc_mod.build_cc_term(cc_ds, model, "divide", device=device, dtype=dtype),
    )
    return FitSpec(
        "bao.desi_cc", model, _spec(params), terms, Derive(), device, dtype,
        data_size=ds.n + cc_ds.n, note=PRESET_NOTES["bao.desi_cc"],
    )


@_register("bao.desi_pantheon", "bao/desi_pantheon.py: rd fixed, w0 sampled as exp(w0)")
def _bao_desi_pantheon(model, device, dtype):
    """DESI + Pantheon+ with the exp(w0) sampling quirk
    (bao/desi_pantheon.py:27-31: rho_de's exponent uses log(exp_w0))."""
    ds = load_bao("desi_dr2")
    sn_ds = load_sn("pantheon_plus")
    params = _adjust_params(
        [("M", -20, -19), ("H0", 50, 80), ("Om", 0.2, 0.7), ("exp_w0", 0.2, 0.7)], model
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_fixed(147.09), device, dtype),
        sn_mod.build_sn_term(sn_ds, model, "M", h0="H0", device=device, dtype=dtype, name="sn"),
    )
    return FitSpec(
        "bao.desi_pantheon", model, _spec(params), terms, Derive(w0_log="exp_w0"), device,
        dtype, data_size=ds.n + sn_ds.n, note=PRESET_NOTES["bao.desi_pantheon"],
    )


@_register("bao.desi_union3", "bao/desi_union3.py: rd fixed 147.09")
def _bao_desi_union3(model, device, dtype):
    ds = load_bao("desi_dr2")
    sn_ds = load_sn("union3")
    params = _adjust_params(
        [("dM", -0.7, 0.7), ("H0", 60, 75), ("Om", 0.1, 0.6), ("w0", -2, 0)], model
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_fixed(147.09), device, dtype),
        sn_mod.build_sn_term(sn_ds, model, "dM", h0="H0", device=device, dtype=dtype,
                             use_z_hel=False, name="sn"),
    )
    return FitSpec(
        "bao.desi_union3", model, _spec(params), terms, Derive(), device, dtype,
        data_size=ds.n + sn_ds.n, note=PRESET_NOTES["bao.desi_union3"],
    )


@_register("bao.desi_des5y", "bao/desi_des5y.py: H0-free (H_z = E, theory / (rd_h * 100))")
def _bao_desi_des5y(model, device, dtype):
    """Fully H0-free: distances in h = 1 units, r_d h sampled
    (bao/desi_des5y.py:34-37, 76-87)."""
    ds = load_bao("desi_dr2")
    sn_ds = load_sn("des5y")
    params = _adjust_params(
        [("dM", -10, -8.5), ("rd_h", 90, 110), ("Om", 0.1, 0.7), ("w0", -2, 0)], model
    )
    terms = (
        _bao_term(ds, model, bao_mod.RdParam("rd_h", 100.0), device, dtype),
        sn_mod.build_sn_term(sn_ds, model, "dM", h0=None, device=device, dtype=dtype, name="sn"),
    )
    return FitSpec(
        "bao.desi_des5y", model, _spec(params), terms, Derive(h0=1.0), device, dtype,
        data_size=ds.n + sn_ds.effective_sample_size, note=PRESET_NOTES["bao.desi_des5y"],
    )


def _bao_sn_cc(name, sn_name, f_bounds, dm_bounds, h0_b, rd_b, om_b, w0_b, param_order, note):
    @_register(name, note)
    def build(model, device, dtype):
        ds = load_bao("desi_dr2")
        sn_ds = load_sn(sn_name)
        cc_ds = load_cc()
        by_name = {
            "f_cc": ("f_cc", *f_bounds),
            "dM": ("dM", *dm_bounds),
            "M": ("M", *dm_bounds),
            "H0": ("H0", *h0_b),
            "rd": ("rd", *rd_b),
            "Om": ("Om", *om_b),
            "w0": ("w0", *w0_b),
        }
        params = _adjust_params([by_name[n] for n in param_order], model)
        mag = "M" if "M" in param_order else "dM"
        terms = (
            _bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype),
            sn_mod.build_sn_term(sn_ds, model, mag, h0="H0", device=device, dtype=dtype,
                                 use_z_hel=sn_name != "union3", name="sn"),
            cc_mod.build_cc_term(
                cc_ds, model, "multiply" if name == "bao.desi_pantheon_cc" else "divide",
                device=device, dtype=dtype,
            ),
        )
        n_sn = getattr(sn_ds, "effective_sample_size", sn_ds.n)
        return FitSpec(
            name, model, _spec(params), terms, Derive(), device, dtype,
            data_size=ds.n + n_sn + cc_ds.n, note=note,
        )

    return build


_bao_sn_cc(
    "bao.desi_pantheon_cc", "pantheon_plus", (0.4, 2.5), (-20, -19),
    (45, 85), (115, 170), (0.15, 0.7), (-3, 0),
    ["H0", "M", "rd", "Om", "w0", "f_cc"],
    "bao/desi_pantheon_cc.py: CC with f^2 convention (result f=1.47)",
)
_bao_sn_cc(
    "bao.desi_union3_cc", "union3", (0.1, 1.5), (-0.7, 0.7),
    (55, 80), (125, 170), (0.2, 0.7), (-2, 1),
    ["f_cc", "dM", "H0", "rd", "Om", "w0"],
    "bao/desi_union3_cc.py: CC with f^-2 convention",
)
_bao_sn_cc(
    "bao.desi_des5y_cc", "des5y", (0.1, 1.5), (-0.55, 0.55),
    (50, 80), (110, 175), (0.2, 0.7), (-2, 0),
    ["f_cc", "dM", "H0", "rd", "Om", "w0"],
    "bao/desi_des5y_cc.py: CC with f^-2 convention",
)


@_register("bao.desi_cmb", "bao/desi_cmb.py with the chen compression")
def _bao_desi_cmb(model, device, dtype, compression="chen"):
    ds = load_bao("desi_dr2")
    comp = cmb_mod.COMPRESSIONS[compression]
    params = _adjust_params(
        [("rd", 120, 160), ("H0", 55, 75), ("Om", 0.25, 0.45), ("Obh2", 0.021, 0.023),
         ("w0", -1.5, 0)],
        model,
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype),
        cmb_mod.build_cmb_term(compression, model, device, dtype),
    )
    return FitSpec(
        "bao.desi_cmb", model, _spec(params), terms, Derive(orh2=comp.omega_r_h2()), device,
        dtype, data_size=ds.n + 3, note=f"bao/desi_cmb.py with the {compression} compression",
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


def _bao_sn_bbn(name, sn_name, rd_formula, note, use_z_hel=True, h0_lo=55):
    @_register(name, note)
    def build(model, device, dtype):
        ds = load_bao("desi_dr2")
        sn_ds = load_sn(sn_name)
        params = _adjust_params(
            [("H0", h0_lo, 75), ("Om", 0.1, 0.6), ("Obh2", 0.019, 0.025), ("w0", -2, 0),
             ("dM", -0.7, 0.7)],
            model,
        )
        terms = (
            _bao_term(ds, model, bao_mod.rd_from_r_drag(rd_formula), device, dtype),
            sn_mod.build_sn_term(sn_ds, model, "dM", h0="H0", device=device, dtype=dtype,
                                 use_z_hel=use_z_hel, name="sn"),
            priors_mod.bbn_term("shonberg"),
        )
        n_sn = getattr(sn_ds, "effective_sample_size", sn_ds.n)
        return FitSpec(
            name, model, _spec(params), terms, Derive(), device, dtype,
            data_size=ds.n + n_sn + 1, note=note,
        )

    return build


_bao_sn_bbn(
    "bao.desi_union3_bbn", "union3", "aizpuru",
    "bao/desi_union3_bbn.py: r_d from the Aizpuru fitting formula", use_z_hel=False,
)
# rd_from_r_drag's n_eff 3.04 (the reference script's), not r_drag_desi's 3.044
_bao_sn_bbn(
    "bao.desi_des5y_bbn", "des5y", "desi",
    "bao/desi_des5y_bbn.py: r_d from the DESI DR2 fitting formula (n_eff 3.04)", h0_lo=60,
)


@_register("bao.desi_union3_omh2", "bao/desi_union3_omh2.py")
def _bao_desi_union3_omh2(model, device, dtype):
    ds = load_bao("desi_dr2")
    sn_ds = load_sn("union3")
    params = _adjust_params(
        [("rd", 120, 160), ("H0", 60, 75), ("Om", 0.1, 0.6), ("w0", -2, 0), ("dM", -0.7, 0.7)],
        model,
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype),
        sn_mod.build_sn_term(sn_ds, model, "dM", h0="H0", device=device, dtype=dtype,
                             use_z_hel=False, name="sn"),
        priors_mod.omh2_term(),
    )
    return FitSpec(
        "bao.desi_union3_omh2", model, _spec(params), terms, Derive(), device, dtype,
        data_size=ds.n + sn_ds.n + 1, note=PRESET_NOTES["bao.desi_union3_omh2"],
    )


@_register("bao.desi_des5y_omh2", "bao/desi_des5y_omh2.py: seed 42")
def _bao_desi_des5y_omh2(model, device, dtype):
    ds = load_bao("desi_dr2")
    sn_ds = load_sn("des5y")
    params = _adjust_params(
        [("dM", -0.6, 0.6), ("rd", 120, 160), ("H0", 60, 80), ("Om", 0.1, 0.7), ("w0", -2, 0)],
        model,
    )
    terms = (
        _bao_term(ds, model, bao_mod.rd_param("rd"), device, dtype),
        sn_mod.build_sn_term(sn_ds, model, "dM", h0="H0", device=device, dtype=dtype, name="sn"),
        priors_mod.omh2_term(),
    )
    return FitSpec(
        "bao.desi_des5y_omh2", model, _spec(params), terms, Derive(), device, dtype, seed=42,
        data_size=ds.n + sn_ds.effective_sample_size + 1,
        note=PRESET_NOTES["bao.desi_des5y_omh2"],
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


@_register("cc.cc_plain", "cc.py docstring variant without the f nuisance")
def _cc_plain(model, device, dtype):
    ds = load_cc()
    params = _adjust_params([("H0", 50, 90), ("Om", 0.15, 0.50), ("w0", -2.5, 0)], model)
    terms = (
        cc_mod.build_cc_term(ds, model, device=device, dtype=dtype, f_param=None),
        priors_mod.omh2_term(),
    )
    return FitSpec(
        "cc.cc_plain", model, _spec(params), terms, Derive(), device, dtype,
        data_size=ds.n + 1, note=PRESET_NOTES["cc.cc_plain"],
    )


ORH2_CHEN = cmb_mod.COMPRESSIONS["chen"].omega_r_h2()
ORH2_ACT = cmb_mod.COMPRESSIONS["act"].omega_r_h2()
ORH2_UNION3 = cmb_mod.COMPRESSIONS["union3"].omega_r_h2()


@_register("cc.cc_cmb", "cosmic_chronometers/cc_cmb.py: LCDM only")
def _cc_cmb(model, device, dtype):
    """CC + CMB(chen); the reference hard-codes LCDM here
    (cosmic_chronometers/cc_cmb.py:22 rho_de = 1), whatever ``model``."""
    model = "lcdm"
    ds = load_cc()
    params = [("H0", 50, 85), ("Om", 0.1, 0.45), ("Obh2", 0.0210, 0.0235), ("f_cc", 0.1, 1.5)]
    terms = (
        cc_mod.build_cc_term(ds, model, "divide", device=device, dtype=dtype),
        cmb_mod.build_cmb_term("chen", model, device, dtype),
    )
    return FitSpec(
        "cc.cc_cmb", model, _spec(params), terms, Derive(orh2=ORH2_CHEN), device, dtype,
        data_size=ds.n + 3, note=PRESET_NOTES["cc.cc_cmb"],
    )


def _cc_sn(name, sn_name, f_bounds, mag, mag_bounds, h0_b, om_b, convention, note,
           use_z_hel=True):
    """CC + SN; an absolute magnitude M follows H0, an offset dM comes
    before it (the reference's parameter order)."""
    @_register(name, note)
    def build(model, device, dtype):
        cc_ds = load_cc()
        sn_ds = load_sn(sn_name)
        params = _adjust_params(
            [
                ("f_cc", *f_bounds),
                *([] if mag == "M" else [(mag, *mag_bounds)]),
                ("H0", *h0_b),
                *([(mag, *mag_bounds)] if mag == "M" else []),
                ("Om", *om_b),
                ("w0", -2, 0),
            ],
            model,
        )
        terms = (
            sn_mod.build_sn_term(sn_ds, model, mag, h0="H0", device=device, dtype=dtype,
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
    "cc.cc_pantheon", "pantheon_plus", (0.1, 1.5), "M", (-20, -19), (55, 80), (0.15, 0.70),
    "divide", "cosmic_chronometers/cc_pantheon.py: f^-2 convention",
)
_cc_sn(
    "cc.cc_union3", "union3", (0.4, 2.5), "dM", (-0.7, 0.5), (55, 80), (0.1, 0.7), "divide",
    "cosmic_chronometers/cc_union3.py: f^-2 convention", use_z_hel=False,
)
_cc_sn(
    "cc.cc_des5y", "des5y", (0.4, 2.5), "dM", (-0.55, 0.55), (55, 80), (0.1, 0.6), "multiply",
    "cosmic_chronometers/cc_des5y.py: inverse f^2 convention (result f=1.47)",
)


def _sn_only(name, sn_name, params, note, h0=70.0, use_z_hel=True, **fit_kw):
    """An SN-only fit whose first parameter is the magnitude (M or the
    offset dM), at a fixed H0, or (``h0="H0"``) beside a sampled H0 with
    the Cepheid rows."""
    @_register(name, note)
    def build(model, device, dtype):
        ds = load_sn(sn_name)
        terms = (
            sn_mod.build_sn_term(ds, model, params[0][0], h0=h0, device=device, dtype=dtype,
                                 use_z_hel=use_z_hel, cepheids=h0 == "H0", name="sn"),
        )
        return FitSpec(
            name, model, _spec(_adjust_params(params, model)), terms, Derive(), device, dtype,
            data_size=getattr(ds, "effective_sample_size", ds.n), note=note, **fit_kw,
        )

    return build


_sn_only("sn.pantheon", "pantheon_plus", [("M", -20, -19), ("Om", 0, 1), ("w0", -2, 0)],
         "sn/pantheon.py: M + fixed H0=70, full covariance")
_sn_only("sn.pantheon_shoes", "pantheon_plus_shoes",
         [("M", -19.5, -19.0), ("H0", 60, 85), ("Om", 0.1, 0.6), ("w0", -2, 0)],
         "sn/pantheon_and_sh0es.py: Cepheid anchor, move weights 0.5/0.4/0.1", h0="H0",
         n_walkers=500,
         moves=(MoveSpec("kde", 0.5), MoveSpec("de", 0.4), MoveSpec("snooker", 0.1)))
_sn_only("sn.union3", "union3", [("dM", -0.6, 0.6), ("Om", 0, 1), ("w0", -2, 0)],
         "sn/union3.py: dM + fixed H0=70, (1+z_cmb) convention", use_z_hel=False)
_sn_only("sn.des5y", "des5y", [("dM", -0.2, 0.2), ("Om", 0, 0.8), ("w0", -2, 0)],
         "sn/des5y.py: dM + fixed H0=70; dof uses effective sample size 1735",
         n_steps=1700)
_sn_only("sn.union21", "union21", [("dM", -0.6, 0.6), ("Om", 0, 1), ("w0", -2, 0)],
         "Union2.1 mu with dM offset (y2011union2 loader)", use_z_hel=False)
_sn_only("sn.pantheon18", "pantheon18", [("M", -20, -19), ("Om", 0, 1), ("w0", -2, 0)],
         "Pantheon 2018 apparent magnitudes (y2018pantheon loader)")
_sn_only("sn.des5y_bins", "des5y_bins", [("dM", -0.2, 0.2), ("Om", 0, 0.8), ("w0", -2, 0)],
         "y2024DES/data_bins.py binned compression (no reference script)")


def _sn_cmb(name, sn_name, compression, orh2, om_b, mag, use_z_hel=True):
    """SN + a CMB compression with the radiation-aware E(z), Or = orh2 /
    h^2 with the compression's own Omega_r h^2."""
    note = f"{compression} compression + {sn_name}, radiation-aware E(z)"

    @_register(name, note)
    def build(model, device, dtype):
        ds = load_sn(sn_name)
        params = _adjust_params(
            [
                ("H0", 60, 75),
                ("Om", *om_b),
                ("Obh2", 0.019 if mag == "dM" else 0.020, 0.025),
                ("w0", -2, 0),
                (mag, *((-0.7, 0.7) if mag == "dM" else (-20, -19))),
            ],
            model,
        )
        terms = (
            cmb_mod.build_cmb_term(compression, model, device, dtype),
            sn_mod.build_sn_term(ds, model, mag, h0="H0", device=device, dtype=dtype,
                                 use_z_hel=use_z_hel, name="sn"),
        )
        return FitSpec(
            name, model, _spec(params), terms, Derive(orh2=orh2), device, dtype,
            data_size=ds.n + 3, note=note,
        )

    return build


_sn_cmb("sn.pantheon_cmb", "pantheon_plus", "chen", ORH2_CHEN, (0.15, 0.40), "M")
_sn_cmb("sn.union3_cmb", "union3", "union3", ORH2_UNION3, (0.1, 0.45), "dM", use_z_hel=False)
_sn_cmb("sn.des5y_cmb", "des5y", "chen", ORH2_CHEN, (0.1, 0.6), "dM")


def _qsr(name, n_bins, params, note, sn=None, bao=False):
    """Quasars (a magnitude offset dM_qsr and a scatter s first) with an
    SN set at a fixed H0 = 70 (``sn``: (dataset, magnitude, use_z_hel,
    SN grid points)) and/or DESI BAO with a sampled r_d, H0 = 70 for every
    walker; 8 walkers a parameter, the stretch move alone."""
    @_register(name, note)
    def build(model, device, dtype, sigma_mu_type="sem_errors"):
        _, z, mu, sig = load_quasars(n_bins, sigma_mu_type)
        terms = [qsr_mod.build_quasar_term(z, mu, sig, model, device=device, dtype=dtype)]
        size = z.size
        if sn is not None:
            sn_name, mag, use_z_hel, grid_num = sn
            sn_ds = load_sn(sn_name)
            terms.append(sn_mod.build_sn_term(sn_ds, model, mag, h0=70.0, device=device,
                                              dtype=dtype, use_z_hel=use_z_hel,
                                              grid_num=grid_num, name="sn"))
            size += getattr(sn_ds, "effective_sample_size", sn_ds.n)
        if bao:
            bao_ds = load_bao("desi_dr2")
            terms.append(bao_mod.build_bao_term(bao_ds, model, bao_mod.rd_param("rd"), device,
                                                dtype, grid=("fixed_trapz", 3000)))
            size += bao_ds.n
        adjusted = _adjust_params(params, model)
        return FitSpec(
            name, model, _spec(adjusted), tuple(terms), Derive(h0=70.0) if bao else Derive(),
            device, dtype, n_walkers=8 * len(adjusted), n_steps=10000, burn_in=2000,
            moves=stretch_only(), data_size=size, note=note,
        )

    return build


_qsr("qsr.pantheon", 22,
     [("dM_qsr", -0.5, 0.5), ("s", 0, 3), ("M", -20, -19), ("Om", 0, 1), ("w0", -4, 0)],
     "quasars/qsr_pantheon.py: 22 bins, default StretchMove",
     sn=("pantheon_plus", "M", True, 1000))
_qsr("qsr.union3", 22,
     [("dM_qsr", -0.5, 0.5), ("s", 0, 2.5), ("dM", -0.4, 0.3), ("Om", 0, 1), ("w0", -3, 0)],
     "quasars/qsr_union3.py", sn=("union3", "dM", False, 1000))
_qsr("qsr.des5y", 50,
     [("dM_qsr", -0.5, 0.5), ("s", 0, 3), ("dM", -0.6, 0.6), ("Om", 0, 0.8), ("w0", -2, 0)],
     "quasars/qsr_des5y.py: 50 quasar bins", sn=("des5y", "dM", True, 1000))
_qsr("qsr.desi", 22,
     [("dM_qsr", -0.6, 0.5), ("s", 0, 1.5), ("rd", 110, 155), ("Om", 0, 0.6), ("w0", -1.6, 0)],
     "quasars/qsr_desi.py: H0=70 fixed, 3000-pt grids", bao=True)
_qsr("qsr.des5y_desi", 22,
     [("dM_qsr", -1, 1), ("s", 0, 2.5), ("dM", -0.6, 0.6), ("rd", 110, 170), ("Om", 0, 0.6),
      ("w0", -1.5, 0)],
     "quasars/qsr_des5y_desi.py: three-probe with H0=70 fixed",
     sn=("des5y", "dM", True, 3000), bao=True)


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


@_register("cmb.cmb", "cmb/cmb.py with the chen compression")
def _cmb_cmb(model, device, dtype, compression="chen"):
    """A CMB compression alone; the reference's E(z) is LCDM only
    (cmb/cmb.py:12-19), whatever ``model``."""
    model = "lcdm"
    comp = cmb_mod.COMPRESSIONS[compression]
    params = [("H0", 60, 70), ("Om", 0.15, 0.45), ("Obh2", 0.020, 0.024)]
    terms = (cmb_mod.build_cmb_term(compression, model, device, dtype),)
    return FitSpec(
        "cmb.cmb", model, _spec(params), terms, Derive(orh2=comp.omega_r_h2()), device, dtype,
        n_walkers=200, data_size=3, note=f"cmb/cmb.py with the {compression} compression",
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
        Derive(orh2=ORH2_DESI), device, dtype,
        n_walkers=256, n_steps=2200,
        data_size=(bao_ds.n + 3 + sn_ds.effective_sample_size + cc_ds.n + qz.size + fs8_ds.n),
        note=PRESET_NOTES["joint.multiprobe"],
    )
