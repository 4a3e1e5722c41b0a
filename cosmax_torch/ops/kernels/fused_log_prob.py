"""The fused fast log-prob: logp[W] for walkers theta[W, D] of a fast preset.

The card's implementation is the hand-written CUDA kernel in
``cosmax_torch/csrc/fused_log_prob.cu``, one thread per walker. It
replaces the TPU kernel ``cosmax/ops/pallas/megakernel.py::blocked_log_prob``
(the source note there says what bounds it on an H100 and how the design
answers that). This module holds

* the **packer** ``pack(fit)``: from a fast ``FitSpec``, the flat
  constant buffer that the kernel copies into shared memory, with a
  header of offsets and sizes (``HEADER``), the bundle's barycentric
  axes, Tucker factors and core, each linear-chi^2 form, the CMB
  compression and its Gauss-Legendre rules, the bounds and the derived
  parameters. It raises for what the kernel does not take;
* the **plain version** ``fused_log_prob_reference(packed, theta)``: the
  same function in plain torch ops over the same buffer;
* the **wrapper** ``fused_log_prob(packed, theta)``: CPU tensors take the
  plain version, CUDA tensors launch the kernel or raise. There is no
  fallback from the kernel to the plain version.

The buffer is in the fit's dtype: float32 on the card (the f64 build
constants cast once, as the per-term path casts them), float64 for the
CPU parity tests.
"""

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.models.emu_core import OR_REF, bary_vector
from cosmax_torch.ops.quadrature import gl_nodes_01

# Kernel launches made by ``fused_log_prob`` since the last reset; a run
# reads it to show that its main path went through the kernel.
LAUNCHES = 0

# Compiled maxima of the kernel (``csrc/fused_log_prob.cu`` has the same
# values; a CPU test holds the two files together). The packer refuses
# anything larger.
MAX_DIM = 16  # sampled parameters
MAX_NODES = 64  # Chebyshev nodes per emulator axis
MAX_RANK = 16  # Tucker rank per axis
MAX_RALL = 64  # coefficient columns, padded to a multiple of 4
MAX_FORMS = 4  # linear-chi^2 terms
MAX_GL = 64  # nodes of each CMB quadrature
MAX_FLOATS = 40960  # constant-buffer floats (160 KB of shared memory)

# Header slots of the buffer (floats holding small integers or values).
HEADER = dict(
    H_MAGIC=0, H_SIZE=1, H_DIM=2, H_MODEL=3, H_I_OM=4, H_I_W0=5, H_I_H0=6,
    H_H0_SCALE=7, H_ORH2=8, H_NAXES=9, H_N1=10, H_N2=11, H_R1=12, H_R2=13,
    H_NQ=14, H_NPAIRS=15, H_NFORMS=16, H_HAS_CMB=17, H_OFF_BOUNDS=18,
    H_OFF_AX1=19, H_OFF_AX2=20, H_OFF_BW1=21, H_OFF_BW2=22, H_OFF_U1=23,
    H_OFF_U2=24, H_OFF_CORE=25, H_OFF_PAIRS=26, H_OFF_FORMS=27, H_OFF_CMB=28,
)
HEADER_SIZE = 32
MAGIC = 20260.0
# one pair = the (base, Or-delta) coefficient columns of one form index
PAIR = dict(P_FORM=0, P_BA=1, P_V=2, P_P0=3, P_P1=4)
PAIR_STRIDE = 8
FORM = dict(
    F_SCALE=0, F_CREF=1, F_BETA=2, F_RD_IDX=3, F_RD=4, F_J=5, F_MAG_IDX=6,
    F_OFFSET=7, F_H0REF=8, F_GREF0=9, F_GREF1=10, F_QREF0=11, F_QREF1=12,
    F_S00=13, F_S01=14, F_S10=15, F_S11=16,
)
FORM_STRIDE = 20
CMB = dict(
    C_PRIOR=0, C_L=3, C_OG4=12, C_OBS=13, C_ZSTAR=14, C_I_OBH2=15, C_NRS=16,
    C_NDC=17, C_NODES=20,
)
MODELS = ("lcdm", "wcdm", "wzcdm")
OBSERVABLES = ("R_lA_wb", "theta_wb_wm", "R_100theta_wb")
Z_STAR = ("aizpuru", "hu")

_ITEM_MULTIPROBE = "ROADMAP.md queue 1, item 8; queue 2, #1c"
_ITEM_W0WA = "ROADMAP.md queue 1, item 9; queue 2, #1b"
_ITEM_PRESETS = "ROADMAP.md queue 1, item 10"
_ITEM_KERNEL = "ROADMAP.md queue 2, #1a"


@dataclass(frozen=True)
class Packed:
    """The kernel's constant buffer ``buf`` (on the fit's device and
    dtype) and its layout as Python numbers: the header, and per form
    and for the CMB the integer fields that select a code path or a
    parameter. The plain version takes every other value from ``buf``,
    as the kernel does."""

    buf: torch.Tensor
    hdr: dict
    forms: tuple  # per form: F_BETA, F_RD_IDX, F_J, F_MAG_IDX
    cmb: dict  # C_OBS, C_ZSTAR, C_I_OBH2, C_NRS, C_NDC; empty without a CMB term

    @property
    def dim(self) -> int:
        return int(self.hdr["H_DIM"])


def _refuse(what: str, item: str):
    raise NotImplementedError(f"the fused log-prob kernel does not take {what} ({item})")


def _index(names, name, what):
    if name not in names:
        _refuse(f"{what} {name!r}, which is not a sampled parameter", _ITEM_PRESETS)
    return names.index(name)


def pack(fit) -> Packed:
    """The constant buffer of a fast ``FitSpec`` (``get_preset(...,
    fast=True)``). Raises ``NotImplementedError``, naming the ROADMAP
    item, for a term, model, parameter treatment or size that the kernel
    does not take."""
    from cosmax_torch.configs.presets import Derive
    from cosmax_torch.likelihoods.bao import RdFixed, RdParam

    if not fit.fast:
        raise ValueError(f"{fit.name} was built without fast=True: nothing to fuse")
    if fit.model not in MODELS:
        _refuse(f"model {fit.model!r}", _ITEM_W0WA)
    names = list(fit.spec.names)
    if len(names) > MAX_DIM:
        _refuse(f"{len(names)} parameters (at most {MAX_DIM})", _ITEM_KERNEL)
    derive = fit.derive
    if not isinstance(derive, Derive):
        _refuse(f"the derive {derive!r}", _ITEM_PRESETS)
    hdr = dict(
        H_MAGIC=MAGIC, H_DIM=len(names), H_MODEL=MODELS.index(fit.model),
        H_I_OM=_index(names, "Om", "the density"),
        H_I_W0=_index(names, "w0", "the equation of state") if fit.model != "lcdm" else -1,
        H_I_H0=_index(names, derive.h0_from, "the Hubble parameter"),
        H_H0_SCALE=1.0 if derive.h0_from == "H0" else derive.h0_scale,
        H_ORH2=0.0 if derive.orh2 is None else derive.orh2,
    )

    linear, cmb_terms = [], []
    for t in fit.terms:
        if t.log_norm is not None:
            _refuse(f"term {t.name!r} with a log-normalisation", _ITEM_MULTIPROBE)
        if "linear_chi2" in t.meta:
            linear.append(t)
        elif "compression" in t.meta:
            cmb_terms.append(t)
        else:
            _refuse(f"term {t.name!r}", _ITEM_MULTIPROBE)
    if len(cmb_terms) > 1:
        _refuse("more than one CMB term", _ITEM_PRESETS)
    if not linear or len(linear) > MAX_FORMS:
        _refuse(f"{len(linear)} emulated terms (1 to {MAX_FORMS})", _ITEM_KERNEL)
    bundle = linear[0].meta["linear_chi2"].bundle
    if any(t.meta["linear_chi2"].bundle is not bundle for t in linear):
        _refuse("terms from more than one emulator bundle", _ITEM_KERNEL)
    kind, halves = bundle.finalized()
    if kind != "native" or len(halves) != 1:
        _refuse(f"the {kind} emulator grid", _ITEM_W0WA)
    half = halves[0]

    # the representation as Tucker factors and a [r1, r2, R_all] core;
    # an exact table is Tucker with identity factors, one axis has r2 = 1
    rep = half["rep"]
    n_axes = len(half["axes"])
    if rep[0] == "exact":
        factors, core = [np.eye(len(ax)) for ax in half["axes"]], rep[1]
    elif rep[0] == "tucker":
        factors, core = list(rep[1]), rep[2]
    else:
        _refuse(f"the {rep[0]} representation", _ITEM_W0WA)
    if n_axes == 1:
        core = core[:, None, :]
    for u in factors:
        if u.shape[0] > MAX_NODES or u.shape[1] > MAX_RANK:
            _refuse(f"an emulator axis of {u.shape[0]} nodes at rank {u.shape[1]} "
                    f"(at most {MAX_NODES} and {MAX_RANK})", _ITEM_KERNEL)

    # forms, and their coefficient columns reordered into (base, delta)
    # pairs: the kernel walks the pairs with compile-time indices
    forms, pairs, cols = [], [], []
    for fid, t in enumerate(linear):
        lc = t.meta["linear_chi2"]
        form = lc.form(0)
        f = dict.fromkeys(FORM, 0.0)
        f.update(F_SCALE=form["scale"], F_CREF=form["c_ref"], F_RD_IDX=-1, F_J=lc.n_w,
                 F_MAG_IDX=-1, F_H0REF=1.0)
        if "rd" in t.meta:  # BAO: beta = c / (H0 r_d)
            rd = t.meta["rd"]
            if isinstance(rd, RdFixed):
                f.update(F_BETA=1, F_RD=float(rd.value))
            elif isinstance(rd, RdParam):
                f.update(F_BETA=1, F_RD_IDX=_index(names, rd.name, "r_d"))
            else:
                _refuse(f"the r_d treatment {rd!r}", _ITEM_PRESETS)
        elif lc.beta_fn is not None:
            _refuse(f"the beta of term {t.name!r}", _ITEM_MULTIPROBE)
        if lc.n_w:
            g = t.meta["gamma"]
            j_want = 2 if g["h0"] is not None else 1
            if lc.n_w != j_want or (g["h0"] is not None and g["h0"] != "H0"):
                _refuse(f"the SN nuisance columns of term {t.name!r}", _ITEM_PRESETS)
            f.update(F_MAG_IDX=_index(names, g["mag"], "the magnitude"),
                     F_OFFSET=g["offset_ref"], F_H0REF=g["h0_ref"])
            gr = np.zeros(2)
            qr = np.zeros(2)
            s = np.zeros((2, 2))
            gr[:lc.n_w], qr[:lc.n_w] = form["g_ref"], form["q_ref"]
            s[:lc.n_w, :lc.n_w] = form["s_mat"]
            f.update(F_GREF0=gr[0], F_GREF1=gr[1], F_QREF0=qr[0], F_QREF1=qr[1],
                     F_S00=s[0, 0], F_S01=s[0, 1], F_S10=s[1, 0], F_S11=s[1, 1])
        forms.append(f)
        p_mat = form.get("p_mat", np.zeros((len(form["v_ref"]), 0)))
        for i in range(len(form["v_ref"])):
            cols += [form["sl_a"].start + i, form["sl_d"].start + i]
            pp = np.zeros(2)
            pp[:p_mat.shape[1]] = p_mat[i]
            pairs.append((fid, form["ba_ref"][i], form["v_ref"][i], pp[0], pp[1]))
    r_all = len(cols)
    nq = -(-r_all // 4)
    if 4 * nq > MAX_RALL:
        _refuse(f"{r_all} coefficient columns (at most {MAX_RALL})", _ITEM_KERNEL)
    core = np.concatenate(
        [core[..., cols], np.zeros(core.shape[:2] + (4 * nq - r_all,))], axis=-1
    )

    cmb = {}
    if cmb_terms:
        t = cmb_terms[0]
        comp = t.meta["compression"]
        if t.meta["model"] != fit.model:
            _refuse(f"a CMB term of model {t.meta['model']!r} in a {fit.model} fit",
                    _ITEM_PRESETS)
        n_rs, n_dc = t.meta["orders"]
        if max(n_rs, n_dc) > MAX_GL:
            _refuse(f"CMB quadratures of {n_rs} and {n_dc} nodes (at most {MAX_GL})",
                    _ITEM_KERNEL)
        from cosmax_torch.ops.linalg import whitening_operator

        cmb = dict(
            C_OBS=OBSERVABLES.index(comp.observables),
            C_ZSTAR=Z_STAR.index(comp.z_star_variant),
            C_I_OBH2=_index(names, "Obh2", "the baryon density"),
            C_NRS=n_rs,
            C_NDC=n_dc,
        )
        # 4 og as one constant: the per-term path divides by 4.0 * og, a
        # Python float, cast once to the runtime dtype
        cmb_values = dict(C_OG4=4.0 * comp.o_gamma_h2, **cmb)
        cmb_arrays = dict(C_PRIOR=comp.priors,
                          C_L=whitening_operator(np.linalg.inv(comp.inv_cov)))

    # assemble: offsets are in floats; the core starts on 16 bytes
    chunks = [np.zeros(HEADER_SIZE)]
    size = HEADER_SIZE

    def put(key, arr, align=1):
        nonlocal size
        pad = -size % align
        if pad:
            chunks.append(np.zeros(pad))
            size += pad
        hdr[key] = size
        arr = np.asarray(arr, np.float64).reshape(-1)
        chunks.append(arr)
        size += arr.size

    put("H_OFF_BOUNDS", np.concatenate([fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]]))
    for i in range(2):
        ax = half["axes"][i] if i < n_axes else np.zeros(0)
        bw = half["bw"] if i < n_axes else np.zeros(0)
        put(f"H_OFF_AX{i + 1}", ax)
        put(f"H_OFF_BW{i + 1}", bw)
        put(f"H_OFF_U{i + 1}", factors[i] if i < n_axes else np.zeros(0))
    put("H_OFF_CORE", core, align=4)
    pair_rows = np.zeros((len(pairs), PAIR_STRIDE))
    pair_rows[:, :5] = np.asarray(pairs, np.float64)
    put("H_OFF_PAIRS", pair_rows)
    form_rows = np.zeros((len(forms), FORM_STRIDE))
    for i, f in enumerate(forms):
        for k, v in f.items():
            form_rows[i, FORM[k]] = v
    put("H_OFF_FORMS", form_rows)
    if cmb:
        block = np.zeros(CMB["C_NODES"])
        for k, v in cmb_values.items():
            block[CMB[k]] = v
        for k, a in cmb_arrays.items():
            block[CMB[k]:CMB[k] + a.size] = a.reshape(-1)
        put("H_OFF_CMB", np.concatenate([block, *gl_nodes_01(n_rs), *gl_nodes_01(n_dc)]))
    else:
        hdr["H_OFF_CMB"] = 0
    hdr.update(
        H_SIZE=size, H_NAXES=n_axes,
        H_N1=factors[0].shape[0], H_N2=factors[1].shape[0] if n_axes > 1 else 0,
        H_R1=factors[0].shape[1], H_R2=factors[1].shape[1] if n_axes > 1 else 1,
        H_NQ=nq, H_NPAIRS=len(pairs), H_NFORMS=len(forms), H_HAS_CMB=int(bool(cmb)),
    )
    if size > MAX_FLOATS:
        _refuse(f"a constant buffer of {size} floats (at most {MAX_FLOATS})", _ITEM_KERNEL)
    flat = np.concatenate(chunks)
    for k, v in hdr.items():
        flat[HEADER[k]] = v
    buf = torch.as_tensor(flat, device=fit.device).to(fit.dtype)
    layout = tuple({k: int(f[k]) for k in ("F_BETA", "F_RD_IDX", "F_J", "F_MAG_IDX")}
                   for f in forms)
    return Packed(buf=buf, hdr=hdr, forms=layout, cmb=cmb)


# --- the plain version -------------------------------------------------------


def _e_of_z(z, om, o_r, w0, model):
    """E(z) with radiation (``o_r`` = 0 gives the radiation-free E
    exactly); walker values [W, 1] against nodes [W, n]."""
    opz = 1.0 + z
    cubed = opz * opz * opz
    if model == "lcdm":
        rho = torch.ones_like(z)
    elif model == "wcdm":
        rho = torch.exp(3.0 * (1.0 + w0) * torch.log(opz))
    else:
        rho = torch.exp(2.0 * (1.0 + w0) * torch.log(2.0 * cubed / (1.0 + cubed)))
    ode = 1.0 - om - o_r
    return torch.sqrt(o_r * cubed * opz + om * cubed + ode * rho)


def _z_star(wb, wm, variant):
    if variant == "hu":
        g1 = 0.0783 * wb**-0.238 / (1.0 + 39.5 * wb**0.763)
        g2 = 0.560 / (1.0 + 21.1 * wb**1.81)
        return 1048.0 * (1.0 + 0.00124 * wb**-0.738) * (1.0 + g1 * wm**g2)
    return (391.672 * wm ** (-0.372296) + 937.422 * wb ** (-0.97966)) / (
        wm ** (-0.0192951) * wb ** (-0.93681)
    ) + wm ** (-0.731631)


def fused_log_prob_reference(packed: Packed, theta: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel over the same buffer: theta
    [W, D] -> logp [W], -inf outside the strict interior of the bounds
    or where the sum is not finite."""
    hdr, buf = packed.hdr, packed.buf
    theta = theta.to(buf.dtype)
    d = packed.dim

    def seg(key, n, shape=None):
        off = int(hdr[key])
        out = buf[off:off + n]
        return out.reshape(shape) if shape is not None else out

    def col(i):
        return theta[:, int(i)]

    model = MODELS[int(hdr["H_MODEL"])]
    h0 = col(hdr["H_I_H0"]) * buf[HEADER["H_H0_SCALE"]]
    om = col(hdr["H_I_OM"])
    w0 = col(hdr["H_I_W0"]) if model != "lcdm" else None
    o_r = buf[HEADER["H_ORH2"]] / (h0 / 100.0) ** 2  # 0 without radiation

    # barycentric weights, factor projections, core contraction
    r1, r2, nq = int(hdr["H_R1"]), int(hdr["H_R2"]), int(hdr["H_NQ"])
    coords = [om] + ([w0] if int(hdr["H_NAXES"]) > 1 else [])
    wps = []
    for i, x in enumerate(coords):
        n, r = int(hdr[f"H_N{i + 1}"]), int(hdr[f"H_R{i + 1}"])
        w = bary_vector(x, seg(f"H_OFF_AX{i + 1}", n), seg(f"H_OFF_BW{i + 1}", n))
        wps.append(w @ seg(f"H_OFF_U{i + 1}", n * r, (n, r)))
    core = seg("H_OFF_CORE", r1 * r2 * 4 * nq, (r1, r2, 4 * nq))
    a = torch.tensordot(wps[0], core, dims=([1], [0]))  # [W, r2, R]
    a = (torch.einsum("wk,wkr->wr", wps[1], a) if len(wps) > 1 else a[:, 0])

    # linear-chi^2 forms over (base, delta) column pairs
    npairs, nforms = int(hdr["H_NPAIRS"]), len(packed.forms)
    pairs = seg("H_OFF_PAIRS", npairs * PAIR_STRIDE, (npairs, PAIR_STRIDE))
    form_rows = seg("H_OFF_FORMS", nforms * FORM_STRIDE, (nforms, FORM_STRIDE))
    t = (o_r / OR_REF)[:, None]
    a_t = a[:, 0:2 * npairs:2] + t * a[:, 1:2 * npairs:2]  # [W, npairs]
    chi2 = torch.zeros_like(h0)
    zero = torch.zeros_like(h0)
    bs_cols, g0_cols, g1_cols = [], [], []
    for f, row in zip(packed.forms, form_rows):
        v = {k: row[i] for k, i in FORM.items()}
        if f["F_BETA"]:
            rd = col(f["F_RD_IDX"]) if f["F_RD_IDX"] >= 0 else v["F_RD"]
            beta = C_KM_S / (h0 * rd)
        else:
            beta = torch.ones_like(h0)
        g0 = col(f["F_MAG_IDX"]) - v["F_OFFSET"] - v["F_GREF0"] if f["F_J"] > 0 else zero
        g1 = (-5.0 * torch.log10(h0 / v["F_H0REF"]) - v["F_GREF1"]) if f["F_J"] > 1 else zero
        chi2 = (
            chi2 + v["F_CREF"]
            + g0 * (v["F_S00"] * g0 + v["F_S01"] * g1) + g1 * (v["F_S10"] * g0 + v["F_S11"] * g1)
            - 2.0 * (g0 * v["F_QREF0"] + g1 * v["F_QREF1"])
        )
        bs_cols.append(beta * v["F_SCALE"])
        g0_cols.append(g0)
        g1_cols.append(g1)
    fid = pairs[:, PAIR["P_FORM"]].long()
    bs = torch.stack(bs_cols, dim=-1)[:, fid]  # [W, npairs]
    g0 = torch.stack(g0_cols, dim=-1)[:, fid]
    g1 = torch.stack(g1_cols, dim=-1)[:, fid]
    e = bs * a_t - pairs[:, PAIR["P_BA"]]
    pg = pairs[:, PAIR["P_P0"]] * g0 + pairs[:, PAIR["P_P1"]] * g1
    chi2 = chi2 + (e * (e - 2.0 * pairs[:, PAIR["P_V"]] + 2.0 * pg)).sum(-1)

    if packed.cmb:
        chi2 = chi2 + _cmb_chi2(packed, col, h0, om, o_r, w0, model)

    bounds = seg("H_OFF_BOUNDS", 2 * d)
    ll = -0.5 * chi2
    ok = torch.all((bounds[:d] < theta) & (theta < bounds[d:]), dim=-1) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -torch.inf))


def _cmb_chi2(packed, col, h0, om, o_r, w0, model):
    """The compressed-CMB chi^2: z* fit, r_s by GL in a, D_C by GL in
    ln a, the three observables and the 3 x 3 whitening."""
    c = packed.cmb
    base = int(packed.hdr["H_OFF_CMB"])
    block = packed.buf[base:]
    n_rs, n_dc = c["C_NRS"], c["C_NDC"]
    nodes = block[CMB["C_NODES"]:CMB["C_NODES"] + 2 * (n_rs + n_dc)]
    t_rs, w_rs = nodes[:n_rs], nodes[n_rs:2 * n_rs]
    t_dc, w_dc = nodes[2 * n_rs:2 * n_rs + n_dc], nodes[2 * n_rs + n_dc:]
    wb = col(c["C_I_OBH2"])
    wm = om * (h0 / 100.0) ** 2
    zs = _z_star(wb, wm, Z_STAR[c["C_ZSTAR"]])
    cm, cr, cw = om[:, None], o_r[:, None], (w0[:, None] if w0 is not None else None)

    rb = (3.0 * wb / block[CMB["C_OG4"]])[:, None]
    a_end = (1.0 / (1.0 + zs))[:, None]
    a = a_end * t_rs
    ez = _e_of_z(1.0 / a - 1.0, cm, cr, cw, model)
    integ = C_KM_S / (a * a * ez * torch.sqrt(3.0 * (1.0 + rb * a)))
    rs = torch.sum(integ * (a_end * w_rs), dim=-1) / h0

    u0 = torch.log(1.0 / (1.0 + zs))[:, None]
    a = torch.exp(u0 * (1.0 - t_dc))
    ez = _e_of_z(1.0 / a - 1.0, cm, cr, cw, model)
    dm = torch.sum(C_KM_S / (a * ez) * (-u0 * w_dc), dim=-1) / h0

    obs = OBSERVABLES[c["C_OBS"]]
    if obs == "theta_wb_wm":
        vals = (rs / dm, wb, wm)
    else:
        r = torch.sqrt(om) * h0 * dm / C_KM_S
        vals = (r, math.pi * dm / rs, wb) if obs == "R_lA_wb" else (r, 100.0 * rs / dm, wb)
    priors = block[CMB["C_PRIOR"]:CMB["C_PRIOR"] + 3]
    linv = block[CMB["C_L"]:CMB["C_L"] + 9].reshape(3, 3)
    delta = priors - torch.stack(vals, dim=-1)
    wht = delta @ linv.T
    return torch.sum(wht * wht, dim=-1)


# --- the wrapper -------------------------------------------------------------


def fused_log_prob(packed: Packed, theta: torch.Tensor) -> torch.Tensor:
    """logp [W] for walkers theta [W, D].

    CPU tensors: the plain version, in the buffer's dtype. CUDA tensors:
    the kernel, which takes a contiguous float32 theta on the buffer's
    device and raises otherwise.
    """
    if theta.dim() != 2 or theta.shape[1] != packed.dim:
        raise ValueError(f"theta must be [W, {packed.dim}]; got {tuple(theta.shape)}")
    if theta.device != packed.buf.device:
        raise ValueError(f"theta on {theta.device} but the constants on {packed.buf.device}")
    if theta.device.type == "cpu":
        return fused_log_prob_reference(packed, theta)
    if theta.device.type != "cuda":
        raise ValueError(f"fused_log_prob has no kernel for device {theta.device}")
    for name, t in (("theta", theta), ("constant buffer", packed.buf)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes a float32 {name}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {name}")
    w = theta.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=theta.device)
    if w == 0:
        return out
    from cosmax_torch.ops.kernels.build import load_kernel

    fn = _entry(load_kernel("fused_log_prob").lib)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(packed.buf.data_ptr(), packed.buf.numel(), theta.data_ptr(),
                 out.data_ptr(), w, packed.dim, stream)
    if err != 0:
        raise RuntimeError(f"fused_log_prob kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _entry(lib: ctypes.CDLL):
    fn = lib.cosmax_fused_log_prob_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


# --- the work of one call, for the bound -------------------------------------


def work_per_walker(packed: Packed) -> tuple:
    """(f32 operations, bytes) per walker of the fused log-prob, counted
    from the packed sizes: an FMA is 2 operations, every other
    arithmetic operation (division, square root, exp, log, pow) 1.
    Bytes are theta read once and logp written once; the constant buffer
    (read once per call) is left out of the per-walker count."""
    h = packed.hdr
    ops = 10  # derived parameters and the bounds test
    for i in (1, 2)[:int(h["H_NAXES"])]:
        n, r = h[f"H_N{i}"], h[f"H_R{i}"]
        ops += n * 4 + n * (4 + 2 * r)  # two barycentric passes, projection
    r_all = 2 * h["H_NPAIRS"]
    ops += h["H_R1"] * h["H_R2"] * (1 + 2 * r_all)  # core contraction
    ops += 25 * h["H_NFORMS"] + 14 * h["H_NPAIRS"]  # forms
    if packed.cmb:
        n_rs, n_dc = packed.cmb["C_NRS"], packed.cmb["C_NDC"]
        # z*; per node E(z) is ~19 (cube, log, exp, sqrt), the integrand
        # and the sum ~14 for r_s, ~10 for D_C; the observables and 3 x 3
        ops += 30 + n_rs * 33 + n_dc * 29 + 40
    return int(ops), 4 * (packed.dim + 1)
