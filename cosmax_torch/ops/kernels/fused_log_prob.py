"""The fused fast log-prob: logp[W] for walkers theta[W, D] of a fast preset.

The card's implementation is the hand-written CUDA kernel in
``cosmax_torch/csrc/fused_log_prob.cu``, one thread per walker (the native
grid's core contraction, and on the split w0wacdm grid the tensor-train
sweep, run as block products on the tensor cores). It replaces the TPU
kernel ``cosmax/ops/pallas/megakernel.py::blocked_log_prob`` (the source note there says what bounds it on an H100 and how the design
answers that). This module holds

* the **packer** ``pack(fit)``: from a fast ``FitSpec``, the flat
  constant buffer that the kernel copies into shared memory, with a
  header of offsets and sizes (``HEADER``), the bundle's barycentric
  axes, Tucker factors and core, one row of constants per emulated term
  (``FORM``) with its per-rank rows, the CMB block (a compression, or the
  100 theta* prior) and its Gauss-Legendre rules, the bounds and the
  derived parameters (a constant H0, w0 = log(exp_w0)), the walker's r_d
  (``RD_KINDS``: fixed, sampled, r_d h, the drag fitting formulae, or
  r_s(z_drag) by the Gauss-Legendre rule packed beside it), and in header
  slots a scalar prior (Om h^2 or a sampled omega_b). A split
  w0wacdm bundle packs per half a block of its tensor-train layout
  (``HALF``), its own s axis and its own FORM table and rows, while its
  TT cores and tails go into a second buffer kept in device memory
  (``Packed.dev``). It raises for what the kernel does not take;
* the **plain version** ``fused_log_prob_reference(packed, theta)``: the
  same function in plain torch ops over the same buffer;
* the **wrapper** ``fused_log_prob(packed, theta)``: CPU tensors take the
  plain version, CUDA tensors launch the kernel or raise. There is no
  fallback from the kernel to the plain version.

The emulated terms are three kinds of form over the bundle's shared
coefficient vector a[R_all]:

* ``linear`` (BAO, SN, CC): the reference-centred quadratic form over
  (base, Or-delta) column pairs, with beta = c/(H0 r_d) (BAO, r_d the
  walker's, computed once before the forms), H0 (CC) or 1, and the SN
  nuisance columns;
* ``lift`` (quasars): the curve values dmu[K] = a^T (scale B_t), then the
  diagonal metric sigma_i^2 + s^2 and its log-normalisation (K at most
  MAX_LIFT; the kernel takes them in chunks of MAX_K);
* ``amp_pair`` (fs8): r = scale ((a_u + t a_du) - amp (a_v + t a_dv))
  over (u, du, v, dv) column quads, chi^2 = |r|^2.

A fit with no emulated term (``cmb.cmb``, lcdm) packs no grid and no
forms: the kernel's native-grid instance computes its CMB block alone.

A form may carry a rescaling parameter f (CC's f_cc, fs8's f_err):
chi^2 * f^power and log_norm = const + coef * ln f. The packer orders
the core's columns form by form, each form's window padded with zero
columns to whole quads (four columns, one float4), so that the kernel
contracts and reduces one window at a time. The core is stored as the
matrix of the kernel's block product, [KO KI, LDB]: row j KI + p for the
outer axis's index j and the inner one's p (the inner axis is the one of
rank at most MAX_RANK whose rank pads to whole k-steps of 8 with the fewer
rows, the outer one of rank at most MAX_RANK_OUTER; one axis: KO = 1),
its row stride LDB 8 or 24 mod 32 and covering the n-tiles of 8 columns
that start at each window's first column.

The split w0wacdm grid: each walker takes half 0 if s = w0 + wa <= 0,
else half 1, and computes that half only. Its coefficient vector comes
from the tensor-train sweep v <- w_0^T G_0, v'[r] = sum_n sum_p w[n] v[p]
G[n, p, r] over the later cores, a = v^T tail; each core is stored as
the matrix [n r_prev][r] of the kernel's block product, its rows padded
with zeros to whole slices of KSLICE and its columns to a multiple of 8,
the tail [r_last, 4 nq] with its columns ordered form by form as the
Tucker core's. A half that the compressor left as Tucker (``sn.union3_cmb``'s
half 1) is packed as the same function in tensor-train form
(``_tucker_as_tt``). The kernel sweeps in 3xTF32, or in f64 on the f64
tensor cores where the packer finds that a float32 sweep would cancel
(``H_SWEEP_F64``, ``sweep_cancellation``; the wrapper launches that
instance, ``instance``).

The buffer is in the fit's dtype: float32 on the card (the f64 build
constants cast once, as the per-term path casts them), float64 for the
CPU parity tests.
"""

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S, O_GAMMA_H2
from cosmax_torch.models import recombination
from cosmax_torch.models.emu_core import OR_REF, bary_vector, coeff_contract
# H_SWEEP_F64: the split grid's sweep in f64 where a float32 one would cancel
from cosmax_torch.models.linear_chi2 import SWEEP_F64_RATIO, window_cancellation
from cosmax_torch.ops.quadrature import gl_nodes_01

# Kernel launches made by ``fused_log_prob`` since the last reset; a run
# reads it to show that its main path went through the kernel.
LAUNCHES = 0

# Compiled maxima of the kernel (``csrc/fused_log_prob.cu`` has the same
# values; a CPU test holds the two files together). The packer refuses
# anything larger.
MAX_DIM = 16  # sampled parameters
MAX_NODES = 64  # Chebyshev nodes per emulator axis
MAX_RANK = 16  # Tucker rank of the inner axis (one or two k-steps of 8), and of one axis
MAX_RANK_OUTER = 24  # Tucker rank of the outer axis, which the kernel reads row by row
MAX_BOND = 128  # tensor-train bond rank
MAX_RALL = 256  # coefficient columns, each form's window padded to quads
MAX_FORMS = 8  # emulated terms
MAX_K = 32  # values of a lift form the kernel holds in registers at once (a chunk)
MAX_LIFT = 64  # values of a lift form (quasar bins), in chunks of MAX_K
MAX_GL = 64  # nodes of each CMB quadrature
MAX_GL_RD = 128  # nodes of r_s(z_drag)
MAX_FLOATS = 40960  # constant-buffer floats (160 KB of shared memory)
MAX_DEV_FLOATS = 1 << 24  # device-buffer floats (offsets are exact in f32)
# The split grid's block products (the kernel's values too): the sweep's
# rows at a stride of VLD floats, the cores staged in slices of KSLICE rows
# and column passes of at most NCOL columns at a stride of SLD floats, in a
# ring of STAGES slices; each core is stored [n r_in padded to KSLICE rows]
# [r padded to 8], a bond into a block product at least MIN_RIN. A block
# may hold MAX_SMEM bytes of shared memory (H100), GROUP_BYTES of them the
# per-warp half counts.
THREADS = 128
VLD = 136
VLD_F64 = 132  # the sweep's rows in the f64 sweep (H_SWEEP_F64), doubles
KSLICE = 32
NCOL = 56
SLD = 72
STAGES = 2
MIN_RIN = 8
WPAD = 4  # zero rows of weights under the padding rows of a core
MAX_SMEM = 232448
GROUP_BYTES = 2 * (THREADS // 32) * 4
# The native grid's contraction, a block product per warp of 32 walkers: the
# core stored as the matrix [KO KI][LDB] of its k rows (KI the inner axis's
# rank padded to k-steps of 8), its row stride LDB 8 or 24 mod 32 (the
# kernel's B fragments on 32 banks) and covering each window's n-tiles of 8
# columns; per warp the projections [KO + KI][WLD] and C [NCOLT][CLD];
# TUCKER_WARPS warps a block.
WLD = 40
CLD = 36
NCOLT = 24
TUCKER_WARPS = 8

# Header slots of the buffer (floats holding small integers or values).
HEADER = dict(
    H_MAGIC=0, H_SIZE=1, H_DIM=2, H_MODEL=3, H_I_OM=4, H_I_W0=5, H_I_H0=6,
    H_H0_SCALE=7, H_ORH2=8, H_NAXES=9, H_N1=10, H_N2=11, H_R1=12, H_R2=13,
    H_NQ=14, H_RALL=15, H_NFORMS=16, H_HAS_CMB=17, H_OFF_BOUNDS=18,
    H_OFF_AX1=19, H_OFF_AX2=20, H_OFF_BW1=21, H_OFF_BW2=22, H_OFF_U1=23,
    H_OFF_U2=24, H_OFF_CORE=25, H_OFF_FORMS=26, H_OFF_CMB=27, H_I_WA=28, H_SPLIT=29,
    H_OFF_HALVES=30, H_VROWS=31, H_KO=32, H_KI=33, H_LDB=34, H_INNER=35,
    H_PRIOR=36, H_PRIOR_MEAN=37, H_PRIOR_SIGMA=38, H_H0_CONST=39, H_W0_LOG=40, H_RD_KIND=41,
    H_RD=42, H_I_RD=43, H_RD_N=44, H_OFF_RD=45, H_I_PRIOR=46, H_SWEEP_F64=47,
)
HEADER_SIZE = 48
MAGIC = 20260.0
# one row of a linear form = the constants of its (base, delta) pair i
PAIR = dict(P_BA=0, P_V=1, P_P0=2, P_P1=3)
PAIR_STRIDE = 4
FORM = dict(
    F_KIND=0, F_Q0=1, F_NQ=2, F_ROWS=3, F_SCALE=4, F_CREF=5, F_BETA=6,
    F_J=7, F_MAG_IDX=8, F_OFFSET=9, F_H0REF=10, F_GREF0=11, F_GREF1=12,
    F_QREF0=13, F_QREF1=14, F_S00=15, F_S01=16, F_S10=17, F_S11=18,
    F_F_IDX=19, F_POW=20, F_LN_CONST=21, F_LN_COEF=22, F_K=23, F_I_AMP=24,
    F_I_OFF=25, F_I_S=26,
)
FORM_STRIDE = 32
KINDS = ("linear", "lift", "amp_pair")  # F_KIND; F_BETA: 0 one, 1 c / (H0 r_d), 2 H0
# one half of the split grid: per core i its grid axis (0 Om, 1 wa, 2 s),
# node offset and count; the bond ranks r1..r3 (r3 the tail's rows); the
# device-buffer offsets of the cores and the tail; the tail's quads and
# used columns; the half's FORM table; and a 1.0
HALF = dict(
    T_PERM0=0, T_PERM1=1, T_PERM2=2, T_AX0=3, T_AX1=4, T_AX2=5, T_N0=6, T_N1=7, T_N2=8,
    T_R1=9, T_R2=10, T_R3=11, T_G0=12, T_G1=13, T_G2=14, T_TAIL=15, T_NQ=16, T_RALL=17,
    T_OFF_FORMS=18, T_ONE=19,
)
HALF_STRIDE = 24
CMB = dict(
    C_PRIOR=0, C_L=3, C_OG4=12, C_OBS=13, C_ZSTAR=14, C_I_OBH2=15, C_NRS=16,
    C_NDC=17, C_SIGMA=18, C_NODES=20,
)
MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")
# C_OBS: a compression's three observables, or the 100 theta* prior alone
# ((C_PRIOR[0] - 100 r_s / D_C) / C_SIGMA)^2
OBSERVABLES = ("R_lA_wb", "theta_wb_wm", "R_100theta_wb", "theta_100")
# H_RD_KIND, the walker's r_d: H_RD fixed; H_RD theta[H_I_RD]; theta[H_I_RD]
# / (H0 / 100); r_drag_aizpuru(wb, wm); r_drag_desi(wb, wm, n_eff = H_RD);
# r_s(z_drag(wb, wm)) by the GL rule at H_OFF_RD (H_RD_N nodes, then their
# weights), H_RD = 4 omega_gamma h^2. wb is theta[H_I_RD] for the last three.
RD_KINDS = ("none", "fixed", "param", "over_h", "aizpuru", "desi", "z_drag")
# H_PRIOR: none, Om h^2 from Om and H0, or the sampled theta[H_I_PRIOR]
PRIORS = ("none", "omh2", "param")
Z_STAR = ("aizpuru", "hu")
# the integer fields of a form, kept in ``Packed.forms`` for the plain version
_FORM_INTS = ("F_KIND", "F_Q0", "F_NQ", "F_ROWS", "F_BETA", "F_J", "F_MAG_IDX", "F_F_IDX",
              "F_K", "F_I_AMP", "F_I_OFF", "F_I_S")


_ITEM_PRESETS = "ROADMAP.md queue 1, item 10c"
_ITEM_KERNEL = "ROADMAP.md queue 2, #1a and #1c"


@dataclass(frozen=True)
class Packed:
    """The kernel's constant buffer ``buf`` (on the fit's device and
    dtype) and its layout as Python numbers: the header, and per form
    and for the CMB the integer fields that select a code path or a
    parameter. The plain version takes every other value from ``buf``,
    as the kernel does."""

    buf: torch.Tensor
    hdr: dict
    forms: tuple  # per form: the _FORM_INTS fields and n_cols, its columns before padding
    cmb: dict  # C_OBS, C_ZSTAR, C_I_OBH2, C_NRS, C_NDC; empty without a CMB or theta* term
    # the split grid: per half its HALF fields and its own ``forms``;
    # ``forms`` above is then half 0's. Empty on a native grid.
    halves: tuple = ()
    dev: torch.Tensor = None  # the split grid's TT cores and tails, f32 or f64

    @property
    def dim(self) -> int:
        return int(self.hdr["H_DIM"])

    def f64(self):
        """(``buf``, ``dev``) in float64: cast once, and again only after an
        in-place change to either."""
        key = (self.buf._version, self.dev._version)
        cached = self.__dict__.get("_f64")
        if cached is None or cached[0] != key:
            cached = (key, self.buf.double(), self.dev.double())
            object.__setattr__(self, "_f64", cached)
        return cached[1:]


def _refuse(what: str, item: str):
    raise NotImplementedError(f"the fused log-prob kernel does not take {what} ({item})")


def _index(names, name, what):
    if name not in names:
        _refuse(f"{what} {name!r}, which is not a sampled parameter", _ITEM_PRESETS)
    return names.index(name)


def _emulated(t):
    """(kind, the term's emulator object) of an emulated term, or None."""
    for kind, key in (("linear", "linear_chi2"), ("lift", "curve_values"),
                      ("amp_pair", "amp_pair")):
        if key in t.meta:
            return kind, t.meta[key]
    return None


def _linear_form(t, lc, names, has_h0, h):
    """FORM fields and per-pair rows of a linear-chi^2 term in half ``h``."""
    form = lc.form(h)
    f = dict(F_SCALE=form["scale"], F_CREF=form["c_ref"], F_BETA=0, F_J=lc.n_w, F_MAG_IDX=-1,
             F_H0REF=1.0)
    if "rd" in t.meta:  # BAO: beta = c / (H0 r_d), r_d the walker's (``_rd_layout``)
        f.update(F_BETA=1)
    elif t.meta.get("beta") == "H0":  # CC: beta = H0
        f.update(F_BETA=2)
    elif lc.beta_fn is not None:
        _refuse(f"the beta of term {t.name!r}", _ITEM_PRESETS)
    if f["F_BETA"] and not has_h0:
        _refuse(f"term {t.name!r}, whose beta needs H0, in a fit without H0", _ITEM_PRESETS)
    if lc.n_w:
        g = t.meta["gamma"]
        j_want = 2 if g["h0"] is not None else 1
        if lc.n_w != j_want or (g["h0"] is not None and (g["h0"] != "H0" or not has_h0)):
            _refuse(f"the SN nuisance columns of term {t.name!r}", _ITEM_PRESETS)
        f.update(F_MAG_IDX=_index(names, g["mag"], "the magnitude"),
                 F_OFFSET=g["offset_ref"], F_H0REF=g["h0_ref"])
        gr, qr, s = np.zeros(2), np.zeros(2), np.zeros((2, 2))
        gr[:lc.n_w], qr[:lc.n_w] = form["g_ref"], form["q_ref"]
        s[:lc.n_w, :lc.n_w] = form["s_mat"]
        f.update(F_GREF0=gr[0], F_GREF1=gr[1], F_QREF0=qr[0], F_QREF1=qr[1],
                 F_S00=s[0, 0], F_S01=s[0, 1], F_S10=s[1, 0], F_S11=s[1, 1])
    n = len(form["v_ref"])
    rows = np.zeros((n, PAIR_STRIDE))
    rows[:, PAIR["P_BA"]] = form["ba_ref"]
    rows[:, PAIR["P_V"]] = form["v_ref"]
    p_mat = form.get("p_mat", np.zeros((n, 0)))
    rows[:, PAIR["P_P0"]:PAIR["P_P0"] + p_mat.shape[1]] = p_mat
    cols = [c for i in range(n) for c in (form["sl_a"].start + i, form["sl_d"].start + i)]
    return f, cols, rows


def _lift_form(t, cv, names, h):
    """FORM fields and rows (d_ref [K], sigma^2 [K], scale B_t [R_t, K])
    of the quasar curve-values term in half ``h``."""
    form = cv.form(h)
    b = form["b_scaled"]
    n, k = b.shape
    if k > MAX_LIFT:
        _refuse(f"a lift form of {k} values (at most {MAX_LIFT})", _ITEM_KERNEL)
    f = dict(F_K=k, F_I_OFF=_index(names, t.meta["offset"], "the quasar offset"),
             F_I_S=_index(names, t.meta["scatter"], "the quasar scatter"))
    cols = [c for i in range(n) for c in (form["sl_a"].start + i, form["sl_d"].start + i)]
    return f, cols, (t.meta["d_ref"], t.meta["sigma_sq"], b)


def _amp_pair_form(ap, names, h):
    """FORM fields of the fs8 amplitude-pair term and its column quads in
    half ``h``."""
    form = ap.form(h)
    n = form["sl_au"].stop - form["sl_au"].start
    cols = [form[k].start + i for i in range(n) for k in ("sl_au", "sl_du", "sl_av", "sl_dv")]
    return dict(F_SCALE=form["scale"], F_I_AMP=_index(names, ap.amp_param, "the amplitude")), cols


def _half_forms(emulated, names, has_h0, h):
    """The forms of half ``h``: per form (FORM fields, n_cols), its rows,
    and the coefficient columns in window order, each form's window
    padded with zero columns (-1) to whole quads."""
    forms, form_rows, cols = [], [], []
    for t, kind, obj in emulated:
        f = dict.fromkeys(FORM, 0.0)
        f.update(F_KIND=KINDS.index(kind), F_MAG_IDX=-1, F_F_IDX=-1,
                 F_I_AMP=-1, F_I_OFF=-1, F_I_S=-1, F_H0REF=1.0, F_POW=1.0)
        if kind == "linear":
            fields, fcols, rows = _linear_form(t, obj, names, has_h0, h)
            rows = np.concatenate([rows, np.zeros((len(rows) % 2, PAIR_STRIDE))])
        elif kind == "lift":
            fields, fcols, (d_ref, sig2, b) = _lift_form(t, obj, names, h)
            b = np.concatenate([b, np.zeros((len(b) % 2, b.shape[1]))])
            rows = np.concatenate([d_ref, sig2, b.reshape(-1)])
        else:
            fields, fcols = _amp_pair_form(obj, names, h)
            rows = np.zeros(0)
        f.update(fields)
        if "rescale" in t.meta:
            rs = t.meta["rescale"]
            f.update(F_F_IDX=_index(names, rs["param"], "the rescaling"), F_POW=rs["power"],
                     F_LN_CONST=rs["ln_const"], F_LN_COEF=rs["ln_coef"])
        n_cols = len(fcols)
        fcols = fcols + [-1] * (-n_cols % 4)
        f.update(F_Q0=len(cols) // 4, F_NQ=len(fcols) // 4)
        cols += fcols
        forms.append((f, n_cols))
        form_rows.append(np.asarray(rows, np.float64).reshape(-1))
    if len(cols) > MAX_RALL:
        _refuse(f"{len(cols)} coefficient columns (at most {MAX_RALL})", _ITEM_KERNEL)
    return forms, form_rows, cols


def _rd_layout(emulated, names, model):
    """Header fields of the walker's r_d, from the r_d treatment that
    every BAO term shares, and the GL rule of r_s(z_drag) (or None)."""
    from cosmax_torch.likelihoods.bao import RdFixed, RdFromRDrag, RdFromZDrag, RdOverH, RdParam

    rds = [t.meta["rd"] for t, _, _ in emulated if "rd" in t.meta]
    if not rds:
        return dict(H_RD_KIND=RD_KINDS.index("none")), None
    rd = rds[0]
    if any(r != rd for r in rds):
        _refuse(f"BAO terms with different r_d treatments {rds!r}", _ITEM_PRESETS)
    if isinstance(rd, RdFixed):
        return dict(H_RD_KIND=RD_KINDS.index("fixed"), H_RD=float(rd.value)), None
    if isinstance(rd, (RdParam, RdOverH)):
        kind = "param" if isinstance(rd, RdParam) else "over_h"
        return dict(H_RD_KIND=RD_KINDS.index(kind), H_I_RD=_index(names, rd.name, "r_d"),
                    H_RD=rd.scale if kind == "param" else 0.0), None
    out = dict(H_I_RD=_index(names, "Obh2", "the baryon density"))
    if isinstance(rd, RdFromRDrag):
        out.update(H_RD_KIND=RD_KINDS.index(rd.which), H_RD=rd.n_eff)
        return out, None
    if isinstance(rd, RdFromZDrag):
        if rd.model != model or rd.order > MAX_GL_RD:
            _refuse(f"r_s(z_drag) of model {rd.model!r} by GL-{rd.order} in a {model} fit (GL "
                    f"of at most {MAX_GL_RD} nodes)", _ITEM_PRESETS)
        # 4 og as one constant: the per-term path divides by 4.0 * og, a
        # Python float, cast once to the runtime dtype
        out.update(H_RD_KIND=RD_KINDS.index("z_drag"), H_RD=4.0 * O_GAMMA_H2, H_RD_N=rd.order)
        return out, np.concatenate(gl_nodes_01(rd.order))
    _refuse(f"the r_d treatment {rd!r}", _ITEM_PRESETS)


def _prior_layout(priors, names, has_h0):
    """Header fields of the fit's one scalar prior: Om h^2 from Om and H0,
    or a sampled parameter (the BBN omega_b)."""
    if not priors:
        return {}
    sp = priors[0].meta["scalar_prior"]
    if len(priors) == 1 and sp["quantity"] == "omh2" and (sp["om"], sp["h0"]) == ("Om", "H0") \
            and has_h0:
        out = dict(H_PRIOR=PRIORS.index("omh2"))
    elif len(priors) == 1 and sp["quantity"] == "obh2":
        out = dict(H_PRIOR=PRIORS.index("param"),
                   H_I_PRIOR=_index(names, sp["param"], "the prior's parameter"))
    else:
        _refuse(f"the prior terms {[t.name for t in priors]!r}", _ITEM_PRESETS)
    return dict(out, H_PRIOR_MEAN=sp["mean"], H_PRIOR_SIGMA=sp["sigma"])


def _by_cols(table, cols):
    """``table`` [..., R_all] with its last axis reordered to ``cols``, a
    -1 column being zeros."""
    return np.concatenate([table, np.zeros(table.shape[:-1] + (1,))], axis=-1)[..., cols]


def _pad8(r):
    return -(-r // 8) * 8


def _vrows(t):
    """Rows of a half's sweep vectors in the kernel's shared memory: a
    block step of one column pass (at most NCOL) writes its output over
    its input, a wider one at the other end of the rows."""
    r1, r2, r3 = (_pad8(int(t[f"T_R{i}"])) for i in (1, 2, 3))
    return max(r1, *(max(a, b) if b <= NCOL else a + b for a, b in ((r1, r2), (r2, r3))))


def _tucker_as_tt(rep):
    """A split half's Tucker representation (factors [n, r_i] of the grid
    axes, core [r0, r1, r2, R]) as the same function in the tensor-train
    form the kernel sweeps: the two axes of the smallest ranks a and b
    first, their bond the Kronecker pair (p, q) of r_a r_b rows, then the
    third axis's factor folded into the core, and an identity tail."""
    _, factors, core = rep
    a, b, c = sorted(range(3), key=lambda i: factors[i].shape[1])
    ra, rb = factors[a].shape[1], factors[b].shape[1]
    g1 = np.einsum("pq,jr->pjqr", np.eye(ra), factors[b]).reshape(ra, -1, ra * rb)
    g2 = np.einsum("kt,pqtm->pqkm", factors[c], np.transpose(core, (a, b, c, 3)))
    return ("tt", (a, b, c), [factors[a], g1, g2.reshape(ra * rb, -1, core.shape[3])],
            np.eye(core.shape[3]))


def _core_ld(forms) -> int:
    """Row stride of the native grid's core matrix: 8 or 24 mod 32, and
    wide enough for the n-tiles of 8 columns that start at each window's
    first column."""
    need = max(4 * f["F_Q0"] + 8 * -(-f["F_NQ"] // 2) for f, _ in forms)
    return next(ld for ld in range(need, need + 32) if ld % 32 in (8, 24))


def tucker_smem_bytes(hdr) -> int:
    """Shared memory of one block of the native grid's kernel instance:
    the constants, and per warp its projections and its C."""
    per_warp = (int(hdr["H_KO"]) + int(hdr["H_KI"])) * WLD + NCOLT * CLD
    return 4 * (-(-int(hdr["H_SIZE"]) // 4) * 4 + TUCKER_WARPS * per_warp)


def split_smem_bytes(hdr) -> int:
    """Shared memory of one block of the split grid's kernel instance: the
    constants, the weights of one step and the sweep vectors ([n + WPAD +
    H_VROWS][VLD] floats, or [..][VLD_F64] doubles in the f64 sweep), the
    ring of core slices, and the half counts."""
    rows = int(hdr["H_N1"]) + WPAD + int(hdr["H_VROWS"])
    ld = 2 * VLD_F64 if hdr.get("H_SWEEP_F64") else VLD  # a row's floats
    floats = -(-int(hdr["H_SIZE"]) // 4) * 4 + rows * ld + STAGES * KSLICE * SLD
    return 4 * floats + GROUP_BYTES


def sweep_cancellation(emulated, h) -> float:
    """``linear_chi2.window_cancellation`` of half ``h`` over the emulated
    terms' groups: 1 / max|a_ref B_t| in a group's scaled units at the
    half's reference centre (the build's ``theta_ref``). ``emulated``
    holds (term, kind, emulator object) of ``pack``."""
    return window_cancellation([obj.handle.per_half[h] for _, _, obj in emulated])


def pack(fit) -> Packed:
    """The constant buffers of a fast ``FitSpec`` (``get_preset(...,
    fast=True)``). Raises ``NotImplementedError``, naming the ROADMAP
    item, for a term, model, parameter treatment or size that the kernel
    does not take.

    On the split grid the packer also chooses the sweep's arithmetic: f64
    (``H_SWEEP_F64`` = 1, the kernel's f64 instance, one block an SM) where
    ``sweep_cancellation`` of either half exceeds ``SWEEP_F64_RATIO``, i.e.
    where some group's table scale (its max |value| over the padded grid)
    is more than 1e3 times its largest |value| at the half's reference
    centre: the float32 sweep would carry that group's columns as
    cancellations of corner-sized terms (``qsr.desi`` and
    ``qsr.des5y_desi``, whose boxes reach Om = 0); 3xTF32 otherwise."""
    from cosmax_torch.configs.presets import Derive

    if not fit.fast:
        raise ValueError(f"{fit.name} was built without fast=True: nothing to fuse")
    if fit.model not in MODELS:
        _refuse(f"model {fit.model!r}", _ITEM_PRESETS)
    names = list(fit.spec.names)
    if len(names) > MAX_DIM:
        _refuse(f"{len(names)} parameters (at most {MAX_DIM})", _ITEM_KERNEL)
    derive = fit.derive
    if not isinstance(derive, Derive):
        _refuse(f"the derive {derive!r}", _ITEM_PRESETS)
    # a fit may sample no H0 (fs8.fs8): then nothing may need it; or fix
    # it for every walker (the H0-free bao.desi_des5y: H0 = 1)
    sampled_h0 = derive.h0 is None and derive.h0_from in names
    has_h0 = sampled_h0 or derive.h0 is not None
    if not has_h0 and (derive.h0_from != "H0" or derive.orh2 is not None):
        _index(names, derive.h0_from, "the Hubble parameter")
    # w0 sampled as itself, or as exp(w0) (bao.desi_pantheon)
    w0_log = derive.w0_log is not None and derive.w0_log in names
    hdr = dict.fromkeys(HEADER, 0)
    hdr.update(
        H_MAGIC=MAGIC, H_DIM=len(names), H_MODEL=MODELS.index(fit.model),
        H_I_OM=_index(names, "Om", "the density"),
        H_I_W0=_index(names, derive.w0_log if w0_log else "w0", "the equation of state")
        if fit.model != "lcdm" else -1,
        H_W0_LOG=int(w0_log),
        H_I_WA=_index(names, "wa", "the equation of state") if fit.model == "w0wacdm" else -1,
        H_I_H0=names.index(derive.h0_from) if sampled_h0 else -1,
        H_H0_SCALE=1.0 if derive.h0_from == "H0" else derive.h0_scale,
        H_H0_CONST=derive.h0 or 0.0,
        H_ORH2=0.0 if derive.orh2 is None else derive.orh2,
        H_I_RD=-1, H_I_PRIOR=-1,
    )

    emulated, cmb_terms, priors = [], [], []
    for t in fit.terms:
        kind = _emulated(t)
        if kind is not None:
            if t.log_norm is not None and kind[0] != "lift" and "rescale" not in t.meta:
                _refuse(f"term {t.name!r} with a log-normalisation", _ITEM_PRESETS)
            emulated.append((t, *kind))
        elif "compression" in t.meta or "theta_star" in t.meta:
            cmb_terms.append(t)
        elif "scalar_prior" in t.meta:
            priors.append(t)
        else:
            _refuse(f"term {t.name!r}", _ITEM_PRESETS)
    if len(cmb_terms) > 1:
        # one CMB block: a compression or the theta* prior (no preset has both)
        _refuse(f"more than one CMB term {[t.name for t in cmb_terms]!r}", _ITEM_PRESETS)
    hdr.update(_prior_layout(priors, names, has_h0))
    if cmb_terms and not has_h0:
        _refuse("a CMB term in a fit without H0", _ITEM_PRESETS)
    if len(emulated) > MAX_FORMS:
        _refuse(f"{len(emulated)} emulated terms (at most {MAX_FORMS})", _ITEM_KERNEL)
    if emulated:
        bundle = emulated[0][2].bundle
        if any(obj.bundle is not bundle for _, _, obj in emulated):
            _refuse("terms from more than one emulator bundle", _ITEM_KERNEL)
        kind, halves = bundle.finalized()
        split = kind == "split"
        if split != (fit.model == "w0wacdm") or len(halves) != (2 if split else 1):
            _refuse(f"the {kind} emulator grid of {len(halves)} halves", _ITEM_KERNEL)
    else:
        # no grid: the CMB block alone (cmb.cmb, always lcdm) in the native
        # grid's instance, which then skips the projection and the contraction
        if not cmb_terms or fit.model == "w0wacdm":
            _refuse(f"a {fit.model} fit with no emulated term"
                    + ("" if cmb_terms else " and no CMB term"), _ITEM_PRESETS)
        split, halves = False, ()

    # per half: its forms and the columns of its coefficient vector,
    # reordered form by form, each window padded to whole quads
    per_half = [_half_forms(emulated, names, has_h0, h) for h in range(len(halves))]

    # assemble: offsets are in floats; float4 tables start on 16 bytes
    chunks = [np.zeros(HEADER_SIZE)]
    size = HEADER_SIZE

    def put(arr, align=1):
        nonlocal size
        pad = -size % align
        if pad:
            chunks.append(np.zeros(pad))
            size += pad
        off = size
        arr = np.asarray(arr, np.float64).reshape(-1)
        chunks.append(arr)
        size += arr.size
        return off

    def put_forms(forms, form_rows):
        for (f, _), rows in zip(forms, form_rows):
            f["F_ROWS"] = put(rows, align=4) if rows.size else 0
        block = np.zeros((len(forms), FORM_STRIDE))
        for i, (f, _) in enumerate(forms):
            for k, v in f.items():
                block[i, FORM[k]] = v
        return put(block)

    hdr["H_OFF_BOUNDS"] = put(np.concatenate([fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]]))
    rd_fields, rd_nodes = _rd_layout(emulated, names, fit.model)
    hdr.update(rd_fields)
    if rd_nodes is not None:
        hdr["H_OFF_RD"] = put(rd_nodes)
    half_layouts, dev, forms = (), None, []  # no emulated term: no grid, no forms
    if emulated and not split:
        # the representation as Tucker factors and a [r1, r2, R_all] core;
        # an exact table is Tucker with identity factors, one axis has r2 = 1
        half = halves[0]
        rep = half["rep"]
        n_axes = len(half["axes"])
        if rep[0] == "exact":
            factors, core = [np.eye(len(ax)) for ax in half["axes"]], rep[1]
        elif rep[0] == "tucker":
            factors, core = list(rep[1]), rep[2]
        else:
            _refuse(f"the {rep[0]} representation of a native grid", _ITEM_KERNEL)
        if n_axes == 1:
            core = core[:, None, :]
        for u in factors:
            if u.shape[0] > MAX_NODES or u.shape[1] > MAX_RANK_OUTER:
                _refuse(f"an emulator axis of {u.shape[0]} nodes at rank {u.shape[1]} "
                        f"(at most {MAX_NODES} and {MAX_RANK_OUTER})", _ITEM_KERNEL)
        forms, form_rows, cols = per_half[0]
        for i in range(2):
            hdr[f"H_OFF_AX{i + 1}"] = put(half["axes"][i] if i < n_axes else np.zeros(0))
            hdr[f"H_OFF_BW{i + 1}"] = put(half["bw"] if i < n_axes else np.zeros(0))
            # [n, r padded to 8 or 16 with zero columns], rows of float4s
            u = factors[i] if i < n_axes else np.zeros((0, 0))
            hdr[f"H_OFF_U{i + 1}"] = put(np.pad(u, ((0, 0), (0, _pad8(u.shape[1]) - u.shape[1]))),
                                         align=4)
        # the core as the matrix of the kernel's block product: row j KI + p
        # for the outer index j and the inner one p (the inner axis the one
        # of rank at most MAX_RANK whose padding to k-steps of 8 costs the
        # fewer rows; one axis: the outer index is 0), columns in window
        # order, zero padding
        core = _by_cols(core, cols)  # [r1, r2, 4 nq]
        r1, r2 = core.shape[:2]
        cost = {1: r2 * _pad8(r1), 2: r1 * _pad8(r2)}
        inner = min((i for i in ((2, 1) if n_axes > 1 else (1,)) if (r1, r2)[i - 1] <= MAX_RANK),
                    key=cost.get, default=None)
        if inner is None:
            _refuse(f"Tucker ranks {(r1, r2)[:n_axes]} (an inner axis of rank at most "
                    f"{MAX_RANK})", _ITEM_KERNEL)
        mat = core[:, 0][None] if n_axes == 1 else (
            core.transpose(1, 0, 2) if inner == 1 else core)  # [outer, inner, 4 nq]
        ldb = _core_ld(forms)
        stored = np.zeros((mat.shape[0], _pad8(mat.shape[1]), ldb))
        stored[:, :mat.shape[1], :mat.shape[2]] = mat
        hdr["H_OFF_CORE"] = put(stored, align=4)
        hdr["H_OFF_FORMS"] = put_forms(forms, form_rows)
        hdr.update(
            H_NAXES=n_axes, H_N1=factors[0].shape[0],
            H_N2=factors[1].shape[0] if n_axes > 1 else 0, H_R1=r1, H_R2=r2,
            H_NQ=len(cols) // 4, H_RALL=sum(c >= 0 for c in cols),
            H_KO=stored.shape[0], H_KI=stored.shape[1], H_LDB=ldb, H_INNER=inner,
        )
    elif split:
        # (Om, wa) axes shared by both halves, one s axis per half; every
        # axis of the split grid has the halves' one node count and bw
        axes0 = halves[0]["axes"]
        if any(not (np.array_equal(h["axes"][0], axes0[0])
                    and np.array_equal(h["axes"][1], axes0[1])
                    and np.array_equal(h["bw"], halves[0]["bw"])
                    and all(len(ax) == len(h["bw"]) for ax in h["axes"])) for h in halves):
            _refuse("split halves on different (Om, wa) grids", _ITEM_KERNEL)
        n = len(halves[0]["bw"])
        if n > MAX_NODES:
            _refuse(f"an emulator axis of {n} nodes (at most {MAX_NODES})", _ITEM_KERNEL)
        hdr["H_OFF_AX1"] = put(axes0[0])
        hdr["H_OFF_AX2"] = put(axes0[1])
        hdr["H_OFF_BW1"] = put(halves[0]["bw"])
        dev_chunks, dev_size = [], 0
        half_layouts = []
        for h, half in enumerate(halves):
            rep = half["rep"]
            if rep[0] == "tucker" and len(rep[1]) == 3:  # a half the compressor left Tucker
                rep = _tucker_as_tt(rep)
            if rep[0] != "tt" or len(rep[2]) != 3:
                _refuse(f"a split half as {rep[0]!r} (a three-core tensor train only)",
                        _ITEM_KERNEL)
            _, perm, cores, tail = rep
            forms, form_rows, cols = per_half[h]
            t = dict.fromkeys(HALF, 0.0)
            t["T_ONE"] = 1.0
            ax_s = put(half["axes"][2])
            r_prev = 1
            for i, g in enumerate(cores):
                g3 = g[None] if i == 0 else g  # [r_prev, n, r]
                if g3.shape[2] > MAX_BOND:
                    _refuse(f"a tensor-train bond of rank {g3.shape[2]} (at most {MAX_BOND})",
                            _ITEM_KERNEL)
                # the block products take r_in >= 8: a smaller bond into
                # one is padded with zeros (the same tensor train)
                r = max(g3.shape[2], MIN_RIN) if i < 2 else g3.shape[2]
                # [n r_prev][r]: row m r_prev + p, the block product's k;
                # whole slices of rows, columns to a multiple of 8
                full = np.zeros((g3.shape[1], r_prev, _pad8(r)))
                full[:, :g3.shape[0], :g3.shape[2]] = np.transpose(g3, (1, 0, 2))
                k = g3.shape[1] * r_prev
                stored = np.zeros((-(-k // KSLICE) * KSLICE, _pad8(r)))
                stored[:k] = full.reshape(k, -1)
                t[f"T_PERM{i}"] = perm[i]
                t[f"T_AX{i}"] = (hdr["H_OFF_AX1"], hdr["H_OFF_AX2"], ax_s)[perm[i]]
                t[f"T_N{i}"] = g3.shape[1]
                t[f"T_R{i + 1}"] = r
                t[f"T_G{i}"] = dev_size
                dev_chunks.append(stored.reshape(-1))
                dev_size += stored.size
                r_prev = r
            t["T_TAIL"] = dev_size
            dev_chunks.append(_by_cols(tail, cols).reshape(-1))  # [r3, 4 nq]
            dev_size += tail.shape[0] * len(cols)
            t.update(T_NQ=len(cols) // 4, T_RALL=sum(c >= 0 for c in cols),
                     T_OFF_FORMS=put_forms(forms, form_rows))
            half_layouts.append(t)
        if dev_size > MAX_DEV_FLOATS:
            _refuse(f"a device buffer of {dev_size} floats (at most {MAX_DEV_FLOATS})",
                    _ITEM_KERNEL)
        hdr["H_OFF_HALVES"] = put(np.concatenate([
            [t[k] for k in sorted(HALF, key=HALF.get)] + [0.0] * (HALF_STRIDE - len(HALF))
            for t in half_layouts
        ]))
        dev = torch.as_tensor(np.concatenate(dev_chunks), device=fit.device).to(fit.dtype)
        forms = per_half[0][0]
        hdr.update(
            H_NAXES=3, H_N1=len(axes0[0]), H_N2=len(axes0[1]), H_SPLIT=1,
            H_VROWS=max(_vrows(t) for t in half_layouts),
            H_SWEEP_F64=int(max(sweep_cancellation(emulated, h) for h in range(len(halves)))
                            > SWEEP_F64_RATIO),
        )

    cmb = {}
    if cmb_terms:
        t = cmb_terms[0]
        if t.meta["model"] != fit.model:
            _refuse(f"a CMB term of model {t.meta['model']!r} in a {fit.model} fit",
                    _ITEM_PRESETS)
        n_rs, n_dc = t.meta["orders"]
        if max(n_rs, n_dc) > MAX_GL:
            _refuse(f"CMB quadratures of {n_rs} and {n_dc} nodes (at most {MAX_GL})",
                    _ITEM_KERNEL)
        from cosmax_torch.ops.linalg import whitening_operator

        if "compression" in t.meta:
            comp = t.meta["compression"]
            obs, z_star, og = comp.observables, comp.z_star_variant, comp.o_gamma_h2
            consts = dict(C_PRIOR=comp.priors,
                          C_L=whitening_operator(np.linalg.inv(comp.inv_cov)))
        else:  # the theta* prior: ((theta_100 - 100 r_s / D_C) / sigma)^2
            ts = t.meta["theta_star"]
            obs, z_star, og = "theta_100", ts["z_star"], ts["o_gamma_h2"]
            consts = dict(C_PRIOR=np.array([ts["theta_100"]]), C_SIGMA=np.array([ts["sigma"]]))
        cmb = dict(
            C_OBS=OBSERVABLES.index(obs),
            C_ZSTAR=Z_STAR.index(z_star),
            C_I_OBH2=_index(names, "Obh2", "the baryon density"),
            C_NRS=n_rs,
            C_NDC=n_dc,
        )
        # 4 og as one constant: the per-term path divides by 4.0 * og, a
        # Python float, cast once to the runtime dtype
        block = np.zeros(CMB["C_NODES"])
        for k, v in dict(C_OG4=4.0 * og, **cmb).items():
            block[CMB[k]] = v
        for k, a in consts.items():
            block[CMB[k]:CMB[k] + a.size] = a.reshape(-1)
        hdr["H_OFF_CMB"] = put(np.concatenate([block, *gl_nodes_01(n_rs), *gl_nodes_01(n_dc)]))
    else:
        hdr["H_OFF_CMB"] = 0
    hdr.update(H_SIZE=size, H_NFORMS=len(forms), H_HAS_CMB=int(bool(cmb)))
    if size > MAX_FLOATS:
        _refuse(f"a constant buffer of {size} floats (at most {MAX_FLOATS})", _ITEM_KERNEL)
    smem = (split_smem_bytes if split else tucker_smem_bytes)(hdr)
    if smem > MAX_SMEM:
        _refuse(f"a block of {smem} bytes of shared memory (at most {MAX_SMEM})", _ITEM_KERNEL)
    flat = np.concatenate(chunks)
    for k, v in hdr.items():
        flat[HEADER[k]] = v
    buf = torch.as_tensor(flat, device=fit.device).to(fit.dtype)

    def layout(forms):
        return tuple(dict({k: int(f[k]) for k in _FORM_INTS}, n_cols=n) for f, n in forms)

    halves_out = tuple(
        dict({k: int(v) for k, v in t.items()}, forms=layout(per_half[h][0]))
        for h, t in enumerate(half_layouts)
    )
    return Packed(buf=buf, hdr=hdr, forms=layout(forms), cmb=cmb, halves=halves_out, dev=dev)


# --- the plain version -------------------------------------------------------


def _e_of_z(z, om, o_r, w0, wa, model):
    """E(z) with radiation (``o_r`` = 0 gives the radiation-free E
    exactly); walker values [W, 1] against nodes [W, n]."""
    opz = 1.0 + z
    cubed = opz * opz * opz
    if model == "lcdm":
        rho = torch.ones_like(z)
    elif model == "wcdm":
        rho = torch.exp(3.0 * (1.0 + w0) * torch.log(opz))
    elif model == "wzcdm":
        rho = torch.exp(2.0 * (1.0 + w0) * torch.log(2.0 * cubed / (1.0 + cubed)))
    else:  # w0wacdm (CPL)
        rho = torch.exp(3.0 * (1.0 + w0 + wa) * torch.log(opz) - 3.0 * wa * z / opz)
    ode = 1.0 - om - o_r
    return torch.sqrt(o_r * cubed * opz + om * cubed + ode * rho)


def _sound_horizon(t, w, z, rb, h0, cm, cr, cw, cwa, model):
    """r_s(z) by the GL rule (t, w) on [0, 1] in a: walker values [W, 1],
    z, h0 [W]."""
    a_end = (1.0 / (1.0 + z))[:, None]
    a = a_end * t
    ez = _e_of_z(1.0 / a - 1.0, cm, cr, cw, cwa, model)
    integ = C_KM_S / (a * a * ez * torch.sqrt(3.0 * (1.0 + rb * a)))
    return torch.sum(integ * (a_end * w), dim=-1) / h0


def _walker_rd(packed, col, h0, om, o_r, w0, wa, model):
    """The walker's r_d [W] (or a scalar), as ``H_RD_KIND`` says."""
    hdr, buf = packed.hdr, packed.buf
    kind = RD_KINDS[int(hdr["H_RD_KIND"])]
    val = buf[HEADER["H_RD"]]
    if kind in ("none", "fixed"):
        return val
    x = col(hdr["H_I_RD"])
    if kind == "param":
        return val * x
    if kind == "over_h":
        return x / (h0 / 100.0)
    wm = om * (h0 / 100.0) ** 2
    if kind == "aizpuru":
        return recombination.r_drag_aizpuru(x, wm)
    if kind == "desi":
        return recombination.r_drag_desi(x, wm, val)
    n = int(hdr["H_RD_N"])
    nodes = _seg(buf, hdr["H_OFF_RD"], 2 * n)
    cw, cwa = (None if v is None else v[:, None] for v in (w0, wa))
    rb = (3.0 * x / val)[:, None]
    return _sound_horizon(nodes[:n], nodes[n:], recombination.z_drag(x, wm), rb, h0,
                          om[:, None], o_r[:, None], cw, cwa, model)


def _seg(buf, off, n, shape=None):
    out = buf[int(off):int(off) + n]
    return out.reshape(shape) if shape is not None else out


def _factor(packed, i):
    """Tucker factor ``i`` (1 or 2) of the native grid, [n, r], from its
    stored rows padded to 8 or 16 columns."""
    hdr = packed.hdr
    n, r = int(hdr[f"H_N{i}"]), int(hdr[f"H_R{i}"])
    return _seg(packed.buf, hdr[f"H_OFF_U{i}"], n * _pad8(r), (n, _pad8(r)))[:, :r]


def _tucker_coeff(packed, om, w0):
    """[W, 4 nq] of the native grid: barycentric weights, factor
    projections, core contraction (the core read as the kernel's matrix
    [KO, KI, LDB])."""
    hdr, buf = packed.hdr, packed.buf
    ko, ki, ldb, nq = (int(hdr[k]) for k in ("H_KO", "H_KI", "H_LDB", "H_NQ"))
    coords = [om] + ([w0] if int(hdr["H_NAXES"]) > 1 else [])
    wps = []
    for i, x in enumerate(coords, 1):
        n = int(hdr[f"H_N{i}"])
        w = bary_vector(x, _seg(buf, hdr[f"H_OFF_AX{i}"], n), _seg(buf, hdr[f"H_OFF_BW{i}"], n))
        wps.append(w @ _factor(packed, i))
    core = _seg(buf, hdr["H_OFF_CORE"], ko * ki * ldb, (ko, ki, ldb))[..., :4 * nq]
    if len(wps) == 1:
        return wps[0] @ core[0, :wps[0].shape[1]]
    outer, inner = wps[::-1] if int(hdr["H_INNER"]) == 1 else wps
    a = torch.tensordot(outer, core[:, :inner.shape[1]], dims=([1], [0]))  # [W, r_in, R]
    return torch.einsum("wk,wkr->wr", inner, a)


def _tt_coeff(packed, h, coords):
    """[W, 4 nq] of half ``h`` of the split grid at ``coords`` (Om, wa,
    s): the tensor-train sweep over the device buffer's cores, through
    ``emu_core.coeff_contract``, in float64 whatever the buffers' dtype
    (the stored values read exactly), cast back to it. On the widest
    split-grid bundles (qsr.desi, qsr.des5y_desi) float32 sums in the
    sweep lose up to ~1e-4 of max|logp|: a float32 chain here would err
    as much as the kernel it is the oracle of."""
    lay = packed.halves[h]
    buf, dev = packed.f64()
    coords = [x.double() for x in coords]
    bw = _seg(buf, packed.hdr["H_OFF_BW1"], int(packed.hdr["H_N1"]))
    weights, cores, perm = [None] * 3, [], []
    r_prev = 1
    for i in range(3):
        n, r = lay[f"T_N{i}"], lay[f"T_R{i + 1}"]
        k = n * r_prev
        kp = -(-k // KSLICE) * KSLICE
        g = _seg(dev, lay[f"T_G{i}"], kp * _pad8(r), (kp, _pad8(r)))
        g = g[:k, :r].reshape(n, r_prev, r).permute(1, 0, 2)  # [r_prev, n, r]
        cores.append(g[0] if i == 0 else g)
        axis = lay[f"T_PERM{i}"]
        perm.append(axis)
        weights[axis] = bary_vector(coords[axis], _seg(buf, lay[f"T_AX{i}"], n), bw)
        r_prev = r
    tail = _seg(dev, lay["T_TAIL"], r_prev * 4 * lay["T_NQ"], (r_prev, 4 * lay["T_NQ"]))
    return coeff_contract(weights, ("tt", tuple(perm), cores, tail)).to(packed.buf.dtype)


def _forms_chi2(packed, forms, forms_off, a, theta, h0, t, rd):
    """(chi^2, log_norm) [W] of the emulated terms, each form over its
    own window of the coefficient vector ``a`` [W, 4 nq]; ``rd`` the
    walkers' r_d."""
    buf = packed.buf
    zero = torch.zeros_like(theta[:, 0])

    def col(i):
        return theta[:, int(i)]

    nforms = len(forms)
    form_rows = _seg(buf, forms_off, nforms * FORM_STRIDE, (nforms, FORM_STRIDE))
    chi2 = torch.zeros_like(zero)
    log_norm = torch.zeros_like(zero)
    for f, row in zip(forms, form_rows):
        v = {k: row[i] for k, i in FORM.items()}
        win = a[:, 4 * f["F_Q0"]:4 * (f["F_Q0"] + f["F_NQ"])]
        kind = KINDS[f["F_KIND"]]
        if kind == "linear":
            if f["F_BETA"] == 1:
                beta = C_KM_S / (h0 * rd)
            elif f["F_BETA"] == 2:
                beta = h0
            else:
                beta = torch.ones_like(h0)
            g0 = col(f["F_MAG_IDX"]) - v["F_OFFSET"] - v["F_GREF0"] if f["F_J"] > 0 else zero
            g1 = ((-5.0 * torch.log10(h0 / v["F_H0REF"]) - v["F_GREF1"]) if f["F_J"] > 1
                  else zero)
            rows = _seg(buf, f["F_ROWS"], 2 * f["F_NQ"] * PAIR_STRIDE,
                        (2 * f["F_NQ"], PAIR_STRIDE))
            e = (beta * v["F_SCALE"])[:, None] * (win[:, 0::2] + t * win[:, 1::2]) \
                - rows[:, PAIR["P_BA"]]
            pg = rows[:, PAIR["P_P0"]] * g0[:, None] + rows[:, PAIR["P_P1"]] * g1[:, None]
            fchi = (
                v["F_CREF"]
                + g0 * (v["F_S00"] * g0 + v["F_S01"] * g1) + g1 * (v["F_S10"] * g0 + v["F_S11"] * g1)
                - 2.0 * (g0 * v["F_QREF0"] + g1 * v["F_QREF1"])
                + (e * (e - 2.0 * rows[:, PAIR["P_V"]] + 2.0 * pg)).sum(-1)
            )
        elif kind == "lift":
            k = f["F_K"]
            rows = _seg(buf, f["F_ROWS"], (2 + 2 * f["F_NQ"]) * k)
            d_ref, sig2 = rows[:k], rows[k:2 * k]
            b = rows[2 * k:].reshape(2 * f["F_NQ"], k)
            dmu = (win[:, 0::2] + t * win[:, 1::2]) @ b
            var = sig2 + (col(f["F_I_S"]) ** 2)[:, None]
            delta = d_ref - dmu - col(f["F_I_OFF"])[:, None]
            fchi = (delta * delta / var).sum(-1)
            log_norm = log_norm - 0.5 * torch.log(var).sum(-1)
        else:
            amp = col(f["F_I_AMP"])[:, None]
            r = v["F_SCALE"] * ((win[:, 0::4] + t * win[:, 1::4])
                                - amp * (win[:, 2::4] + t * win[:, 3::4]))
            fchi = (r * r).sum(-1)
        if f["F_F_IDX"] >= 0:
            fv = col(f["F_F_IDX"])
            fchi = fchi * (1.0 / (fv * fv) if v["F_POW"] < 0 else fv * fv)
            log_norm = log_norm + (v["F_LN_CONST"] + v["F_LN_COEF"] * torch.log(fv))
        chi2 = chi2 + fchi
    return chi2, log_norm


def fused_log_prob_reference(packed: Packed, theta: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel over the same buffers: theta
    [W, D] -> logp [W], -inf outside the strict interior of the bounds
    or where the sum is not finite. On the split grid each walker
    computes its own half only, as the kernel does."""
    hdr, buf = packed.hdr, packed.buf
    theta = theta.to(buf.dtype)
    d = packed.dim

    def col(i):
        return theta[:, int(i)]

    model = MODELS[int(hdr["H_MODEL"])]
    zero = torch.zeros_like(theta[:, 0])
    h0 = (col(hdr["H_I_H0"]) * buf[HEADER["H_H0_SCALE"]] if hdr["H_I_H0"] >= 0
          else zero + buf[HEADER["H_H0_CONST"]])
    om = col(hdr["H_I_OM"])
    w0 = col(hdr["H_I_W0"]) if model != "lcdm" else None
    if hdr["H_W0_LOG"]:
        w0 = torch.log(w0)
    wa = col(hdr["H_I_WA"]) if model == "w0wacdm" else None
    o_r = buf[HEADER["H_ORH2"]] / (h0 / 100.0) ** 2 if hdr["H_ORH2"] != 0 else zero
    t = (o_r / OR_REF)[:, None]
    rd = _walker_rd(packed, col, h0, om, o_r, w0, wa, model) + zero

    if not packed.forms:  # no emulated term: the CMB block alone
        chi2, log_norm = torch.zeros_like(zero), torch.zeros_like(zero)
    elif not hdr["H_SPLIT"]:
        a = _tucker_coeff(packed, om, w0)
        chi2, log_norm = _forms_chi2(packed, packed.forms, hdr["H_OFF_FORMS"], a, theta, h0, t,
                                     rd)
    else:
        s = w0 + wa
        lower = s <= 0.0  # a NaN s takes half 1, as in the kernel
        chi2, log_norm = torch.zeros_like(zero), torch.zeros_like(zero)
        for h, rows in enumerate((lower, ~lower)):
            idx = rows.nonzero().squeeze(1)
            if idx.numel() == 0:
                continue
            lay = packed.halves[h]
            a = _tt_coeff(packed, h, (om[idx], wa[idx], s[idx]))
            c, ln = _forms_chi2(packed, lay["forms"], lay["T_OFF_FORMS"], a, theta[idx],
                                h0[idx], t[idx], rd[idx])
            chi2 = chi2.index_put((idx,), c)
            log_norm = log_norm.index_put((idx,), ln)

    if packed.cmb:
        chi2 = chi2 + _cmb_chi2(packed, col, h0, om, o_r, w0, wa, model)
    if hdr["H_PRIOR"]:
        mean, sigma = buf[HEADER["H_PRIOR_MEAN"]], buf[HEADER["H_PRIOR_SIGMA"]]
        x = om * (h0 / 100.0) ** 2 if PRIORS[hdr["H_PRIOR"]] == "omh2" else col(hdr["H_I_PRIOR"])
        res = (mean - x) / sigma
        chi2 = chi2 + res * res

    bounds = _seg(buf, hdr["H_OFF_BOUNDS"], 2 * d)
    ll = -0.5 * chi2 + log_norm
    ok = torch.all((bounds[:d] < theta) & (theta < bounds[d:]), dim=-1) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -torch.inf))


def _cmb_chi2(packed, col, h0, om, o_r, w0, wa, model):
    """The compressed-CMB chi^2: z* fit, r_s by GL in a, D_C by GL in
    ln a, the three observables and the 3 x 3 whitening; or the theta*
    prior from the same r_s and D_C."""
    c = packed.cmb
    base = int(packed.hdr["H_OFF_CMB"])
    block = packed.buf[base:]
    n_rs, n_dc = c["C_NRS"], c["C_NDC"]
    nodes = block[CMB["C_NODES"]:CMB["C_NODES"] + 2 * (n_rs + n_dc)]
    t_rs, w_rs = nodes[:n_rs], nodes[n_rs:2 * n_rs]
    t_dc, w_dc = nodes[2 * n_rs:2 * n_rs + n_dc], nodes[2 * n_rs + n_dc:]
    wb = col(c["C_I_OBH2"])
    wm = om * (h0 / 100.0) ** 2
    zs = (recombination.z_star_hu if Z_STAR[c["C_ZSTAR"]] == "hu" else recombination.z_star)(
        wb, wm)
    cm, cr = om[:, None], o_r[:, None]
    cw, cwa = (None if x is None else x[:, None] for x in (w0, wa))

    rb = (3.0 * wb / block[CMB["C_OG4"]])[:, None]
    rs = _sound_horizon(t_rs, w_rs, zs, rb, h0, cm, cr, cw, cwa, model)

    u0 = torch.log(1.0 / (1.0 + zs))[:, None]
    a = torch.exp(u0 * (1.0 - t_dc))
    ez = _e_of_z(1.0 / a - 1.0, cm, cr, cw, cwa, model)
    dm = torch.sum(C_KM_S / (a * ez) * (-u0 * w_dc), dim=-1) / h0

    obs = OBSERVABLES[c["C_OBS"]]
    if obs == "theta_100":
        res = (block[CMB["C_PRIOR"]] - 100.0 * rs / dm) / block[CMB["C_SIGMA"]]
        return res * res
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
    the kernel, which takes a contiguous float32 theta on the buffers'
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
    split = bool(packed.hdr["H_SPLIT"])
    tensors = [("theta", theta), ("constant buffer", packed.buf)]
    if split:
        if packed.dev.device != theta.device:
            raise ValueError(f"theta on {theta.device} but the TT cores on {packed.dev.device}")
        tensors.append(("TT buffer", packed.dev))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes a float32 {name}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {name}")
    if packed.buf.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a constant buffer that starts on 16 bytes")
    w = theta.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=theta.device)
    if w == 0:
        return out
    from cosmax_torch.ops.kernels.build import load_kernel

    fn = _entry(load_kernel("fused_log_prob").lib)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(packed.buf.data_ptr(), packed.buf.numel(),
                 packed.dev.data_ptr() if split else None, instance(packed), _stride(packed),
                 theta.data_ptr(), out.data_ptr(), w, packed.dim, stream)
    if err != 0:
        raise RuntimeError(f"fused_log_prob kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def instance(packed: Packed) -> int:
    """The kernel's instance argument: 0 the native grid, 1 the split grid
    in 3xTF32, 2 the split grid with its sweep in f64 (``H_SWEEP_F64``)."""
    h = packed.hdr
    return int(h["H_SPLIT"]) + int(h["H_SPLIT"] and h["H_SWEEP_F64"])


def _stride(packed: Packed) -> int:
    """The kernel's scratch argument: the rows of WLD floats of a warp's
    projections (native grid: KO + KI), or the rows of VLD floats of the
    split grid's weights and sweep vectors."""
    h = packed.hdr
    return int(h["H_N1"]) + WPAD + int(h["H_VROWS"]) if h["H_SPLIT"] else int(h["H_KO"] + h["H_KI"])


def occupancy(packed: Packed) -> tuple:
    """(bytes of shared memory a block, blocks an SM holds at once) of the
    kernel's launch for ``packed``, from the CUDA runtime (builds the
    kernel; needs a card)."""
    from cosmax_torch.ops.kernels.build import load_kernel

    fn = load_kernel("fused_log_prob").lib.cosmax_fused_log_prob_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = fn(packed.buf.numel(), instance(packed), _stride(packed), ctypes.byref(smem),
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"fused_log_prob occupancy query failed: cudaError {err}")
    return smem.value, blocks.value


def _entry(lib: ctypes.CDLL):
    fn = lib.cosmax_fused_log_prob_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


# --- the work of one call, for the bound -------------------------------------


def work_per_walker(packed: Packed, half: int = 0) -> tuple:
    """(f32 operations, product operations, bytes) per walker of the
    fused log-prob, counted from the packed sizes: an FMA is 2
    operations, every other arithmetic operation (division, square root,
    exp, log, pow) 1. Product operations are what the kernel runs as block
    products on the tensor cores: the native grid's core contraction, 2 r1
    r2 R_all, and the split grid's tensor-train steps with r_in > 1, 2 n
    r_in r each; f32 operations are all the rest. Only the columns the
    forms use count, not the zero padding; on the split grid, a walker of ``half`` (the minimal sweep of
    that half's tensor train, as ``emu_core.eval_flops`` counts it). Bytes
    are theta read once and logp written once; the constant buffers (read
    once per call) are left out of the per-walker count."""
    h = packed.hdr
    ops, product = 10, 0  # derived parameters and the bounds test
    ops += int(h["H_W0_LOG"])  # w0 = log(exp_w0)
    rd_kind = RD_KINDS[int(h["H_RD_KIND"])]
    if rd_kind in ("param", "over_h"):
        ops += 1
    elif rd_kind in ("aizpuru", "desi"):
        ops += 20  # wm, the fitting formula's powers and sums
    elif rd_kind == "z_drag":
        # wm, z_drag's three powers, then per node E(z) ~19 (~24 with CPL's
        # exponent) and the integrand and the sum ~14, as the CMB's r_s
        ops += 12 + int(h["H_RD_N"]) * (33 + (5 if h["H_SPLIT"] else 0))
    if not h["H_SPLIT"]:
        forms = packed.forms
        for i in (1, 2)[:int(h["H_NAXES"])]:
            n, r = h[f"H_N{i}"], h[f"H_R{i}"]
            ops += n * (4 + 2 * r) + r + 1  # one barycentric pass into the projection, its scale
        r1, r2 = h["H_R1"], h["H_R2"]
        ops += r1 * r2  # wp1 (x) wp2
        product += 2 * r1 * r2 * h["H_RALL"]  # its dot with the core
    else:
        lay = packed.halves[half]
        forms = lay["forms"]
        ops += 2  # s and the half's select
        r_prev = 1
        for i in range(3):
            n, r = lay[f"T_N{i}"], lay[f"T_R{i + 1}"]
            ops += 8 * n  # barycentric sum and weights
            if i == 0:
                ops += 2 * n * r
            else:  # v' = v (w . G): the product, and r_prev r for the weights
                product += 2 * n * r_prev * r
                ops += 2 * r_prev * r
            r_prev = r
        ops += 2 * r_prev * lay["T_RALL"]  # a = v^T tail, the columns the forms use
    for f in forms:
        kind, n = KINDS[f["F_KIND"]], f["n_cols"]
        if kind == "linear":
            ops += 25 + 7 * n  # beta and nuisances; per pair the axpy, e and its dot
        elif kind == "lift":
            k = f["F_K"]
            ops += n * (1 + k)  # per pair the axpy and its lift into K values
            ops += 3 + 8 * k  # variance, residual, division, square-add, log per bin
        else:
            ops += 11 * n // 4  # per quad two axpys, the residual and its square
        if f["F_F_IDX"] >= 0:
            ops += 6  # f^power, log f
    if packed.cmb:
        n_rs, n_dc = packed.cmb["C_NRS"], packed.cmb["C_NDC"]
        # z*; per node E(z) is ~19 (cube, log, exp, sqrt; ~24 with CPL's
        # exponent), the integrand and the sum ~14 for r_s, ~10 for D_C;
        # the observables and 3 x 3
        cpl = 5 if h["H_SPLIT"] else 0
        # the theta* prior: 100 r_s / D_C, its residual over sigma, squared
        last = 5 if OBSERVABLES[packed.cmb["C_OBS"]] == "theta_100" else 40
        ops += 30 + n_rs * (33 + cpl) + n_dc * (29 + cpl) + last
    if h["H_PRIOR"]:
        # Om h^2 (or the sampled parameter), the residual, its division and square
        ops += 6 if PRIORS[int(h["H_PRIOR"])] == "omh2" else 3
    return int(ops), int(product), 4 * (packed.dim + 1)
