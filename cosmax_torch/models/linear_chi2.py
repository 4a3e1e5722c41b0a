"""Rank-space emulators for whitened chi^2 terms that are linear in every
non-geometric parameter (counterpart of ``cosmax/models/linear_chi2.py``).

The SN and BAO residuals share one shape,

    r(p) = u0 - beta(p) * y(theta) - W @ gamma(p),

where ``theta`` is the dark-energy family's geometric parameters (Om,
w0[, wa]) plus the small radiation density Or, and ``beta``/``gamma``
are cheap analytic functions of the other parameters (BAO: beta = c/(H0
r_d); SN: gamma = (magnitude shift, -5 log10(h/h_ref))).

Build (f64, disk-cached): each term's c-space curve is tabulated on a
Chebyshev grid over the family's domain, with and without Or = OR_REF
(w0wacdm: two halves on the rotated axes (Om, wa, s = w0 + wa), split at
s = 0, where the curves lose smoothness);
a per-term truncated SVD over the stacked [base; Or-delta] rows gives
its coefficient table; and chi^2 is expanded exactly around a fixed
reference point so that the f32 runtime does not cancel:

    e = beta(p) * s_t * (a_t + t ad_t) - beta_ref * s_t * a_ref
    g = gamma(p) - gamma_ref
    chi2 = c_ref - 2 e.v_ref + e.e + g.(S g - 2 q_ref) + 2 e.(P g)

**Bundling.** All terms of one fast-mode scope that share (model, grid,
device, dtype) register their curves into one bundle. Their coefficient
tables are stacked along one axis and co-compressed into a single
Tucker or tensor-train program per half, so the joint's geometry costs
one barycentric contraction per walker, and each term slices its
coefficients out of the shared [R_all] vector. The per-term torch path evaluates that
contraction once per term; the fused kernel
(``ops/kernels/fused_log_prob.py``) evaluates it once per walker.

The truncations are held to an absolute elementwise contract in each
term's own scaled units (TOL_SCALE * max|table|).

Two more shapes ride the same contraction: ``make_curve_values`` (the
quasar distance-modulus curve, whose parameter-dependent metric cannot
be folded into a fixed form) and ``make_amp_pair_chi2`` (the fs8
data/theory pair, one group with one basis, whose residual coefficient
is formed before squaring).

The split w0wacdm grid (``_grid_spec`` over (Om, wa, s = w0 + wa), each
walker in the half its s selects, a tensor train per half) takes every
shape above: linear forms, curve values and amplitude pairs.

Each finalized half keeps the seconds its build took (``seconds``: each
curve's base and radiation tables, and the compression).
"""

import contextvars
import hashlib
import time
from contextlib import contextmanager

import numpy as np
import scipy.linalg
import torch

from cosmax_torch.models.emu_core import (
    DOMAINS,
    MODEL_PARAMS,
    OR_REF,
    bary_vector,
    bary_vector_np,
    bary_weights,
    cheb_nodes,
    coeff_contract,
    compress,
    flatten_grid,
    svd_rank_factor,
    table_cached,
)

# Truncation contract, relative to each term's own max|table|.
TOL_SCALE = 1e-6

# Finalized bundles (f64 numpy, independent of device and dtype), keyed
# by model, grid, domains and registrations.
_FINALIZE_MEMO = {}

# The split grid's sweep runs in f64 where a float32 one would cancel,
# i.e. where some group's table scale (its max |value| over the padded
# grid) exceeds its largest |value| at a half's reference centre more
# than SWEEP_F64_RATIO times (``window_cancellation``): the fused
# kernel's f64 instance (``H_SWEEP_F64``) and the per-term path's
# contraction (``_Bundle.sweep_f64``) take the same rule.
SWEEP_F64_RATIO = 1e3


def window_cancellation(windows) -> float:
    """How far a half's groups would cancel in a float32 sweep: the
    largest ratio, over the groups' windows ``(slots, B_t, scale)``, of a
    group's table scale to its largest |value| at the half's reference
    centre, i.e. 1 / max|a_ref B_t| in the group's scaled units."""
    worst = 0.0
    for slots, b_t, _ in windows:
        mag = max(float(np.max(np.abs(a_ref @ b_t))) for _, _, a_ref in slots)
        worst = max(worst, float("inf") if mag == 0.0 else 1.0 / mag)
    return worst


def _hash_arrays(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
    return h.hexdigest()


def _cached_curve(model, curve_fn, flat, to_params, map_tag, tag, key_extra):
    # ``model`` must be part of the key: wcdm and wzcdm share the grid
    # parameters ("Om", "w0"), so their nodes and map_tag coincide on
    # equal domains, and one family's tables would serve the other.
    key = (
        "linear_curve",
        model,
        tag,
        key_extra,
        map_tag,
        np.asarray(flat, np.float64).tobytes(),
    )
    return table_cached(
        "linear_curve", key, lambda: np.asarray(curve_fn(flat, to_params), np.float64)
    )


def _grid_spec(model, n_nodes, domains):
    """The family's grid: ``(kind, [(axes, to_params, map_tag,
    theta_ref_vec)])``, one entry per half. ``to_params`` maps grid
    thetas [M, P] (an f64 tensor) to a dict of [M] tensors.

    w0wacdm is ``"split"``: two halves on (Om, wa, s = w0 + wa), one for
    s <= 0 and one for s > 0, each a 40-node Chebyshev grid, s = 0 a
    Lobatto endpoint of both. Every other family is ``"native"``: one
    grid on its own parameters."""

    def dom(nm):
        return domains.get(nm, DOMAINS[nm])

    def clamp_ref(x, lo, hi):
        return min(max(x, lo + 0.25 * (hi - lo)), hi - 0.25 * (hi - lo))

    if model == "w0wacdm":
        n = 40 if n_nodes is None else n_nodes
        om_ax = cheb_nodes(n, *dom("Om"))
        wa_ax = cheb_nodes(n, *dom("wa"))
        s_bounds = (dom("w0")[0] + dom("wa")[0], dom("w0")[1] + dom("wa")[1])
        om_ref = clamp_ref(0.3, *dom("Om"))
        wa_ref = clamp_ref(0.0, *dom("wa"))
        # each half needs a non-degenerate interval even when the box
        # lies on one side of s = 0 (the unselected half still builds)
        s_lo = (min(s_bounds[0], -1e-2), 0.0)
        s_hi = (0.0, max(s_bounds[1], 1e-2))
        halves = []
        for s_dom in (s_lo, s_hi):
            halves.append((
                [om_ax, wa_ax, cheb_nodes(n, *s_dom)],
                lambda th: {"Om": th[:, 0], "wa": th[:, 1], "w0": th[:, 2] - th[:, 1]},
                "w0wa-rot",
                (om_ref, wa_ref, 0.5 * (s_dom[0] + s_dom[1])),
            ))
        return "split", halves

    pnames = MODEL_PARAMS[model]
    if n_nodes is None:
        n_nodes = {1: 48, 2: 32}[len(pnames)]
    axes = [cheb_nodes(n_nodes, *dom(nm)) for nm in pnames]
    ref = {"Om": 0.3, "w0": -1.0}
    return "native", [(
        axes,
        lambda th: dict(zip(pnames, th.unbind(-1))),
        ("native",) + pnames,
        tuple(clamp_ref(ref[nm], *dom(nm)) for nm in pnames),
    )]


class _Handle:
    """A term's window into its bundle, set at finalize: per half
    ``(slots, B_t [R_t, K] f64, scale_t)`` with one ``(sl_a, sl_d,
    a_ref_t [R_t] f64)`` slot per curve."""

    def __init__(self, bundle):
        self.bundle = bundle
        self.per_half = None
        self.gen = -1  # bumped by each finalize; guards stale forms


class _Bundle:
    """All linear-chi^2 curves of one (model, n_nodes, device, dtype)
    inside one fast-mode scope, co-compressed into one program."""

    def __init__(self, model, n_nodes, device, dtype):
        self.model = model
        self.n_nodes = n_nodes
        self.device = torch.device(device)
        self.dtype = dtype
        self.domains = {}  # param -> (lo, hi); falls back to DOMAINS
        self.regs = {}  # (tag, key_extra) -> (curve_fns, _Handle)
        self._final = None
        self._gen = 0
        self._tensors = {}

    def set_domains(self, domains):
        if domains != self.domains:
            self.domains = dict(domains)
            self._final = None

    def register(self, curve_fns, tag, key_extra):
        key = (tag, key_extra)
        if key not in self.regs:
            self.regs[key] = (tuple(curve_fns), _Handle(self))
            self._final = None  # a new curve: refinalize lazily
        return self.regs[key][1]

    def finalized(self):
        if self._final is None:
            memo_key = (
                self.model,
                self.n_nodes,
                tuple(sorted(self.domains.items())),
                tuple(sorted(self.regs)),
            )
            if memo_key not in _FINALIZE_MEMO:
                _FINALIZE_MEMO[memo_key] = self._build()
            self.install(*_FINALIZE_MEMO[memo_key])
        return self._final

    def install(self, final, per_reg):
        """Adopt a finalized program ``(kind, halves)`` and each
        registration's per-half window (``per_reg[(tag, key_extra)]``);
        every handle moves to the new generation."""
        self._gen += 1
        self._final = final
        self._tensors = {}
        for key, (_, handle) in self.regs.items():
            handle.per_half = per_reg[key]
            handle.gen = self._gen

    @property
    def sweep_f64(self) -> bool:
        """Whether the split grid's contraction runs in f64 on a float32
        runtime (``SWEEP_F64_RATIO``): qsr.desi and qsr.des5y_desi in
        w0wacdm, whose BAO tables reach Om = 0."""
        kind, halves = self.finalized()
        if "sweep_f64" not in self._tensors:  # cleared by each install
            self._tensors["sweep_f64"] = kind == "split" and max(
                window_cancellation([h.per_half[i] for _, h in self.regs.values()])
                for i in range(len(halves))
            ) > SWEEP_F64_RATIO
        return self._tensors["sweep_f64"]

    def _build(self):
        kind, halves_spec = _grid_spec(self.model, self.n_nodes, self.domains)
        reg_keys = sorted(self.regs)
        halves = []
        per_reg = {key: [] for key in reg_keys}
        for axes, to_params, map_tag, theta_ref_vec in halves_spec:
            # the build's seconds: "<tag>[<curve>] base" and "... or" (a
            # table cache hit takes ~0), "compress"
            seconds = {}
            node_shape = [len(ax) for ax in axes]
            flat = flatten_grid(axes)

            def to_params_or(th, to_params=to_params):
                return dict(to_params(th), Or=OR_REF)

            blocks, projs, refs = [], [], []
            offset = 0
            windows = {}
            for key in reg_keys:
                curve_fns = self.regs[key][0]
                tag, key_extra = key
                tabs = []
                for ci, cf in enumerate(curve_fns):
                    ce = key_extra if len(curve_fns) == 1 else (key_extra, ci)
                    t0 = time.perf_counter()
                    base = _cached_curve(self.model, cf, flat, to_params, map_tag, tag, ce)
                    t1 = time.perf_counter()
                    d = _cached_curve(
                        self.model, cf, flat, to_params_or, (map_tag, "or", OR_REF), tag, ce,
                    ) - base
                    seconds[f"{tag}[{ci}] base"] = t1 - t0
                    seconds[f"{tag}[{ci}] or"] = time.perf_counter() - t1
                    for which, t in (("base", base), ("or-delta", d)):
                        if not np.all(np.isfinite(t)):
                            i = int(np.argwhere(~np.isfinite(t).all(axis=-1))[0, 0])
                            raise FloatingPointError(
                                f"linear_chi2 table '{tag}' ({which}) is non-finite at "
                                f"grid node theta={flat[i].tolist()}: the padded domain "
                                "left the curve's physical region (see set_scope_domains)"
                            )
                    tabs.append((base, d))
                # one scale per group, so that the contract holds in the
                # group's own units
                scale = float(max(np.max(np.abs(b)) for b, _ in tabs))
                # one orthonormal B_t for every curve of the group and its
                # radiation delta: the Or correction is an axpy on the slice
                a_all, b_t = svd_rank_factor(
                    np.concatenate([t for pair in tabs for t in pair], axis=0) / scale,
                    TOL_SCALE,
                )
                m = tabs[0][0].shape[0]
                r_t = b_t.shape[0]
                slots = []
                for ci, (base, dtab) in enumerate(tabs):
                    a_fac = a_all[2 * ci * m:(2 * ci + 1) * m]
                    ad_fac = a_all[(2 * ci + 1) * m:(2 * ci + 2) * m]
                    blocks.extend([a_fac, ad_fac])
                    projs.extend([b_t, b_t])
                    refs.extend([base / scale, dtab / scale])
                    a_ref = a_fac.reshape(*node_shape, -1)
                    for x, ax in zip(theta_ref_vec, axes):
                        a_ref = np.tensordot(bary_vector_np(x, ax), a_ref, axes=(0, 0))
                    slots.append((
                        slice(offset, offset + r_t),
                        slice(offset + r_t, offset + 2 * r_t),
                        np.asarray(a_ref, np.float64),
                    ))
                    offset += 2 * r_t
                windows[key] = (tuple(slots), b_t, scale)

            stacked = np.concatenate(blocks, axis=1)  # [M, R_all]
            t0 = time.perf_counter()
            rep = compress(
                stacked.reshape(*node_shape, -1),
                node_shape,
                TOL_SCALE,
                proj=scipy.linalg.block_diag(*projs),
                ref=np.concatenate(refs, axis=1),
            )
            seconds["compress"] = time.perf_counter() - t0
            halves.append(dict(rep=rep, axes=list(axes), bw=bary_weights(len(axes[0])),
                               seconds=seconds))
            for key in reg_keys:
                per_reg[key].append(windows[key])
        return (kind, halves), per_reg

    def runtime(self, half_index, dtype=None):
        """The half's program as tensors on the bundle's device, in
        ``dtype`` (default the bundle's)."""
        kind, halves = self.finalized()
        dtype = self.dtype if dtype is None else dtype
        if (half_index, dtype) not in self._tensors:
            half = halves[half_index]

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=self.device).to(dtype)

            rep = half["rep"]
            if rep[0] == "exact":
                rep_t = ("exact", t(rep[1]))
            elif rep[0] == "tucker":
                rep_t = ("tucker", [t(u) for u in rep[1]], t(rep[2]))
            else:
                rep_t = ("tt", rep[1], [t(g) for g in rep[2]], t(rep[3]))
            self._tensors[half_index, dtype] = dict(
                axes=[t(ax) for ax in half["axes"]], bw=t(half["bw"]), rep=rep_t,
            )
        return self._tensors[half_index, dtype]

    def coeff(self, p, half_index):
        """The shared [W, R_all] coefficient vectors at walker params
        ``p``; on the split grid in f64 where ``sweep_f64`` says so, cast
        back to the bundle's dtype."""
        if self.model == "w0wacdm":
            coords = (p["Om"], p["wa"], p["w0"] + p["wa"])
        else:
            coords = [p[nm] for nm in MODEL_PARAMS[self.model]]
        dtype = torch.float64 if self.sweep_f64 else self.dtype
        rt = self.runtime(half_index, dtype)
        # the barycentric weights in f64 whatever the runtime dtype: their
        # autograd derivative, d/dx of num / sum(num), sums terms of order
        # 1 / (x - x_k)^2 that cancel, and in float32 a walker near a
        # node x_k loses the gradient along that axis
        nodes = self.runtime(half_index, torch.float64)
        weights = [bary_vector(x.double(), ax, nodes["bw"]).to(dtype)
                   for x, ax in zip(coords, nodes["axes"])]
        return coeff_contract(weights, rt["rep"]).to(self.dtype)


# --- fast-mode scoping -------------------------------------------------------

_SCOPES = contextvars.ContextVar("cosmax_torch_bundle_scopes", default=())


@contextmanager
def bundle_scope():
    """Terms built inside one scope co-compress per (model, n_nodes,
    device, dtype); ``fastmode.use_fast_mode`` opens one, so
    ``get_preset(fast=True)`` bundles each preset's terms together.
    Bundles finalize at scope exit."""
    scope = {}
    token = _SCOPES.set(_SCOPES.get() + (scope,))
    try:
        yield
    finally:
        _SCOPES.reset(token)
        for bundle in scope.values():
            bundle.finalized()


def _get_bundle(model, n_nodes, device, dtype):
    scopes = _SCOPES.get()
    if scopes:
        bkey = (model, n_nodes, torch.device(device), dtype)
        if bkey not in scopes[-1]:
            scopes[-1][bkey] = _Bundle(model, n_nodes, device, dtype)
        return scopes[-1][bkey]
    return _Bundle(model, n_nodes, device, dtype)  # unscoped: a private bundle


def set_scope_domains(bounds_by_name, pad: float = 0.03):
    """Narrow every bundle of the active scope to the caller's prior box,
    padded so that the box edges stay interior to the grid. Om is
    clamped to [0, 1 - OR_REF]: past either end a density coefficient of
    the tables goes negative and E^2 can turn negative (non-finite
    tables, refused at finalize)."""
    scopes = _SCOPES.get()
    if not scopes:
        return
    domains = {}
    for nm in ("Om", "w0", "wa"):
        if nm in bounds_by_name:
            lo, hi = bounds_by_name[nm]
            w = pad * (hi - lo)
            lo, hi = float(lo - w), float(hi + w)
            if nm == "Om":
                lo, hi = max(lo, 0.0), min(hi, 1.0 - OR_REF)
            domains[nm] = (lo, hi)
    for bundle in scopes[-1].values():
        bundle.set_domains(domains)


# --- the per-term quadratic form --------------------------------------------


def _col(x):
    """[W] walker values as a [W, 1] column; scalars pass through."""
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() > 0 else x


class LinearChi2:
    """Emulated ``chi2(p) -> [W]`` for r(p) = u0 - beta(p) y(theta) - W gamma(p).

    Built by :func:`make_linear_chi2`. ``form(half_index)`` gives the
    half's f64 quadratic-form constants (the fused kernel's packer reads
    them); calling the object evaluates chi^2 with plain torch ops.
    """

    def __init__(self, bundle, handle, u0_c, u0_sq, w_c, q0, s_mat, beta_fn, gamma_fn,
                 beta_ref, gamma_ref):
        self.bundle = bundle
        self.handle = handle
        self.u0_c = np.asarray(u0_c, np.float64)
        self.u0_sq = float(u0_sq)
        self.n_w = 0 if w_c is None else np.asarray(w_c).shape[1]
        if self.n_w:
            self.w_c = np.asarray(w_c, np.float64)
            self.q0 = np.asarray(q0, np.float64)
            self.s_mat = np.asarray(s_mat, np.float64)
            self.g_ref = (
                np.zeros(self.n_w) if gamma_ref is None
                else np.asarray(gamma_ref, np.float64)
            )
        self.beta_fn = beta_fn
        self.gamma_fn = gamma_fn
        self.beta_ref = float(beta_ref)
        self._forms = {}

    def form(self, half_index):
        """The half's quadratic-form constants (f64 numpy), rebuilt when a
        later registration refinalizes the bundle and re-windows the
        handle."""
        self.bundle.finalized()
        if self._forms.get("gen") != self.handle.gen:
            self._forms = {"gen": self.handle.gen}
        if half_index not in self._forms:
            slots, b_t, scale = self.handle.per_half[half_index]
            sl_a, sl_d, a_ref = slots[0]
            v0 = b_t @ self.u0_c  # [R_t]
            bs_ref = self.beta_ref * scale
            v_ref = v0 - bs_ref * a_ref
            c_ref = (
                self.u0_sq - 2.0 * bs_ref * float(a_ref @ v0)
                + bs_ref**2 * float(a_ref @ a_ref)
            )
            form = dict(sl_a=sl_a, sl_d=sl_d, scale=scale, ba_ref=bs_ref * a_ref)
            if self.n_w:
                p_mat = b_t @ self.w_c  # [R_t, J]
                q_ref = self.q0 - bs_ref * (p_mat.T @ a_ref)
                c_ref += float(-2.0 * self.g_ref @ q_ref + self.g_ref @ self.s_mat @ self.g_ref)
                form.update(
                    p_mat=p_mat,
                    q_ref=q_ref - self.s_mat @ self.g_ref,
                    s_mat=self.s_mat,
                    g_ref=self.g_ref,
                )
                v_ref = v_ref - p_mat @ self.g_ref
            form.update(v_ref=v_ref, c_ref=c_ref)
            self._forms[half_index] = form
        return self._forms[half_index]

    def _form_tensors(self, half_index):
        key = ("t", half_index)
        form = self.form(half_index)
        if key not in self._forms:
            b = self.bundle
            self._forms[key] = {
                k: torch.as_tensor(v, device=b.device).to(b.dtype)
                for k, v in form.items() if isinstance(v, np.ndarray)
            }
        return form, self._forms[key]

    def half_chi2(self, p, half_index):
        a_all = self.bundle.coeff(p, half_index)  # [W, R_all]
        form, ft = self._form_tensors(half_index)
        a = _or_axpy(a_all, form["sl_a"], form["sl_d"], p)
        beta = 1.0 if self.beta_fn is None else _col(self.beta_fn(p))
        e = (beta * form["scale"]) * a - ft["ba_ref"]
        out = form["c_ref"] - 2.0 * (e @ ft["v_ref"]) + (e * e).sum(-1)
        if self.n_w:
            g = self.gamma_fn(p) - ft["g_ref"]  # [W, J]
            out = (
                out
                + ((g @ ft["s_mat"].T) * g).sum(-1)
                - 2.0 * (g @ ft["q_ref"])
                + 2.0 * (e * (g @ ft["p_mat"].T)).sum(-1)
            )
        return out

    def __call__(self, p):
        return _dispatch_halves(self.bundle, p, self.half_chi2)


def make_linear_chi2(
    model: str,
    curve_fn,
    tag: str,
    key_extra: str,
    u0_c,
    u0_sq: float,
    device,
    dtype=torch.float32,
    w_c=None,
    q0=None,
    s_mat=None,
    beta_fn=None,
    gamma_fn=None,
    beta_ref: float = 1.0,
    gamma_ref=None,
    n_nodes: int = None,
) -> LinearChi2:
    """Emulated ``chi2(p) -> [W]`` for r(p) = u0 - beta(p) y(theta) - W gamma(p).

    ``curve_fn(flat [M, P] f64 numpy, to_params) -> [M, K]`` evaluates the
    c-space curve (an isometric image of the whitened theory vector) at
    grid nodes in f64 on the CPU; it is disk-cached under ``(model, tag,
    key_extra, grid)``, so ``key_extra`` must hash every array the curve
    closes over. The caller gives the u0- and W-side inner products in
    full residual space: ``u0_c`` [K], ``u0_sq`` = |u0|^2, ``w_c`` [K, J],
    ``q0`` = W^T u0 [J], ``s_mat`` = W^T W [J, J]. ``beta_fn(p)`` defaults
    to 1; ``gamma_fn(p) -> [W, J]`` is required when W is given.
    """
    bundle = _get_bundle(model, n_nodes, device, dtype)
    handle = bundle.register((curve_fn,), tag, key_extra)
    if not _SCOPES.get():
        bundle.finalized()  # a solo bundle builds now
    return LinearChi2(
        bundle, handle, u0_c, u0_sq, w_c, q0, s_mat, beta_fn, gamma_fn, beta_ref, gamma_ref,
    )


def _dispatch_halves(bundle, p, half_fn):
    """``half_fn(p, i)`` under the family's half-selection rule: the
    split w0wacdm grid evaluates both halves and selects per walker,
    half 0 where s = w0 + wa <= 0 (branch-free, so the seam stays
    differentiable, as the reference does); a native grid is half 0."""
    kind, _ = bundle.finalized()
    if kind == "split":
        s = torch.as_tensor(p["w0"] + p["wa"])
        lower = s <= 0.0
        # each half sees the other half's walkers at the seam (w0 = -wa,
        # s = 0), not off its grid: there its partials may be infinite,
        # and 0 * inf through the select would make the gradient NaN
        seam = -p["wa"]
        lo = half_fn(dict(p, w0=torch.where(lower, p["w0"], seam)), 0)
        hi = half_fn(dict(p, w0=torch.where(lower, seam, p["w0"])), 1)
        return torch.where(lower.reshape(s.shape + (1,) * (lo.dim() - s.dim())), lo, hi)
    return half_fn(p, 0)


def _or_axpy(a_all, sl_a, sl_d, p):
    """The coefficient slice with the radiation secant: a + (Or/OR_REF) a_d."""
    a = a_all[:, sl_a]
    orr = p.get("Or")
    if orr is not None:
        a = a + _col(orr / OR_REF) * a_all[:, sl_d]
    return a


class CurveValues:
    """Emulated ``values(p) -> [W, K]`` curve values riding the bundle's
    shared contraction; built by :func:`make_curve_values`.
    ``form(half_index)`` gives the half's window (the fused kernel's
    packer reads it)."""

    def __init__(self, bundle, handle):
        self.bundle = bundle
        self.handle = handle
        self._forms = {}

    def form(self, half_index):
        """``sl_a``, ``sl_d``, ``scale`` and ``b_scaled`` = scale * B_t
        [R_t, K] (f64 numpy) of the half."""
        self.bundle.finalized()
        if self._forms.get("gen") != self.handle.gen:
            self._forms = {"gen": self.handle.gen}
        if half_index not in self._forms:
            slots, b_t, scale = self.handle.per_half[half_index]
            sl_a, sl_d, _ = slots[0]
            self._forms[half_index] = dict(sl_a=sl_a, sl_d=sl_d, scale=scale,
                                           b_scaled=scale * b_t)
        return self._forms[half_index]

    def half_values(self, p, half_index):
        form = self.form(half_index)
        key = ("t", half_index)
        if key not in self._forms:
            b = self.bundle
            self._forms[key] = torch.as_tensor(form["b_scaled"], device=b.device).to(b.dtype)
        a = _or_axpy(self.bundle.coeff(p, half_index), form["sl_a"], form["sl_d"], p)
        return a @ self._forms[key]

    def __call__(self, p):
        return _dispatch_halves(self.bundle, p, self.half_values)


def make_curve_values(model, curve_fn, tag, key_extra, device, dtype=torch.float32,
                      n_nodes=None) -> CurveValues:
    """Emulated ``fn(p) -> [W, K]`` curve values riding the bundle's single
    shared contraction.

    For a term whose metric depends on the parameters (the quasars'
    diagonal sigma_i^2 + s^2, reference quasars/qsr_desi.py:68-80) chi^2
    is no fixed quadratic form, but its geometry curve is a smooth
    function of the family's parameters: registered in the bundle, its K
    values come back per walker from one [R_t, K] lift, and the caller
    applies the metric. Radiation enters as the Or-secant axpy."""
    bundle = _get_bundle(model, n_nodes, device, dtype)
    handle = bundle.register((curve_fn,), tag, key_extra)
    if not _SCOPES.get():
        bundle.finalized()
    return CurveValues(bundle, handle)


class AmpPairChi2:
    """Emulated ``chi2(p) -> [W]`` = |y_u(theta) - p[amp] y_v(theta)|^2;
    built by :func:`make_amp_pair_chi2`. ``form(half_index)`` gives the
    half's four slices and the group's scale (the packer reads them)."""

    def __init__(self, bundle, handle, amp_param):
        self.bundle = bundle
        self.handle = handle
        self.amp_param = amp_param

    def form(self, half_index):
        self.bundle.finalized()
        slots, _, scale = self.handle.per_half[half_index]
        (sl_au, sl_du, _), (sl_av, sl_dv, _) = slots
        return dict(sl_au=sl_au, sl_du=sl_du, sl_av=sl_av, sl_dv=sl_dv, scale=scale)

    def half_chi2(self, p, half_index):
        a_all = self.bundle.coeff(p, half_index)
        f = self.form(half_index)
        a_u = _or_axpy(a_all, f["sl_au"], f["sl_du"], p)
        a_v = _or_axpy(a_all, f["sl_av"], f["sl_dv"], p)
        r = f["scale"] * (a_u - _col(p[self.amp_param]) * a_v)
        return (r * r).sum(-1)

    def __call__(self, p):
        return _dispatch_halves(self.bundle, p, self.half_chi2)


def make_amp_pair_chi2(model, curve_u_fn, curve_v_fn, tag, key_extra, amp_param: str,
                       device, dtype=torch.float32, n_nodes=None) -> AmpPairChi2:
    """Emulated ``fn(p) -> |y_u(theta) - p[amp_param] * y_v(theta)|^2``.

    The fs8 residual shape (reference fs8/fs8.py:72-85): a whitened
    data-side curve y_u minus an amplitude-scaled whitened theory curve
    y_v, both functions of the geometry only. The two curves register as
    one group, so the joint SVD gives them one orthonormal basis, and the
    rank-space residual r = scale ((a_u + t a_du) - amp (a_v + t a_dv)) is
    formed before squaring: |r|^2 is |y_u - amp y_v|^2 within the group's
    truncation contract, without the f32 cancellation of expanding the
    square (each expanded term is ~30x chi^2 at the fs8 posterior bulk)."""
    bundle = _get_bundle(model, n_nodes, device, dtype)
    handle = bundle.register((curve_u_fn, curve_v_fn), tag, key_extra)
    if not _SCOPES.get():
        bundle.finalized()
    return AmpPairChi2(bundle, handle, amp_param)
