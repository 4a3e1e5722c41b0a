"""Composable likelihood terms (counterpart of
``cosmax/likelihoods/base.py``).

Walker batching is explicit: a ``Term.chi2`` takes a dict of [W]
tensors and returns [W]; ``make_log_prob`` maps theta [W, D] to [W].

Parameter flow::

    theta [W, D] --ParamSpec.unpack--> {name: [W]} --derive--> dict
                 --> sum_i (-0.5 * chi2_i(p) + log_norm_i(p))
"""

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

# Walker-chunk budget for one temporary of ``log_prob``. XLA fuses the
# parity path's elementwise chains; eager PyTorch materialises each
# intermediate. The BAO trapezoid grid alone is [W, 13, 582]: about
# 2 GB per f32 temporary at W = 65,536. ``make_log_prob`` therefore
# evaluates each term over walker chunks sized so that its largest
# per-walker temporary (``Term.elems_per_walker``) stays within this:
# the BAO grid in ~8.9k-walker chunks, the SN grid in ~36k, the CMB
# quadrature in one piece (fewer, larger launches where memory allows).
TEMP_BYTES = 256 << 20


@dataclass(frozen=True)
class ParamSpec:
    """Ordered, bounded sampled parameters."""

    names: tuple
    bounds: np.ndarray  # [D, 2] float64
    labels: tuple = None

    def __post_init__(self):
        b = np.asarray(self.bounds, dtype=np.float64).reshape(len(self.names), 2)
        object.__setattr__(self, "bounds", b)
        if self.labels is None:
            object.__setattr__(self, "labels", tuple(self.names))

    @property
    def dim(self) -> int:
        return len(self.names)

    def unpack(self, theta: torch.Tensor) -> dict:
        return {name: theta[..., i] for i, name in enumerate(self.names)}

    def in_bounds(self, theta: torch.Tensor) -> torch.Tensor:
        """Strict interior check ``(lo < p) & (p < hi)``, with the f64
        bounds cast to theta's dtype first (as the reference does)."""
        lo = torch.as_tensor(self.bounds[:, 0], device=theta.device).to(theta.dtype)
        hi = torch.as_tensor(self.bounds[:, 1], device=theta.device).to(theta.dtype)
        return torch.all((lo < theta) & (theta < hi), dim=-1)


@dataclass(frozen=True)
class Term:
    """One probe's contribution: log L = -0.5 * chi2 + log_norm.

    ``elems_per_walker`` is the element count of the term's largest
    per-walker temporary; ``make_log_prob`` sizes its walker chunks by it.
    """

    name: str
    chi2: Callable[[dict], torch.Tensor]
    log_norm: Optional[Callable[[dict], torch.Tensor]] = None
    elems_per_walker: int = 1
    meta: dict = field(default_factory=dict, repr=False)

    def log_like(self, p: dict):
        ll = -0.5 * self.chi2(p)
        if self.log_norm is not None:
            ll = ll + self.log_norm(p)
        return ll


def _identity_derive(p: dict) -> dict:
    return p


def grid_like(p: dict, z) -> torch.Tensor:
    """The redshifts ``z`` as a tensor on the device and in the dtype of
    the walker parameters ``p`` (a theory hook's evaluation grid)."""
    ref = next(v for v in p.values() if isinstance(v, torch.Tensor))
    return torch.as_tensor(np.asarray(z, dtype=np.float64), device=ref.device).to(ref.dtype)


def walker_chunk(term: Term, dtype: torch.dtype) -> int:
    """Walkers per chunk so that no temporary of ``term`` exceeds
    ``TEMP_BYTES``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(1, TEMP_BYTES // (itemsize * max(term.elems_per_walker, 1)))


def chunked_log_like(term: Term, p: dict, n_walkers: int, dtype: torch.dtype):
    """``term.log_like(p)`` over walker chunks of ``walker_chunk`` rows;
    every walker's value comes from its own row only."""
    chunk = walker_chunk(term, dtype)
    if n_walkers <= chunk:
        return term.log_like(p)
    parts = []
    for s in range(0, n_walkers, chunk):
        rows = {
            k: v[s : s + chunk] if isinstance(v, torch.Tensor) and v.dim() > 0 else v
            for k, v in p.items()
        }
        parts.append(term.log_like(rows))
    return torch.cat(parts)


def make_log_prob(
    spec: ParamSpec,
    terms: Sequence[Term],
    derive: Callable[[dict], dict] = _identity_derive,
):
    """``log_prob(theta[W, D]) -> [W]``.

    Out-of-box walkers are evaluated like any other (no early exit) and
    masked to -inf, with a NaN guard so that poisoned evaluations (E^2 < 0
    gives NaN rows) also map to -inf; with ``utils.debugging``'s NaN
    checks on, a non-finite term on a walker inside the box raises and
    names the term instead. Each term runs over walker chunks (see
    ``TEMP_BYTES``); every walker's value is computed from its own row
    only, so chunking does not change it.
    """
    from cosmax_torch.utils.debugging import nan_checks_enabled, raise_on_bad_rows

    def log_prob(theta: torch.Tensor) -> torch.Tensor:
        if theta.dim() != 2 or theta.shape[1] != spec.dim:
            raise ValueError(f"theta must be [W, {spec.dim}]; got {tuple(theta.shape)}")
        n = theta.shape[0]
        p = derive(spec.unpack(theta))
        inside = spec.in_bounds(theta)
        checks = nan_checks_enabled()
        ll = torch.zeros(n, dtype=theta.dtype, device=theta.device)
        for t in terms:
            term_ll = chunked_log_like(t, p, n, theta.dtype)
            if checks:
                raise_on_bad_rows(term_ll, inside, f"the log-likelihood of term {t.name!r}")
            ll = ll + term_ll
        ok = inside & torch.isfinite(ll)
        return torch.where(ok, ll, torch.full_like(ll, -torch.inf))

    return log_prob


def autograd_value_and_grad(log_prob: Callable, chunk: int = None):
    """``value_and_grad(theta [W, D]) -> (logp [W], d logp / d theta [W, D])``
    of a batched ``log_prob`` by torch.autograd, forward and backward
    over walker chunks of ``chunk`` rows (default: all at once). Autograd
    keeps a chunk's temporaries alive until its backward, so the chunk
    bounds the memory. Rows whose log-prob is masked to -inf get what
    autograd gives them (0, or NaN where 0 meets an infinite partial);
    the samplers zero gradient entries that are not finite."""

    def value_and_grad(theta: torch.Tensor):
        n = theta.shape[0]
        step = n if chunk is None else max(1, chunk)
        vals, grads = [], []
        for s in range(0, max(n, 1), step):
            th = theta[s : s + step].detach().requires_grad_(True)
            with torch.enable_grad():
                lp = log_prob(th)
                if lp.requires_grad:
                    (g,) = torch.autograd.grad(lp.sum(), th)
                else:  # a log-prob constant in theta
                    g = torch.zeros_like(th)
            vals.append(lp.detach())
            grads.append(g)
        if len(vals) == 1:
            return vals[0], grads[0]
        return torch.cat(vals), torch.cat(grads)

    return value_and_grad


def make_chi2_breakdown(
    spec: ParamSpec,
    terms: Sequence[Term],
    derive: Callable[[dict], dict] = _identity_derive,
):
    """Per-term chi^2 for a walker batch: theta [W, D] -> {name: [W]}."""

    def breakdown(theta: torch.Tensor) -> dict:
        p = derive(spec.unpack(theta))
        return {t.name: t.chi2(p) for t in terms}

    return breakdown
