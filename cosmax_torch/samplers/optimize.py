"""Deterministic point fits (counterpart of ``cosmax/samplers/optimize.py``).

* ``minimize_chi2`` — damped-Newton / Levenberg-Marquardt on a scalar
  chi^2, the loop on the host in f64 numpy, with the exact gradient and
  Hessian from torch.autograd (parameter spaces here are <= 11-dim, so
  the Hessian is cheap and the quadratic model is exact for the
  Gaussian terms);
* ``adam_minimize`` — ``torch.optim.Adam`` with optax's defaults.

Functions take theta [D] as the JAX ones do; a fit's batched log-prob
sees it as [1, D] (``FitSpec.differentiable_log_prob``: the per-term
path on either path, through the chi^2 kernel's autograd Function on
the card).
"""

import numpy as np
import torch

from cosmax_torch.device import resolve


def _placement(device, dtype):
    """(device, dtype) of a point fit: the card unless the caller asks for
    the CPU (``resolve`` raises where CUDA is absent); dtype float32 on the
    card and, by default, float64 on the CPU."""
    if dtype is None and torch.device(device).type == "cpu":
        dtype = torch.float64
    return resolve(device, dtype)


def adam_minimize(loss_fn, x0, iters: int = 1000, lr: float = 1e-2):
    """``iters`` Adam steps on ``loss_fn(x [D]) -> scalar`` from ``x0``;
    returns (x, losses [iters]), each loss taken before its update."""
    x = torch.as_tensor(x0).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(iters):
        opt.zero_grad()
        loss = loss_fn(x)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return x.detach(), torch.stack(losses).cpu().numpy()


def _derivatives(fn, x: torch.Tensor):
    """(gradient [D], Hessian [D, D]) of the scalar ``fn`` at ``x``, exact
    (double backward, one row of the Hessian per backward)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(fn(x), x, create_graph=True)
        rows = [
            torch.autograd.grad(g[i], x, retain_graph=True, allow_unused=True)[0]
            for i in range(x.shape[0])
        ]
    h = torch.stack([torch.zeros_like(x) if r is None else r for r in rows])
    return g.detach(), h.detach()


def minimize_chi2(
    chi2_fn,
    x0,
    bounds=None,
    iters: int = 100,
    lam0: float = 1e-3,
    tol: float = 1e-10,
    device="cuda",
    dtype=None,
):
    """Levenberg-damped Newton on a scalar chi^2.

    chi2_fn: differentiable ``theta [D] tensor -> scalar tensor``,
    evaluated on ``device`` in ``dtype``; bounds [D, 2] optional
    clipping. Returns (x_best, chi2_best, info). The trust-region
    damping loop runs on the host in f64.
    """
    device, dtype = _placement(device, dtype)

    def at(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)

    def value(x):
        with torch.no_grad():
            return float(chi2_fn(at(x)))

    x = np.asarray(x0, dtype=np.float64)
    lam = lam0
    f = value(x)
    n_evals = 1
    for it in range(iters):
        g, h = (np.asarray(a.cpu(), dtype=np.float64) for a in _derivatives(chi2_fn, at(x)))
        for _ in range(25):
            try:
                step = np.linalg.solve(h + lam * np.diag(np.diag(h) + 1e-12), -g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            x_new = x + step
            if bounds is not None:
                b = np.asarray(bounds, dtype=np.float64)
                x_new = np.clip(x_new, b[:, 0] + 1e-9, b[:, 1] - 1e-9)
            f_new = value(x_new)
            n_evals += 1
            if np.isfinite(f_new) and f_new < f:
                lam = max(lam / 3.0, 1e-12)
                improvement = f - f_new
                x, f = x_new, f_new
                break
            lam *= 10.0
        else:
            break
        if improvement < tol * max(1.0, abs(f)):
            break
    return x, f, dict(iterations=it + 1, chi2_evals=n_evals, lambda_=lam)


def _one(fn):
    """A batched ``[W, D] -> [W]`` function as ``[D] -> scalar``."""
    return lambda theta: fn(theta[None, :])[0]


def _midpoint(fit):
    return 0.5 * (fit.spec.bounds[:, 0] + fit.spec.bounds[:, 1])


def best_fit(fit, x0=None, **kwargs):
    """Point estimate for a FitSpec: LM-Newton on the total chi^2 from
    the bounds midpoint (or x0)."""
    breakdown = fit.chi2_breakdown()

    def total(theta):
        return sum(breakdown(theta[None, :]).values())[0]

    x0 = _midpoint(fit) if x0 is None else x0
    x, f, info = minimize_chi2(total, x0, bounds=fit.spec.bounds, device=fit.device,
                               dtype=fit.dtype, **kwargs)
    return {name: float(v) for name, v in zip(fit.spec.names, x)}, f, info


def map_fit(fit, x0=None, **kwargs):
    """Posterior-mode fit: LM-Newton on -2 log_prob (not the raw chi^2:
    for likelihoods with parameter-dependent normalisations, e.g. the
    f_cc-rescaled CC term whose chi^2/f^2 alone is minimised by pushing
    f to its bound, the mode of the posterior is the only well-defined
    point estimate). Coincides with ``best_fit`` when no log_norm terms
    are present. Returns ({name: value}, -2 logL at the mode, info)."""
    lp = _one(fit.differentiable_log_prob())

    def nll(theta):
        return -2.0 * lp(theta)

    x0 = _midpoint(fit) if x0 is None else x0
    x, f, info = minimize_chi2(nll, x0, bounds=fit.spec.bounds, device=fit.device,
                               dtype=fit.dtype, **kwargs)
    return {name: float(v) for name, v in zip(fit.spec.names, x)}, f, info


def laplace(log_prob_fn, x_map, device="cuda", dtype=None):
    """Gaussian (Laplace/Fisher) approximation around a mode.

    ``log_prob_fn``: differentiable ``theta [D] -> scalar``. covariance =
    inverse Hessian of -log_prob at ``x_map`` (exact double backward, no
    finite differences). Returns ``(cov [D,D], sigma [D], corr [D,D])``.
    ``device`` and ``dtype`` as for ``minimize_chi2``.
    """
    device, dtype = _placement(device, dtype)
    x = torch.as_tensor(np.asarray(x_map, dtype=np.float64), device=device).to(dtype)
    _, h = _derivatives(lambda t: -log_prob_fn(t), x)
    h = np.asarray(h.cpu(), dtype=np.float64)
    if not np.all(np.isfinite(h)):
        raise ValueError("Hessian not finite at x_map (mode on a bound?)")
    cov = np.linalg.inv(h)
    sig = np.sqrt(np.diag(cov))
    corr = cov / np.outer(sig, sig)
    return cov, sig, corr


def fit_laplace(fit, x_map):
    """``laplace`` of a FitSpec's log-posterior at ``x_map``."""
    return laplace(_one(fit.differentiable_log_prob()), x_map, fit.device, fit.dtype)


def laplace_fit(fit, x0=None, **kwargs):
    """MAP + Laplace errors for a FitSpec: posterior-mode LM fit
    (``map_fit``), then the inverse-Hessian covariance of the full
    log-posterior at the mode.

    Returns ``(params {name: (map, sigma)}, chi2_at_map, corr [D,D])``
    where chi2_at_map is the total data chi^2 evaluated at the mode.
    """
    best, _, _ = map_fit(fit, x0=x0, **kwargs)
    x = np.asarray([best[n] for n in fit.spec.names], dtype=np.float64)
    _, sig, corr = fit_laplace(fit, x)
    chi2_at_map = chi2_total(fit, x)
    params = {n: (float(v), float(s)) for n, v, s in zip(fit.spec.names, x, sig)}
    return params, chi2_at_map, corr


def chi2_total(fit, x) -> float:
    """The total data chi^2 of a FitSpec at one point x [D]."""
    theta = torch.as_tensor(np.asarray(x, dtype=np.float64)[None, :], device=fit.device)
    with torch.no_grad():
        return float(sum(fit.chi2_breakdown()(theta.to(fit.dtype)).values())[0])


def map_jitter_init(fit, gen: torch.Generator, n_chains, scale=1.0):
    """Initial chain positions [C, D] (on the fit's device and dtype) at
    the posterior mode with ``scale``-times-Laplace-sigma Gaussian jitter,
    clipped to the bounds interior.

    The robust initializer for gradient-based sampling: the CMB-anchored
    posteriors occupy ~1e-4 of the prior box per dimension, and a
    uniform-in-box init leaves warmup adaptation estimating its mass
    matrix from a diffuse unconverged cloud. The jitter takes the FULL
    covariance: the joint posteriors are thin correlated ellipsoids, and
    axis-aligned marginal-sigma jitter lands the cloud far off the shell.
    The normal draws come from ``gen`` (a CPU generator).
    """
    best, _, _ = map_fit(fit)
    x = np.asarray([best[n] for n in fit.spec.names], dtype=np.float64)
    cov, sig, _ = fit_laplace(fit, x)
    lo = fit.spec.bounds[:, 0]
    hi = fit.spec.bounds[:, 1]
    width = hi - lo
    z = torch.randn((n_chains, fit.spec.dim), generator=gen, dtype=torch.float64).numpy()
    try:
        chol = np.linalg.cholesky(cov + 1e-12 * np.eye(len(x)) * np.trace(cov))
        init = x + scale * z @ chol.T
    except np.linalg.LinAlgError:
        sig = np.minimum(np.where(np.isfinite(sig), sig, 0.05 * width), 0.2 * width)
        init = x + scale * sig * z
    init = np.clip(init, lo + 1e-6 * width, hi - 1e-6 * width)
    return torch.as_tensor(init, device=fit.device).to(fit.dtype)
