"""Bayesian evidence by stepping-stone integration (counterpart of
``cosmax/samplers/evidence.py``).

    Z = ∫ L(θ) π(θ) dθ,   π uniform over the preset's bounds box,

by stepping-stone sampling (Xie et al. 2011): a ladder of power
posteriors p_β ∝ L^β π at 0 = β_0 < ... < β_K = 1, with

    ln Z = Σ_k ln E_{β_{k-1}}[ exp((β_k - β_{k-1}) ln L) ]

estimated from tempered HMC samples. The whole ladder is one lockstep
batch: positions are a single ``[K, C, D]`` tensor, flattened to
``[K C, D]`` for one batched ``value_and_grad`` call a leapfrog (on the
fast path the values from the fused kernel, the gradients from autograd
through the per-term path), and per-rung dual-averaging step sizes and
diagonal mass matrices adapt as [K]-shaped states. ``n_replicates`` R
independent ladders stack along the rung axis ([K R, C, D]); the
reported error is their cross-replicate scatter. β_k = (k/K)^gamma with
gamma = 3 concentrates rungs near β = 0. A per-rung dense mass was
measured worse in the reference and is not offered.

Random numbers: each step's draws come from ``torch.Generator``s seeded
by ``ensemble._step_seeds(seed, step)``, as in ``samplers.hmc``.

On a device mesh (``mesh=``, ``cosmax_torch.parallel``) the [K, C, D]
ladder is split with its rungs over the walker axes and its chains over
'd'. Rungs adapt independently; the per-rung acceptance mean and moments
are taken over the chains gathered over 'd', and each rank draws the
whole ladder's random numbers for a step and keeps its own block, so a
sharded ladder equals the unsharded one bit for bit. The estimate is
formed from the gathered ln L draws.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from cosmax_torch.device import resolve
from cosmax_torch.samplers.ensemble import _step_seeds
from cosmax_torch.samplers.hmc import BoxTransform, _finite, _salted

_SALT_PRIOR = 0x55E0


class _LadderState(NamedTuple):
    y: torch.Tensor  # [K, C, D]
    log_like: torch.Tensor  # [K, C]  ln L (no beta, no Jacobian)
    log_jac: torch.Tensor  # [K, C]
    grad_like: torch.Tensor  # [K, C, D]  d ln L / dy
    grad_jac: torch.Tensor  # [K, C, D]
    seed: int
    step: int


class SteppingStoneResult(NamedTuple):
    log_evidence: float
    # with n_replicates > 1: std of the independent replicate estimates
    # / sqrt(R); with n_replicates = 1: the chain-group MC error, which
    # underestimates shared equilibration bias (prefer replicates)
    error: float
    betas: np.ndarray
    per_rung: np.ndarray  # [K] ln r_k contributions (replicate mean)
    acceptance: float
    per_replicate: np.ndarray = None  # [R] independent ln Z estimates
    # [K] split R-hat of ln L per rung (worst replicate)
    rung_rhat: np.ndarray = None
    # run(until_stable=...): did the replicate-mean ln Z move < threshold
    # on the last doubling? None = static budget
    converged: bool = None
    history: tuple = None  # [(n_warmup, n_samples, ln Z, error), ...]
    n_warmup: int = None
    n_samples: int = None


_DA_GAMMA, _DA_T0, _DA_KAPPA = 0.05, 10.0, 0.75


class SteppingStone:
    """``SteppingStone(value_and_grad, bounds)`` — tempered-ladder HMC.

    ``value_and_grad(theta [W, D]) -> (ln L [W], d ln L / d theta [W, D])``
    is the bounded log-likelihood's batched value and gradient
    (``FitSpec.value_and_grad()``: ln L inside the box, -inf outside; the
    uniform prior enters through the box volume, which cancels in the
    telescope, so the result is the evidence under the normalised uniform
    prior).
    """

    def __init__(
        self,
        value_and_grad: Callable,
        bounds,
        n_rungs: int = 24,
        n_chains: int = 64,
        max_leapfrog: int = 16,
        target_accept: float = 0.8,
        schedule_gamma: float = 3.0,
        dtype=None,
        device="cuda",
        mesh=None,
    ):
        self.mesh = mesh
        if mesh is not None:
            from cosmax_torch.parallel.mesh import mesh_device

            device = mesh_device(mesh)
        self.device, self.dtype = resolve(device, dtype)
        self.n_rungs = int(n_rungs)
        self.n_chains = int(n_chains)
        self.ndim = int(np.asarray(bounds).shape[0])
        self.max_leapfrog = int(max_leapfrog)
        self.target_accept = float(target_accept)
        self.transform = BoxTransform.from_bounds(bounds, self.dtype, self.device)
        ks = np.arange(self.n_rungs + 1) / self.n_rungs
        self.betas = torch.as_tensor(ks**schedule_gamma, device=self.device).to(self.dtype)
        self._vg_x = value_and_grad
        self._host_gen = torch.Generator()
        self._dev_gen = torch.Generator(device=self.device)
        self._block = None  # this rank's (rungs, chains) slices of the ladder

    def _set_block(self, n_rungs: int):
        """This rank's rungs (of ``n_rungs``) and chains on a mesh."""
        if self.mesh is None:
            self._block = None
            return
        from cosmax_torch.parallel.mesh import _bounds, data_rank, walker_rank

        ((k0, k1),) = _bounds(n_rungs, *walker_rank(self.mesh))
        ((c0, c1),) = _bounds(self.n_chains, *data_rank(self.mesh))
        self._block = (slice(k0, k1), slice(c0, c1))

    def _local(self, x):
        """This rank's block of a [K, C, ...] (or [K]) tensor of the ladder."""
        if self._block is None:
            return x
        return x[self._block[0]] if x.dim() == 1 else x[self._block]

    def _chains(self, x):
        """[K_local, C, ...] from this rank's [K_local, C_local, ...]: the
        chains gathered over 'd'."""
        if self.mesh is None:
            return x
        from cosmax_torch.parallel.mesh import gather_data

        return gather_data(self.mesh, x, dim=1)

    def _ladder(self, x):
        """[K, C, ...] of the whole ladder on every rank."""
        if self.mesh is None:
            return x
        from cosmax_torch.parallel.mesh import gather_all

        return gather_all(self.mesh, x)

    def _eval(self, y):
        """(ln L, d ln L/dy, log_jac, d log_jac/dy) at y [K, C, D], one
        batched call over the flattened [K C, D]."""
        tr = self.transform
        k, c, d = y.shape
        flat = y.reshape(k * c, d)
        ll, gx = self._vg_x(tr.to_x(flat))
        gl = gx * tr.dx_dy(flat)
        return (ll.reshape(k, c), gl.reshape(k, c, d), tr.log_jac(y), tr.grad_log_jac(y))

    def _draw_length(self, host_gen) -> int:
        return int(torch.randint(1, self.max_leapfrog + 1, (), generator=host_gen))

    def _step(self, st: _LadderState, betas, eps, inv_mass):
        """betas [K], eps [K], inv_mass [K, D]; one jittered-HMC update of
        every rung's chains."""
        host_seed, dev_seed = _step_seeds(st.seed, st.step)
        self._host_gen.manual_seed(host_seed)
        self._dev_gen.manual_seed(dev_seed)
        n_leap = self._draw_length(self._host_gen)
        k, c, d = st.y.shape
        if self._block is not None:  # the whole ladder's draws
            k, c = self._n_ladder_rungs, self.n_chains
        kw = dict(dtype=self.dtype, device=self.device)
        b = betas[:, None]  # [K, 1]
        e = eps[:, None, None]  # [K, 1, 1]
        im = inv_mass[:, None, :]  # [K, 1, D]
        z = self._local(torch.randn((k, c, d), generator=self._dev_gen, **kw))
        u = self._local(torch.rand((k, c), generator=self._dev_gen, **kw))
        p0 = z / torch.sqrt(im)

        def grad_post(gl, gj):
            return _finite(b[..., None] * gl + gj)

        # (ll, lj) ride along: the loop's final evaluation is the
        # acceptance test's
        y, p = st.y, p0
        ll, gl, lj, gj = st.log_like, st.grad_like, st.log_jac, st.grad_jac
        for _ in range(n_leap):
            p = p + 0.5 * e * grad_post(gl, gj)
            y = y + e * im * p
            ll, gl, lj, gj = self._eval(y)
            p = p + 0.5 * e * grad_post(gl, gj)

        kin0 = 0.5 * torch.sum(im * p0**2, dim=-1)
        kin1 = 0.5 * torch.sum(im * p**2, dim=-1)
        logp0 = b * st.log_like + st.log_jac
        logp1 = b * ll + lj
        log_ratio = (logp1 - kin1) - (logp0 - kin0)
        log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio,
                                torch.full_like(log_ratio, -torch.inf))
        accept = torch.log(u) < log_ratio
        sel = accept[..., None]
        new = _LadderState(
            y=torch.where(sel, y, st.y),
            log_like=torch.where(accept, ll, st.log_like),
            log_jac=torch.where(accept, lj, st.log_jac),
            grad_like=torch.where(sel, gl, st.grad_like),
            grad_jac=torch.where(sel, gj, st.grad_jac),
            seed=st.seed,
            step=st.step + 1,
        )
        return new, accept, torch.clamp(torch.exp(log_ratio), max=1.0)

    def _run(self, st: _LadderState, betas, n_warmup: int, n_samples: int):
        """Adapt and record from ``st`` (this rank's block) at ``betas``
        [K], every rung's; returns (state, ln L draws [S, K, C], accepted
        [S, K, C]), the draws of the whole ladder (``ladder`` sets this
        rank's block)."""
        betas = self._local(betas)
        kk, d = betas.shape[0], self.ndim
        kw = dict(dtype=self.dtype, device=self.device)
        # vectorized per-rung dual averaging + Welford
        log_eps = torch.full((kk,), float(np.log(0.1)), **kw)
        a = dict(
            log_eps=log_eps,
            log_eps_bar=log_eps.clone(),
            h_bar=torch.zeros((kk,), **kw),
            mu=torch.full((kk,), float(np.log(10.0 * 0.1)), **kw),
            w_mean=torch.zeros((kk, d), **kw),
            w_m2=torch.zeros((kk, d), **kw),
            w_n=torch.zeros((), **kw),
            inv_mass=torch.ones((kk, d), **kw),
        )
        w1 = max(1, int(0.15 * n_warmup))
        w2 = max(w1 + 1, int(0.75 * n_warmup))
        for i in range(n_warmup):
            st, _, accept_prob = self._step(st, betas, torch.exp(a["log_eps"]), a["inv_mass"])
            am = torch.mean(self._chains(accept_prob), dim=1)  # [K]
            t = i + 1.0
            eta_h = 1.0 / (t + _DA_T0)
            h_bar = (1.0 - eta_h) * a["h_bar"] + eta_h * (self.target_accept - am)
            log_eps = a["mu"] - np.sqrt(t) / _DA_GAMMA * h_bar
            eta = t ** (-_DA_KAPPA)
            log_eps_bar = eta * log_eps + (1.0 - eta) * a["log_eps_bar"]
            a = dict(a, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar)
            if w1 <= i < w2:
                y = self._chains(st.y)
                c = y.shape[1]
                n = a["w_n"] + c
                bm = torch.mean(y, dim=1)  # [K, D]
                delta = bm - a["w_mean"]
                a = dict(
                    a,
                    w_mean=a["w_mean"] + delta * (c / n),
                    w_m2=(a["w_m2"] + torch.sum((y - bm[:, None, :]) ** 2, dim=1)
                          + delta**2 * (a["w_n"] * c / n)),
                    w_n=n,
                )
            if i == w2:
                var = a["w_m2"] / torch.clamp(a["w_n"] - 1.0, min=1.0)
                a = dict(
                    a,
                    inv_mass=torch.where(var > 1e-10, var, torch.ones_like(var)),
                    mu=float(np.log(10.0)) + a["log_eps"],
                    h_bar=torch.zeros_like(a["h_bar"]),
                    log_eps_bar=a["log_eps"],
                    w_mean=torch.zeros_like(a["w_mean"]),
                    w_m2=torch.zeros_like(a["w_m2"]),
                    w_n=torch.zeros_like(a["w_n"]),
                )
        eps = torch.exp(a["log_eps_bar"])
        lls, accs = [], []
        for _ in range(n_samples):
            st, accept, _ = self._step(st, betas, eps, a["inv_mass"])
            lls.append(st.log_like)
            accs.append(accept)
        if not lls:
            return st, st.log_like.new_empty((0,) + tuple(self._ladder(st.log_like).shape)), \
                torch.empty((0,), dtype=torch.bool)
        lls, accs = (self._ladder(torch.stack(x).movedim(0, 2)).movedim(2, 0)
                     for x in (lls, accs))
        return st, lls, accs

    def run(self, seed: int, n_warmup: int = 300, n_samples: int = 300,
            n_replicates: int = 1, until_stable: float = None, max_doublings: int = 4):
        """Returns a :class:`SteppingStoneResult`.

        ``n_replicates > 1`` runs R independent ladders (own inits, own
        chains, own per-rung adaptation) stacked along the rung axis of
        the same batch, and reports the cross-replicate scatter of ln Z
        as ``error``. ``until_stable=t`` (nats) doubles (n_warmup,
        n_samples), a fresh run each time, until the replicate-mean ln Z
        moves < t between consecutive budgets (``converged=True``) or
        ``max_doublings`` is exhausted (``converged=False``)."""
        if until_stable is not None:
            return self._run_until_stable(seed, n_warmup, n_samples, n_replicates,
                                          float(until_stable), int(max_doublings))
        return self._run_budget(seed, n_warmup, n_samples, n_replicates)

    def _run_until_stable(self, seed, n_warmup, n_samples, n_replicates, threshold,
                          max_doublings):
        history = []
        prev = None
        converged = False
        for j in range(max_doublings + 1):
            res = self._run_budget(_salted(seed, j), n_warmup, n_samples, n_replicates)
            history.append((n_warmup, n_samples, res.log_evidence, res.error))
            if prev is not None and abs(res.log_evidence - prev) < threshold:
                converged = True
                break
            prev = res.log_evidence
            if j < max_doublings:
                n_warmup *= 2
                n_samples *= 2
        return res._replace(converged=converged, history=tuple(history),
                            n_warmup=n_warmup, n_samples=n_samples)

    def ladder(self, seed: int, n_warmup: int, n_samples: int, n_replicates: int = 1):
        """The tempered ladder's ln L draws: returns (lls [S, R K, C],
        accepted [S, R K, C]) of the whole ladder on every rank, the rungs
        beta_0..beta_{K-1} of each replicate stacked."""
        r = int(n_replicates)
        if r < 1:
            raise ValueError("n_replicates must be >= 1")
        # the estimator needs expectations under beta_0..beta_{K-1} only:
        # the beta_K = 1 rung is not run
        kk = self.n_rungs
        betas_j = self.betas[:-1].repeat(r)  # [R K] stacked ladders
        self._n_ladder_rungs = r * kk
        self._set_block(r * kk)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_salted(seed, _SALT_PRIOR))
        # uniform prior draws for every (replicate, rung): warmup anneals
        # each rung onto its own power posterior
        u = torch.rand((r * kk, self.n_chains, self.ndim), generator=gen, dtype=self.dtype,
                       device=self.device)
        tr = self.transform
        y0 = tr.to_y(tr.lo + (0.02 + 0.96 * self._local(u)) * tr.width)
        ll0, gl0, lj0, gj0 = self._eval(y0)
        if not bool(torch.all(torch.isfinite(self._ladder(ll0)))):
            raise ValueError("initial prior draws hit non-finite likelihood")
        st = _LadderState(y0, ll0, lj0, gl0, gj0, int(seed), 0)
        _, lls, accs = self._run(st, betas_j, n_warmup, n_samples)
        return lls, accs

    def _run_budget(self, seed: int, n_warmup: int, n_samples: int, n_replicates: int):
        r, kk = int(n_replicates), self.n_rungs
        lls, accs = self.ladder(seed, n_warmup, n_samples, r)

        # [S, R*K, C] -> [S, R, K, C]
        lls = lls.cpu().numpy().astype(np.float64)
        lls = lls.reshape(lls.shape[0], r, kk, self.n_chains)
        betas = self.betas.cpu().numpy().astype(np.float64)
        rep_terms = [_ss_estimate_np(np.moveaxis(lls[:, j], 0, 1), betas) for j in range(r)]
        totals = np.array([t.sum() for t in rep_terms])
        if r > 1:
            error = float(np.std(totals, ddof=1) / np.sqrt(r))
        else:
            # MC error from independent chain groups; underestimates
            # shared equilibration bias
            draws = np.moveaxis(lls[:, 0], 0, 1)  # [K, S, C]
            g = max(2, min(8, self.n_chains // 4))
            size = self.n_chains // g
            groups = [
                float(_ss_estimate_np(draws[:, :, j * size:(j + 1) * size], betas).sum())
                for j in range(g)
            ]
            error = float(np.std(groups, ddof=1) / np.sqrt(g))
        rhat = np.array([max(_split_rhat_np(lls[:, j, k, :]) for j in range(r))
                         for k in range(kk)])
        return SteppingStoneResult(
            log_evidence=float(totals.mean()),
            error=error,
            betas=betas,
            per_rung=np.mean(rep_terms, axis=0),
            acceptance=float(accs.to(torch.float64).mean()),
            per_replicate=totals,
            rung_rhat=rhat,
        )


def _split_rhat_np(draws):
    """Split R-hat of scalar draws [S, C] over the 2C half-chains: ~1 when
    every chain's ln L is stationary over the sampling phase."""
    s, c = draws.shape
    half = s // 2
    if half < 2:
        return float("nan")
    x = np.concatenate([draws[:half], draws[half:2 * half]], axis=1)
    w = float(np.mean(np.var(x, axis=0, ddof=1)))
    if w <= 0.0:
        return 1.0  # constant ln L: trivially mixed
    b_over_n = float(np.var(np.mean(x, axis=0), ddof=1))
    var_est = (half - 1.0) / half * w + b_over_n
    return float(np.sqrt(var_est / w))


def _ss_estimate_np(draws, betas):
    """The estimator in f64 on the host: draws [K, S, C] under
    beta_0..beta_{K-1}, betas [K+1] -> [K] per-rung ln r_k."""
    from scipy.special import logsumexp

    dbeta = betas[1:] - betas[:-1]
    ll = draws.reshape(len(dbeta), -1)
    return logsumexp(dbeta[:, None] * ll, axis=1) - np.log(ll.shape[1])


def stepping_stone_log_evidence(value_and_grad, bounds, seed: int = 0, **kwargs):
    """Convenience wrapper returning a :class:`SteppingStoneResult`;
    kwargs split between the :class:`SteppingStone` constructor (n_rungs,
    n_chains, max_leapfrog, schedule_gamma, dtype, device) and ``run``
    (n_warmup, n_samples, n_replicates, until_stable, max_doublings)."""
    run_kw = {
        k: kwargs.pop(k)
        for k in ("n_warmup", "n_samples", "n_replicates", "until_stable", "max_doublings")
        if k in kwargs
    }
    return SteppingStone(value_and_grad, bounds, **kwargs).run(seed, **run_kw)
