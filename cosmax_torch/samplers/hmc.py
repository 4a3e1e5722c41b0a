"""Gradient-based Hamiltonian Monte Carlo on the device (counterpart of
``cosmax/samplers/hmc.py``).

Design, as the reference's:

* **Lockstep chains** — positions are one ``[C, D]`` tensor and the
  potential is a batched ``value_and_grad(theta [C, D]) -> (logp [C],
  grad [C, D])`` (``FitSpec.value_and_grad``: on the fast path the values
  from the fused kernel, the gradient from autograd through the per-term
  fast path). The step loop is Python; a leapfrog makes no host sync.
* **Unconstrained reparameterisation** — the uniform box prior becomes a
  per-dimension logit transform with its exact log-Jacobian, so
  trajectories never hit the -inf boundary wall.
* **Per-chain step size, pooled mass** — dual averaging (target accept
  0.8) runs per chain on each chain's own accept statistic, and a pooled
  Welford estimate of the posterior covariance (dense by default) sets
  the mass matrix over Stan-style expanding windows; the pool trims the
  lowest quartile and anything far below the best chain; trajectories
  with |dH| beyond a cap of 50 are rejected outright (a symmetric factor,
  so detailed balance holds); escapee chains are rejuvenated from the
  healthy bulk at every mass boundary; and a large end-of-warmup
  rejuvenation fraction triggers a warmup retry with a fresh seed.
* **Jittered trajectories** — each step draws one shared trajectory
  length uniformly in ``[1, max_leapfrog]``, independent of the state.

Random numbers: every step's draws come from ``torch.Generator``s seeded
by ``ensemble._step_seeds(seed, step)`` (the host one draws the
trajectory length, the device one the momenta and the accept uniforms),
so the sampler is a pure function of its state and a resumed run
continues the straight run's stream bit for bit. The rejuvenation's
donor draws come from the same function of a salted seed. Torch's Philox
is not JAX's threefry: the parity with the reference is statistical.

On a device mesh (``mesh=``, ``cosmax_torch.parallel``) the chains are
split over the walker axes: each rank holds its block of the state and
draws the whole batch's random numbers for a step, keeping its own rows.
The recording phase makes no cross-chain reduction. Warmup pools its
statistics over all chains (the pooled mass estimate with its quartile
cut, the rejuvenation's quartiles, best chain and donors) from the
gathered population, the same on every rank, and a stuck chain takes its
donor's state from whichever rank holds it. So a sharded run equals the
unsharded one bit for bit, warmup included, wherever the potential and
PyTorch's kernels compute a chain's values from its own row alone (see
``samplers.ensemble``: 32 chains a rank on the CPU); recorded chains are
gathered.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from cosmax_torch.device import resolve
from cosmax_torch.samplers.ensemble import _step_seeds

# salts of the seeds of the draws that are not a step's own
_SALT_INIT, _SALT_REJUV, _SALT_RETRY = 0x1D17, 0x2E70, 0x3E72


def _salted(seed: int, salt: int) -> int:
    """A 64-bit seed for the stream ``salt`` of run ``seed``."""
    return int(np.random.SeedSequence([int(seed), salt]).generate_state(1, np.uint64)[0])


def retry_seed(seed: int, retries: int) -> int:
    """The seed of warmup retry ``retries`` of a run seeded with ``seed``."""
    return seed if retries == 0 else _salted(_salted(seed, _SALT_RETRY), retries)


class HMCChain(NamedTuple):
    """Recorded HMC chain: ``Chain``'s [T, C, D] layout plus the
    per-chain divergence record."""

    samples: torch.Tensor  # [T, C, D] constrained-space draws
    log_probs: torch.Tensor  # [T, C]
    accepted: torch.Tensor  # [T, C] bool
    divergent: torch.Tensor  # [T, C] bool: |dH| > cap on that trajectory

    @property
    def acceptance_fraction(self) -> float:
        return float(self.accepted.to(torch.float64).mean())

    def flat(self, discard: int = 0, thin: int = 1):
        s = self.samples[discard::thin]
        return s.reshape(-1, s.shape[-1])

    @property
    def divergences_per_chain(self):
        """[C] total divergent trajectories per chain."""
        return self.divergent.to(torch.int64).sum(0)

    @property
    def n_divergent(self) -> int:
        """Total divergent (chain, step) trajectories."""
        return int(self.divergent.to(torch.int64).sum())


# -- box <-> unconstrained transform ------------------------------------


class BoxTransform(NamedTuple):
    """Logit reparameterisation of a [D, 2] bounds box."""

    lo: torch.Tensor
    width: torch.Tensor

    @classmethod
    def from_bounds(cls, bounds, dtype=None, device="cuda"):
        """On the card unless ``device`` says otherwise (``resolve``)."""
        device, dtype = resolve(device, dtype)
        b = np.asarray(bounds, dtype=np.float64)
        return cls(
            torch.as_tensor(b[:, 0], device=device).to(dtype),
            torch.as_tensor(b[:, 1] - b[:, 0], device=device).to(dtype),
        )

    def to_x(self, y):
        return self.lo + self.width * torch.sigmoid(y)

    def to_y(self, x):
        s = torch.clip((x - self.lo) / self.width, 1e-7, 1.0 - 1e-7)
        return torch.log(s) - torch.log1p(-s)

    def log_jac(self, y):
        # d x / d y = width * sigmoid(y) * sigmoid(-y)
        f = torch.nn.functional.logsigmoid
        return torch.sum(torch.log(self.width) + f(y) + f(-y), dim=-1)

    def grad_log_jac(self, y):
        """d log_jac / dy = sigmoid(-y) - sigmoid(y)."""
        return torch.sigmoid(-y) - torch.sigmoid(y)

    def dx_dy(self, y):
        return self.width * torch.sigmoid(y) * torch.sigmoid(-y)


# -- states --------------------------------------------------------------


class HMCState(NamedTuple):
    y: torch.Tensor  # [C, D] unconstrained positions
    logp: torch.Tensor  # [C] log posterior + log-Jacobian at y
    grad: torch.Tensor  # [C, D] its gradient
    seed: int  # keys the random stream together with step
    step: int


class AdaptState(NamedTuple):
    log_eps: torch.Tensor  # [C]
    log_eps_bar: torch.Tensor  # [C]
    h_bar: torch.Tensor  # [C]
    mu: torch.Tensor  # [C]
    t: torch.Tensor  # []
    # pooled Welford moments over (chains x steps), per dimension
    w_mean: torch.Tensor
    w_m2: torch.Tensor
    w_n: torch.Tensor
    inv_mass: torch.Tensor  # [D] or [D, D] ~ posterior covariance in y-space


_DA_GAMMA, _DA_T0, _DA_KAPPA = 0.05, 10.0, 0.75
# the AdaptState fields held per chain (the rest are pooled)
_PER_CHAIN = ("log_eps", "log_eps_bar", "h_bar", "mu")


def _da_update(a: AdaptState, accept_stat, target):
    """Nesterov dual averaging toward the target accept statistic,
    elementwise over the per-chain eps state: one chain thrown out by a
    mass reset crushes only its own eps (and recovers)."""
    t = a.t + 1.0
    eta_h = 1.0 / (t + _DA_T0)
    h_bar = (1.0 - eta_h) * a.h_bar + eta_h * (target - accept_stat)
    log_eps = a.mu - torch.sqrt(t) / _DA_GAMMA * h_bar
    eta = t ** (-_DA_KAPPA)
    log_eps_bar = eta * log_eps + (1.0 - eta) * a.log_eps_bar
    return a._replace(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t=t)


def _welford_update(a: AdaptState, y, dense: bool, logp=None):
    """Batch update of the pooled moments with all chains at once; m2 is
    [D] (variances) or [D, D] (scatter matrix). With ``logp`` the lowest
    quartile and chains more than 10 + 5 D below the best are left out:
    stragglers still far from the mode inflate the pooled covariance."""
    if logp is None:
        w = torch.ones(y.shape[:1], dtype=y.dtype, device=y.device)
    else:
        cut = torch.quantile(logp, 0.25)
        gap = 10.0 + 5.0 * y.shape[1]
        w = ((logp >= cut) & (logp >= torch.max(logp) - gap)).to(y.dtype)
    c = torch.clamp(torch.sum(w), min=1.0)
    n = a.w_n + c
    batch_mean = torch.sum(w[:, None] * y, dim=0) / c
    delta = batch_mean - a.w_mean
    mean = a.w_mean + delta * (c / n)
    r = (y - batch_mean) * w[:, None]
    if dense:
        batch_m2 = r.T @ r
        cross = torch.outer(delta, delta)
    else:
        batch_m2 = torch.sum(r**2, dim=0)
        cross = delta**2
    m2 = a.w_m2 + batch_m2 + cross * (a.w_n * c / n)
    return a._replace(w_mean=mean, w_m2=m2, w_n=n)


def _finite(g):
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


class HMCSampler:
    """``HMCSampler(value_and_grad, bounds, n_chains)`` — adaptive HMC.

    ``value_and_grad(theta [C, D]) -> (logp [C], d logp / d theta [C, D])``
    is the batched potential (``FitSpec.value_and_grad()``); ``bounds`` is
    the ``ParamSpec.bounds`` [D, 2] box it was built for. Chains live on
    ``device`` in ``dtype``.

    ``run(seed, n_samples, n_warmup=500, initial=None)`` returns
    ``(state, HMCChain)`` with samples in the *constrained* space.
    """

    def __init__(
        self,
        value_and_grad: Callable,
        bounds,
        n_chains: int,
        max_leapfrog: int = 32,
        target_accept: float = 0.8,
        dense_mass: bool = True,
        dtype=None,
        device="cuda",
        mesh=None,
    ):
        self.mesh = mesh
        self.n_chains = int(n_chains)
        if mesh is not None:
            from cosmax_torch.parallel.mesh import local_rows, mesh_device

            device = mesh_device(mesh)
            (self._rows,) = local_rows(mesh, self.n_chains)
        self.device, self.dtype = resolve(device, dtype)
        self.dense_mass = bool(dense_mass)
        self.ndim = int(np.asarray(bounds).shape[0])
        self.max_leapfrog = int(max_leapfrog)
        self.target_accept = float(target_accept)
        # reject (don't just count) trajectories with |dH| beyond this
        self.max_energy_error = 50.0
        self.transform = BoxTransform.from_bounds(bounds, self.dtype, self.device)
        self._vg_x = value_and_grad
        self._host_gen = torch.Generator()
        self._dev_gen = torch.Generator(device=self.device)
        # batched value_and_grad calls made (a run's gradient evaluations)
        self.n_grad_evals = 0

    def _value_and_grad(self, y):
        """(log posterior + log-Jacobian, its y-gradient) at y [C, D]."""
        self.n_grad_evals += 1
        tr = self.transform
        logp, gx = self._vg_x(tr.to_x(y))
        return logp + tr.log_jac(y), _finite(gx * tr.dx_dy(y) + tr.grad_log_jac(y))

    # -- the chains of this rank (all of them without a mesh) -------------
    def _local(self, x):
        """This rank's rows of a per-chain [C, ...] tensor; a scalar as it is."""
        if self.mesh is None or x.dim() == 0:
            return x
        return x[self._rows[0]:self._rows[1]]

    def _all(self, *xs):
        """Every chain's rows of per-chain tensors (one dtype), gathered
        along dim 0 in one collective; one tensor for one argument."""
        if self.mesh is not None:
            from cosmax_torch.parallel.mesh import gather_walkers

            c = xs[0].shape[0]
            flat = gather_walkers(self.mesh, torch.cat([x.reshape(c, -1) for x in xs], dim=1))
            sizes = [x[0].numel() if x.dim() > 1 else 1 for x in xs]
            xs = tuple(part.reshape((-1,) + tuple(x.shape[1:]))
                       for part, x in zip(torch.split(flat, sizes, dim=1), xs))
        return xs[0] if len(xs) == 1 else xs

    def shard_state(self, state: HMCState) -> HMCState:
        """This rank's state from the global one (itself without a mesh)."""
        return state._replace(y=self._local(state.y), logp=self._local(state.logp),
                              grad=self._local(state.grad))

    def gather_state(self, state: HMCState) -> HMCState:
        """The global state on every rank (itself without a mesh)."""
        y, logp, grad = self._all(state.y, state.logp, state.grad)
        return state._replace(y=y, logp=logp, grad=grad)

    def shard_adapt(self, adapt: AdaptState) -> AdaptState:
        return adapt._replace(**{k: self._local(getattr(adapt, k)) for k in _PER_CHAIN})

    def gather_adapt(self, adapt: AdaptState) -> AdaptState:
        return adapt._replace(**{k: self._all(getattr(adapt, k)) for k in _PER_CHAIN})

    def _gens(self, seed: int, step: int):
        host_seed, dev_seed = _step_seeds(seed, step)
        self._host_gen.manual_seed(host_seed)
        self._dev_gen.manual_seed(dev_seed)
        return self._host_gen, self._dev_gen

    # -- mass-matrix mode helpers ---------------------------------------
    # inv_mass is the estimated posterior covariance in y-space: [D]
    # marginal variances (diag mode) or the full [D, D] matrix (dense).
    def _mass_eye(self):
        d = self.ndim
        kw = dict(dtype=self.dtype, device=self.device)
        return torch.eye(d, **kw) if self.dense_mass else torch.ones((d,), **kw)

    def _momentum(self, z, inv_mass):
        """p ~ N(0, M) with M = inv_mass^{-1}."""
        if not self.dense_mass:
            return z / torch.sqrt(inv_mass)
        chol = torch.linalg.cholesky(inv_mass)
        # Sigma = L L^T  =>  p = L^{-T} z
        return torch.linalg.solve_triangular(chol.T, z.T, upper=True).T

    def _velocity(self, p, inv_mass):
        """dy/dt = M^{-1} p = Sigma p."""
        if not self.dense_mass:
            return inv_mass * p
        return p @ inv_mass  # symmetric

    def _kinetic(self, p, inv_mass):
        if not self.dense_mass:
            return 0.5 * torch.sum(inv_mass * p**2, dim=-1)
        return 0.5 * torch.sum(p * (p @ inv_mass), dim=-1)

    def _draw_length(self, host_gen) -> int:
        return int(torch.randint(1, self.max_leapfrog + 1, (), generator=host_gen))

    # -- one MH-corrected trajectory ------------------------------------
    def _step(self, state: HMCState, eps, inv_mass, z=None, u=None, n_leap=None):
        """One trajectory: returns (state, accept [C], accept_prob [C],
        divergent [C]). ``z`` (momentum normals), ``u`` (accept
        uniforms) and ``n_leap`` override the step's own draws."""
        host, dev = self._gens(state.seed, state.step)
        c, d = self.n_chains, self.ndim
        kw = dict(dtype=self.dtype, device=self.device)
        # eps is a scalar (fixed-parameter runs) or per-chain [C]
        eps = torch.as_tensor(eps, **kw)
        if eps.dim() == 1:
            eps = eps[:, None]
        n_leap = self._draw_length(host) if n_leap is None else n_leap
        z = self._local(torch.randn((c, d), generator=dev, **kw)) if z is None else z
        u = self._local(torch.rand((c,), generator=dev, **kw)) if u is None else u
        p0 = self._momentum(z, inv_mass)

        # the final leapfrog's value-and-grad call IS the evaluation at y1
        y, p, v, g = state.y, p0, state.logp, state.grad
        for _ in range(n_leap):
            p = p + 0.5 * eps * g
            y = y + eps * self._velocity(p, inv_mass)
            v, g = self._value_and_grad(y)
            p = p + 0.5 * eps * g

        h0 = -state.logp + self._kinetic(p0, inv_mass)
        h1 = -v + self._kinetic(p, inv_mass)
        log_ratio = h0 - h1
        # reject trajectories whose energy error exceeds the cap in
        # either direction (an unstable trajectory can end with a
        # spuriously favourable energy); |dH| is invariant under
        # reversal, so the cap is a symmetric acceptance factor
        divergent = torch.abs(log_ratio) > self.max_energy_error
        log_ratio = torch.where(torch.isfinite(log_ratio) & ~divergent, log_ratio,
                                torch.full_like(log_ratio, -torch.inf))
        accept_prob = torch.clamp(torch.exp(log_ratio), max=1.0)
        accept = torch.log(u) < log_ratio

        new_state = HMCState(
            torch.where(accept[:, None], y, state.y),
            torch.where(accept, v, state.logp),
            torch.where(accept[:, None], g, state.grad),
            state.seed,
            state.step + 1,
        )
        return new_state, accept, accept_prob, divergent

    # -- warmup ----------------------------------------------------------
    def init_adapt_state(self) -> AdaptState:
        """Fresh adaptation state (the start-of-warmup carry), per chain
        for this rank's chains."""
        c, d = self.n_chains, self.ndim
        if self.mesh is not None:
            c = self._rows[1] - self._rows[0]
        kw = dict(dtype=self.dtype, device=self.device)
        log_eps0 = torch.full((c,), float(np.log(0.1)), **kw)
        return AdaptState(
            log_eps=log_eps0,
            log_eps_bar=log_eps0.clone(),
            h_bar=torch.zeros((c,), **kw),
            mu=float(np.log(10.0)) + log_eps0,
            t=torch.zeros((), **kw),
            w_mean=torch.zeros((d,), **kw),
            w_m2=torch.zeros_like(self._mass_eye()),
            w_n=torch.zeros((), **kw),
            inv_mass=self._mass_eye(),
        )

    def _warmup_schedule(self, n_warmup: int):
        """Stan-style expanding windows: an eps-only initial buffer, then
        repeated mass updates (30% / 50% / 75%) with Welford collection
        between them, then an eps-only terminal buffer."""
        w1 = max(1, int(0.15 * n_warmup))
        mass_bnds = sorted({max(w1 + 1, int(f * n_warmup)) for f in (0.30, 0.50, 0.75)})
        return w1, mass_bnds

    def _set_mass(self, a: AdaptState):
        var = a.w_m2 / torch.clamp(a.w_n - 1.0, min=1.0)
        if self.dense_mass:
            # shrink toward the diagonal for conditioning
            dvar = torch.clamp(torch.diag(var), min=1e-10)
            var = var + 1e-4 * torch.diag(dvar)
        else:
            var = torch.where(var > 1e-10, var, torch.ones_like(var))
        # restart dual averaging at a scale-free step size: the new mass
        # whitens the dynamics, so the stable eps is O(1)
        log_eps_r = torch.full_like(a.log_eps, float(np.log(0.5)))
        return a._replace(
            inv_mass=var,
            log_eps=log_eps_r,
            mu=float(np.log(10.0)) + log_eps_r,
            h_bar=torch.zeros_like(a.h_bar),
            t=torch.zeros_like(a.t),
            log_eps_bar=log_eps_r.clone(),
            w_mean=torch.zeros_like(a.w_mean),
            w_m2=torch.zeros_like(a.w_m2),
            w_n=torch.zeros_like(a.w_n),
        )

    def _warmup_step(self, st: HMCState, ad: AdaptState, i: int, n_warmup: int):
        """Warmup transition at absolute step ``i``; all state lives in
        (st, ad), so running [0, n) in one go equals [0, k) then [k, n)
        bit for bit (segmented, checkpointable warmup)."""
        w1, mass_bnds = self._warmup_schedule(n_warmup)
        st, _, accept_prob, _ = self._step(st, torch.exp(ad.log_eps), ad.inv_mass)
        ad = _da_update(ad, accept_prob, self.target_accept)
        if w1 <= i < mass_bnds[-1]:
            y, logp = self._all(st.y, st.logp)
            ad = _welford_update(ad, y, self.dense_mass, logp)
        if i in mass_bnds:
            ad = self._set_mass(ad)
            # pull escapees back before the next window's estimate
            st = self._rejuvenate(st)[0]
        return st, ad

    def _warmup_segment(self, state: HMCState, adapt: AdaptState, start: int, stop: int,
                        n_warmup: int):
        """Advance warmup from absolute step ``start`` to ``stop`` of a
        ``n_warmup``-step schedule."""
        for i in range(int(start), int(stop)):
            state, adapt = self._warmup_step(state, adapt, i, n_warmup)
        return state, adapt

    def _finish_warmup(self, state: HMCState, adapt: AdaptState):
        """Final rejuvenation: a resampled chain inherits its donor's
        adapted step size along with its position. Returns (state,
        eps [C] of every chain, inv_mass, n_rejuvenated)."""
        eps_bar = torch.exp(adapt.log_eps_bar)
        state, n_rejuvenated, (eps_bar,) = self._rejuvenate(state, extras=(eps_bar,))
        return state, self._all(eps_bar), adapt.inv_mass, n_rejuvenated

    def _rejuvenate(self, state: HMCState, extras=()):
        """Replace chains stuck far below the bulk with copies of healthy
        chains: IQR outliers, and chains more than 10 + 5 D below the best
        (robust when the majority drifted out). ``extras`` are per-chain
        [C] tensors permuted the same way. Returns ``(state, n_bad,
        new_extras)``; ``n_bad`` an int (a host sync, once a window). On a
        mesh the population is gathered first, the donors drawn over all
        of it on every rank, and each rank keeps its own rows."""
        gen = self._dev_gen
        gen.manual_seed(_step_seeds(_salted(state.seed, _SALT_REJUV), state.step)[1])
        y_all, lp, grad_all, *extras_all = self._all(state.y, state.logp, state.grad, *extras)
        full = state._replace(y=y_all, logp=lp, grad=grad_all)
        q25 = torch.quantile(lp, 0.25)
        q75 = torch.quantile(lp, 0.75)
        gap = 10.0 + 5.0 * state.y.shape[1]
        bad = (lp < q25 - 3.0 * (q75 - q25)) | (lp < torch.max(lp) - gap)
        n_bad = int(bad.sum())
        if n_bad == 0 or n_bad == lp.shape[0]:
            # no chain to replace, or no donor: the state stays
            return state, n_bad, tuple(extras)
        healthy = (~bad).to(torch.float64)
        donors = self._local(
            torch.multinomial(healthy, lp.shape[0], replacement=True, generator=gen))
        bad = self._local(bad)
        sel = bad[:, None]
        state = HMCState(
            y=torch.where(sel, full.y[donors], state.y),
            logp=torch.where(bad, lp[donors], state.logp),
            grad=torch.where(sel, full.grad[donors], state.grad),
            seed=state.seed,
            step=state.step,
        )
        return state, n_bad, tuple(torch.where(bad, ea[donors], e)
                                   for e, ea in zip(extras, extras_all))

    # -- full run --------------------------------------------------------
    def init_state(self, seed: int, initial_x) -> HMCState:
        """The state at ``initial_x`` [C, D] (every chain's; on a mesh this
        rank keeps its own rows)."""
        x = self._local(torch.as_tensor(initial_x, device=self.device).to(self.dtype))
        y = self.transform.to_y(x)
        logp, grad = self._value_and_grad(y)
        return HMCState(y, logp, grad, int(seed), 0)

    def _sample(self, state: HMCState, n_samples: int, eps, inv_mass):
        """Post-warmup recording phase at fixed parameters (``eps`` this
        rank's chains'); the chain is gathered on a mesh."""
        xs, lps, accs, divs = [], [], [], []
        for _ in range(n_samples):
            state, accept, _, divergent = self._step(state, eps, inv_mass)
            xs.append(self.transform.to_x(state.y))
            lps.append(state.logp)
            accs.append(accept)
            divs.append(divergent)
        if not xs:
            c, d = self.n_chains, self.ndim
            kw = dict(device=self.device)
            return state, HMCChain(
                torch.empty((0, c, d), dtype=self.dtype, **kw),
                torch.empty((0, c), dtype=self.dtype, **kw),
                torch.empty((0, c), dtype=torch.bool, **kw),
                torch.empty((0, c), dtype=torch.bool, **kw),
            )
        parts = (torch.stack(xs), torch.stack(lps), torch.stack(accs), torch.stack(divs))
        if self.mesh is not None:
            parts = (self._all(x.movedim(1, 0)).movedim(0, 1) for x in parts)
        return state, HMCChain(*parts)

    def prepare_state(self, seed: int, initial=None) -> HMCState:
        """Initial sampler state from ``initial`` [C, D] in constrained
        space (default: mid-box with 10%-of-width Gaussian jitter)."""
        if initial is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_salted(seed, _SALT_INIT))
            tr = self.transform
            z = torch.randn((self.n_chains, self.ndim), generator=gen, dtype=self.dtype,
                            device=self.device)
            initial = tr.lo + 0.5 * tr.width + 0.1 * tr.width * z
        state = self.init_state(seed, initial)
        if not bool(torch.all(torch.isfinite(self._all(state.logp)))):
            raise ValueError("initial positions have non-finite log-prob")
        return state

    def _warmup_with_retries(self, init_state: HMCState, n_warmup: int):
        """Warmup with the health retry: a large end-of-warmup rejuvenation
        fraction means the ensemble escaped during the final window;
        retry (at most twice) from the initial state with a fresh seed."""
        self.warmup_retries = 0
        seed = init_state.seed
        while True:
            start = init_state._replace(seed=retry_seed(seed, self.warmup_retries))
            state, adapt = self._warmup_segment(start, self.init_adapt_state(), 0, n_warmup,
                                                n_warmup)
            state, eps, im, n_rejuv = self._finish_warmup(state, adapt)
            self.n_rejuvenated = n_rejuv
            if n_rejuv <= 0.2 * self.n_chains or self.warmup_retries >= 2:
                return state, eps, im
            self.warmup_retries += 1

    def warmup(self, seed: int, n_warmup: int, initial=None):
        """Adaptation only: returns ``(state, step_size [C], inv_mass)``
        ready for :meth:`run_from_state`. Sets ``warmup_retries``,
        ``n_rejuvenated``, ``step_size`` and ``inv_mass``."""
        if n_warmup < 1:
            raise ValueError("warmup requires n_warmup >= 1")
        state, eps, im = self._warmup_with_retries(self.prepare_state(seed, initial), n_warmup)
        self.step_size = eps.cpu().numpy()
        self.inv_mass = im.cpu().numpy()
        return state, eps, im

    def run_from_state(self, state: HMCState, n_samples: int, step_size, inv_mass):
        """Record ``n_samples`` draws from a prepared/checkpointed state at
        fixed sampler parameters (``step_size`` a scalar or every chain's
        [C]). Pure in ``state``: two segments back to back equal one
        combined segment bit for bit."""
        kw = dict(device=self.device)
        eps = torch.as_tensor(step_size, **kw).to(self.dtype)
        im = torch.as_tensor(inv_mass, **kw).to(self.dtype)
        return self._sample(state, n_samples, self._local(eps), im)

    def run(self, seed: int, n_samples: int, n_warmup: int = 500, initial=None,
            step_size: float = None, inv_mass=None):
        """Warm up (adaptation, discarded) then record ``n_samples``
        post-warmup draws. With ``n_warmup=0`` adaptation is skipped and
        ``step_size`` / ``inv_mass`` are used as given."""
        if n_warmup > 0 and (step_size is not None or inv_mass is not None):
            raise ValueError(
                "step_size/inv_mass are only honoured with n_warmup=0 "
                "(adaptation would overwrite them); pass n_warmup=0 to "
                "reuse a previous run's adapted values"
            )
        state = self.prepare_state(seed, initial)
        if n_warmup == 0:
            if step_size is None:
                raise ValueError("n_warmup=0 requires step_size")
            kw = dict(device=self.device)
            eps = torch.as_tensor(step_size, **kw).to(self.dtype)
            im = (self._mass_eye() if inv_mass is None
                  else torch.as_tensor(inv_mass, **kw).to(self.dtype))
            self.n_rejuvenated = 0
            self.warmup_retries = 0
        else:
            state, eps, im = self._warmup_with_retries(state, n_warmup)
        self.step_size = eps.cpu().numpy()  # scalar if fixed, [C] after warmup
        self.inv_mass = im.cpu().numpy()
        return self._sample(state, n_samples, self._local(eps), im)
