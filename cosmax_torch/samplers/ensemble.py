"""Affine-invariant ensemble MCMC on the device (counterpart of
``cosmax/samplers/ensemble.py``).

Moves (the reference's mixture):

* **stretch** — Goodman & Weare stretch, a = 2
* **de** — differential evolution, gamma0 = 2.38/sqrt(2 D) with
  multiplicative jitter
* **snooker** — DE snooker with gamma_s = 1.7 and the
  (D-1) log(|x'-z|/|x-z|) Metropolis factor
* **kde** — Gaussian-KDE resample of the complementary half with Scott
  bandwidth and the q(old)/q(new) correction

Red-black halves: each step updates half 0 against half 1, then half 1
against the updated half 0; one move kind is drawn per step from the
mixture weights.

Each proposal is split into a *draw* (random numbers from a
``torch.Generator``) and a *move* (a deterministic function of the
walkers and the draws), so the moves can be fed any draws, including
the JAX package's. The random stream of step ``s`` of a run seeded with
``seed`` is keyed by (seed, s): a chain resumed from a state continues
exactly as the uninterrupted run would. The loop over steps is Python.

On a device mesh (``mesh=``, the counterpart of JAX's
``vmapped_log_prob=``; ``cosmax_torch.parallel``) each rank holds its
block of both halves (``ChainState`` is the rank's [W_local, D]). Before
a half update the complementary half is gathered over the walker axes, so
every move (the KDE's mean, bandwidth and density too) sees the whole
half; each rank draws the whole batch's random numbers for the step and
keeps its own rows. Each walker's arithmetic is then that of the
unsharded chain, which a sharded run equals bit for bit wherever the
log-prob and PyTorch's kernels compute a walker's values from its own row
alone (on the CPU an elementwise kernel runs the last elements of a tensor,
fewer than two vector widths, through a scalar path whose transcendentals
may differ in the last bit: 32 walkers a rank a half avoid it). Recorded
chains are gathered, so ``Chain`` is global either way.
"""

import warnings
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class MoveSpec:
    kind: str  # 'stretch' | 'de' | 'snooker' | 'kde'
    weight: float
    a: float = 2.0  # stretch scale
    sigma: float = 1.0e-5  # DE jitter
    gamma0: Optional[float] = None  # DE scale; default 2.38/sqrt(2 D)
    gammas: float = 1.7  # snooker scale


def default_moves() -> Tuple[MoveSpec, ...]:
    """The reference's mixture: KDE 0.30 / DE 0.56 / snooker 0.14."""
    return (MoveSpec("kde", 0.30), MoveSpec("de", 0.56), MoveSpec("snooker", 0.14))


def stretch_only() -> Tuple[MoveSpec, ...]:
    return (MoveSpec("stretch", 1.0),)


class ChainState(NamedTuple):
    walkers: torch.Tensor  # [W, D]
    log_probs: torch.Tensor  # [W]
    step: int  # steps taken so far
    seed: int  # keys the random stream together with step


class Chain(NamedTuple):
    """samples[T, W, D] in emcee's get_chain() layout."""

    samples: torch.Tensor
    log_probs: torch.Tensor  # [T, W]
    accepted: torch.Tensor  # [T, W] bool
    move_index: torch.Tensor  # [T]

    @property
    def acceptance_fraction(self) -> float:
        return float(self.accepted.to(torch.float64).mean())

    def flat(self, discard: int = 0, thin: int = 1):
        s = self.samples[discard::thin]
        return s.reshape(-1, s.shape[-1])


# -- draws ---------------------------------------------------------------


def rand_distinct(gen, n, size, k, device):
    """k distinct integers in [0, n) per element: draw from shrinking
    ranges and shift past the values already drawn (exact uniform over
    distinct tuples for k <= 3)."""
    idx = [torch.randint(0, n, (size,), generator=gen, device=device)]
    if k >= 2:
        j = torch.randint(0, n - 1, (size,), generator=gen, device=device)
        idx.append(j + (j >= idx[0]).long())
    if k >= 3:
        m = torch.randint(0, n - 2, (size,), generator=gen, device=device)
        lo = torch.minimum(idx[0], idx[1])
        hi = torch.maximum(idx[0], idx[1])
        m = m + (m >= lo).long()
        m = m + (m >= hi).long()
        idx.append(m)
    return idx


def draw_stretch(gen, nh, nc, ndim, dtype, device):
    u = torch.rand(nh, generator=gen, dtype=dtype, device=device)
    (j,) = rand_distinct(gen, nc, nh, 1, device)
    return dict(u=u, j=j)


def draw_de(gen, nh, nc, ndim, dtype, device):
    j, k = rand_distinct(gen, nc, nh, 2, device)
    eps = torch.randn(nh, generator=gen, dtype=dtype, device=device)
    return dict(j=j, k=k, eps=eps)


def draw_snooker(gen, nh, nc, ndim, dtype, device):
    j, k, l = rand_distinct(gen, nc, nh, 3, device)
    return dict(j=j, k=k, l=l)


def draw_kde(gen, nh, nc, ndim, dtype, device):
    (j,) = rand_distinct(gen, nc, nh, 1, device)
    eps = torch.randn((nh, ndim), generator=gen, dtype=dtype, device=device)
    return dict(j=j, eps=eps)


# -- moves: deterministic in (active, comp, draws) -> (proposal, log factor)


def stretch_move(active, comp, spec: MoveSpec, u, j):
    ndim = active.shape[1]
    a = spec.a
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    cj = comp[j]
    prop = cj + z[:, None] * (active - cj)
    return prop, (ndim - 1.0) * torch.log(z)


def de_move(active, comp, spec: MoveSpec, j, k, eps):
    nh, ndim = active.shape
    g0 = spec.gamma0 if spec.gamma0 is not None else 2.38 / np.sqrt(2.0 * ndim)
    gamma = g0 * (1.0 + spec.sigma * eps)
    prop = active + gamma[:, None] * (comp[j] - comp[k])
    return prop, torch.zeros(nh, dtype=active.dtype, device=active.device)


def snooker_move(active, comp, spec: MoveSpec, j, k, l):
    ndim = active.shape[1]
    z, z1, z2 = comp[j], comp[k], comp[l]
    delta = active - z
    norm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    u = delta / torch.where(norm > 0, norm, torch.ones_like(norm))
    proj = torch.sum(u * (z1 - z2), dim=-1, keepdim=True)
    prop = active + spec.gammas * proj * u
    norm_new = torch.linalg.vector_norm(prop - z, dim=-1)
    norm = norm[:, 0]
    logfac = (ndim - 1.0) * (
        torch.log(torch.where(norm_new > 0, norm_new, torch.ones_like(norm_new)))
        - torch.log(torch.where(norm > 0, norm, torch.ones_like(norm)))
    )
    return prop, logfac


def kde_move(active, comp, spec: MoveSpec, j, eps):
    """proposal = comp[j] + bw * L eps (Scott bandwidth); log factor
    log q(active) - log q(proposal) under the complement's KDE."""
    nh, ndim = active.shape
    nc = comp.shape[0]
    bw = nc ** (-1.0 / (ndim + 4))
    centered = comp - comp.mean(dim=0)
    cov = centered.T @ centered / (nc - 1)
    cov = cov + 1e-12 * torch.eye(ndim, dtype=cov.dtype, device=cov.device)
    # a failed factorisation gives NaN (every proposal then rejected),
    # as in the reference, instead of an exception
    chol, info = torch.linalg.cholesky_ex(cov)
    chol = torch.where(info == 0, chol, torch.full_like(chol, torch.nan))
    prop = comp[j] + bw * (eps @ chol.T)

    def whiten(x):
        return (torch.linalg.solve_triangular(chol, x.T, upper=False) / bw).T

    v = whiten(comp)  # [nc, D]
    v_sq = torch.sum(v * v, dim=1)

    def log_kde(x):
        # Gram expansion |u_i - v_j|^2 = |u_i|^2 + |v_j|^2 - 2 u_i.v_j in
        # row blocks of ~32M elements (128 MB f32), so the [nh, nc]
        # matrix is never materialised whole
        u = whiten(x)
        u_sq = torch.sum(u * u, dim=1)
        block = max(8, min(nh, (1 << 25) // max(nc, 1)))
        out = []
        for s in range(0, nh, block):
            maha = u_sq[s : s + block, None] + v_sq[None, :] - 2.0 * (u[s : s + block] @ v.T)
            out.append(torch.logsumexp(-0.5 * maha, dim=1))
        return torch.cat(out)

    return prop, log_kde(active) - log_kde(prop)


MOVES = {
    "stretch": (draw_stretch, stretch_move),
    "de": (draw_de, de_move),
    "snooker": (draw_snooker, snooker_move),
    "kde": (draw_kde, kde_move),
}


def _step_seeds(seed: int, step: int):
    """Two 64-bit seeds (host, device) for step ``step`` of run ``seed``."""
    a, b = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    return int(a), int(b)


class EnsembleSampler:
    """``EnsembleSampler(log_prob, n_walkers, ndim)`` where
    ``log_prob(theta [W, D]) -> [W]``.

    With ``mesh`` (a ``DeviceMesh`` of ``cosmax_torch.parallel``),
    ``log_prob`` takes this rank's walkers [W_local, D] (e.g.
    ``build_sharded_log_prob`` or ``sharded_batched_log_prob``), the state
    is the rank's block of both halves and ``init_state`` takes the global
    initial positions, which every rank holds."""

    def __init__(
        self,
        log_prob: Callable,
        n_walkers: int,
        ndim: int,
        moves: Sequence[MoveSpec] = None,
        mesh=None,
    ):
        if n_walkers % 2 != 0:
            raise ValueError("n_walkers must be even (red-black halves)")
        self.mesh = mesh
        if mesh is not None:
            from cosmax_torch.parallel.mesh import local_rows

            # this rank's rows of each half, in the half's own numbering
            (lo, hi), _ = local_rows(mesh, n_walkers, parts=2)
            self._rows = (lo, hi)
        self.n_walkers = n_walkers
        self.ndim = ndim
        self.moves = tuple(moves) if moves is not None else default_moves()
        if n_walkers > 65536 and any(m.kind == "kde" for m in self.moves):
            # the KDE density evaluation is O(W^2) per step; the posterior
            # does not depend on the move mixture
            warnings.warn(
                f"KDE move disabled for n_walkers={n_walkers} (> 65536): "
                "its weight is reassigned to a stretch move",
                stacklevel=2,
            )
            self.moves = tuple(
                MoveSpec("stretch", m.weight, a=m.a) if m.kind == "kde" else m
                for m in self.moves
            )
        for m in self.moves:
            if m.kind not in MOVES:
                raise ValueError(f"unknown move kind {m.kind!r}")
        self.log_prob = log_prob
        w = torch.tensor([m.weight for m in self.moves], dtype=torch.float64)
        self._move_probs = w / w.sum()
        self._host_gen = torch.Generator()
        self._dev_gens = {}

    def _generators(self, seed: int, step: int, device: torch.device):
        host_seed, dev_seed = _step_seeds(seed, step)
        if device not in self._dev_gens:
            self._dev_gens[device] = torch.Generator(device=device)
        dev = self._dev_gens[device]
        self._host_gen.manual_seed(host_seed)
        dev.manual_seed(dev_seed)
        return self._host_gen, dev

    def _half_update(self, gen, active, active_lp, comp, spec: MoveSpec):
        """Update ``active`` (this rank's rows of a half) against the whole
        complementary half ``comp``: the draws are the whole half's, each
        rank keeping its own rows."""
        nh, ndim = comp.shape[0], active.shape[1]
        draw, move = MOVES[spec.kind]
        draws = draw(gen, nh, comp.shape[0], ndim, active.dtype, active.device)
        u = torch.rand(nh, generator=gen, dtype=active.dtype, device=active.device)
        if self.mesh is not None:
            lo, hi = self._rows
            draws = {k: v[lo:hi] for k, v in draws.items()}
            u = u[lo:hi]
        prop, logfac = move(active, comp, spec, **draws)
        prop_lp = self.log_prob(prop)
        log_ratio = logfac + prop_lp - active_lp
        accept = torch.log(u) < log_ratio
        new_active = torch.where(accept[:, None], prop, active)
        new_lp = torch.where(accept, prop_lp, active_lp)
        return new_active, new_lp, accept

    def step(self, state: ChainState):
        """One red-black step -> (new state, accepted [W], move index)."""
        host, gen = self._generators(state.seed, state.step, state.walkers.device)
        move_idx = int(torch.multinomial(self._move_probs, 1, generator=host))
        spec = self.moves[move_idx]
        half = state.walkers.shape[0] // 2
        w0, w1 = state.walkers[:half], state.walkers[half:]
        lp0, lp1 = state.log_probs[:half], state.log_probs[half:]
        w0, lp0, acc0 = self._half_update(gen, w0, lp0, self._whole_half(w1), spec)
        w1, lp1, acc1 = self._half_update(gen, w1, lp1, self._whole_half(w0), spec)
        new_state = ChainState(
            torch.cat([w0, w1]), torch.cat([lp0, lp1]), state.step + 1, state.seed
        )
        return new_state, torch.cat([acc0, acc1]), move_idx

    def _whole_half(self, local_half):
        """The whole half from every rank's rows of it (the half itself
        without a mesh)."""
        if self.mesh is None:
            return local_half
        from cosmax_torch.parallel.mesh import gather_walkers

        return gather_walkers(self.mesh, local_half)

    def shard_state(self, state: ChainState) -> ChainState:
        """This rank's state from the global one (itself without a mesh)."""
        if self.mesh is None:
            return state
        from cosmax_torch.parallel.mesh import shard_walkers

        return state._replace(walkers=shard_walkers(self.mesh, state.walkers, parts=2),
                              log_probs=shard_walkers(self.mesh, state.log_probs, parts=2))

    def gather_state(self, state: ChainState) -> ChainState:
        """The global state on every rank (itself without a mesh)."""
        if self.mesh is None:
            return state
        return state._replace(walkers=self._gather(state.walkers),
                              log_probs=self._gather(state.log_probs))

    def _gather(self, local, dim=0):
        """[..., W_local, ...] -> [..., W, ...] along ``dim``, in the
        walkers' global order."""
        from cosmax_torch.parallel.mesh import gather_walkers

        x = local.movedim(dim, 0)
        return gather_walkers(self.mesh, x, parts=2).movedim(0, dim)

    def init_state(self, initial: torch.Tensor, seed: int) -> ChainState:
        if initial.shape != (self.n_walkers, self.ndim):
            raise ValueError(
                f"initial must be [{self.n_walkers}, {self.ndim}]; got {tuple(initial.shape)}"
            )
        if self.mesh is not None:
            from cosmax_torch.parallel.mesh import shard_walkers

            initial = shard_walkers(self.mesh, initial, parts=2)
        return ChainState(initial, self.log_prob(initial), 0, int(seed))

    def run_from_state(self, state: ChainState, n_steps: int, thin: int = 1):
        """Advance ``n_steps`` steps, recording every ``thin``-th state
        (the first of each block) -> (final state, Chain); on a mesh the
        state is the rank's and the chain the gathered one."""
        recs = ([], [], [], [])
        for i in range(n_steps):
            state, acc, mv = self.step(state)
            if i % thin == 0:
                for r, v in zip(recs, (state.walkers, state.log_probs, acc, mv)):
                    r.append(v)
        device = state.walkers.device
        if not recs[0]:
            empty = state.walkers.new_empty((0, self.n_walkers, self.ndim))
            return state, Chain(
                empty,
                state.log_probs.new_empty((0, self.n_walkers)),
                torch.empty((0, self.n_walkers), dtype=torch.bool, device=device),
                torch.empty((0,), dtype=torch.long, device=device),
            )
        samples, log_probs, accepted = (torch.stack(r) for r in recs[:3])
        if self.mesh is not None:
            samples, log_probs, accepted = (self._gather(x, dim=1)
                                            for x in (samples, log_probs, accepted))
        return state, Chain(
            samples,
            log_probs,
            accepted,
            torch.tensor(recs[3], dtype=torch.long, device=device),
        )

    def run(self, initial: torch.Tensor, n_steps: int, seed: int, thin: int = 1):
        """Run ``n_steps`` steps from ``initial`` [W, D] (global)."""
        return self.run_from_state(self.init_state(initial, seed), n_steps, thin)


def uniform_init(gen: torch.Generator, bounds, n_walkers: int, dtype=None, device="cuda"):
    """Uniform-in-bounds initial walker positions, drawn from ``gen`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    from cosmax_torch.device import resolve

    device, dtype = resolve(device, dtype)
    bounds = np.asarray(bounds, dtype=np.float64)
    u = torch.rand((n_walkers, bounds.shape[0]), generator=gen, dtype=dtype, device=device)
    lo = torch.as_tensor(bounds[:, 0], device=device).to(dtype)
    hi = torch.as_tensor(bounds[:, 1], device=device).to(dtype)
    return lo + u * (hi - lo)
