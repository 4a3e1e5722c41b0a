"""emcee-compatible sampler facade (counterpart of ``cosmax/compat.py``).

The reference drives everything through ``emcee.EnsembleSampler``
(bao/desi.py:119-141, sn/pantheon.py:78-95). This module gives users
migrating from the reference the same calls --
``EnsembleSampler(nwalkers, ndim, log_prob, moves=...)``, ``run_mcmc``,
``get_chain``, ``get_log_prob``, ``get_blobs``, ``get_autocorr_time``,
``acceptance_fraction``, ``reset`` -- backed by the port's ensemble
sampler (``cosmax_torch.samplers.ensemble``): every walker of a half is
evaluated in one batched call on the card instead of pickling walkers to
a process pool.

Differences from emcee (by design):

* ``log_prob_fn(x [D]) -> scalar`` must be made of torch operations: it
  is vectorised over the walkers with ``torch.func.vmap`` (a reference
  numba log-prob ports by ``np.`` -> ``torch.``). ``vmapped_log_prob=``
  takes a batched ``theta [W, D] -> [W]`` instead, such as a preset's
  ``fit.log_prob()``; pass it for a fast fit, since the fused log-prob
  kernel is a custom operation with no batching rule and cannot run
  under ``vmap``.
* determinism: pass ``seed=`` (emcee's global np.random state has no
  analogue here); the same seed gives the same chain bit for bit on the
  same device. Each fresh start from explicit coordinates runs on the
  stream of ``np.random.SeedSequence([seed, n_starts])``, so successive
  restarts never replay an earlier (e.g. burn-in) phase's random
  numbers.
* ``moves`` accepts the port's ``MoveSpec`` tuples or the emcee-style
  ``[(move_name, weight), ...]`` with names 'kde' | 'de' | 'snooker' |
  'stretch'. Defaults to the reference's mixture (KDE 0.30 / DE 0.56 /
  snooker 0.14).
* ``run_mcmc(..., progress=True)`` is accepted and ignored.
* ``run_mcmc(coords, n)`` after a previous run restarts from those
  coords (as emcee does) but REPLACES the stored chain rather than
  appending a discontinuous segment to it; pass ``None`` or the returned
  state to continue a chain.
* **blobs**: a ``log_prob_fn`` returning ``(logp, blob)`` (or a longer
  tuple) is detected by one call on a zeros point of the walkers' device
  and dtype, made when the first walkers are evaluated; an error there
  is the user function's and surfaces as it is. ``get_blobs()`` returns
  the per-(step, walker) blob array. With ``vmapped_log_prob=`` the
  batched function is the log-prob, ``log_prob_fn`` is never called and
  there are no blobs. Blobs are deterministic functions of position, so they are
  recomputed in one batched pass over the recorded chain instead of
  being threaded through the sampler's step loop.
* **backend**: :class:`NpzBackend` persists the chain and the sampler
  state (walkers, log-probs, the run's seed and step, which key its
  random stream) to one npz file with ``emcee.backends.HDFBackend``
  semantics: ``run_mcmc(None, n)`` resumes a crashed run where it left
  off, bit for bit, and ``get_chain()`` returns the whole history.
* ``device`` defaults to the card (``cosmax_torch.device.resolve``);
  pass ``device="cpu"`` to run on the CPU. The walkers' dtype is that of
  the initial coords when they are a tensor (an f64 CPU fit takes f64
  coords), else the device's default, float32.
"""

import os

import numpy as np
import torch

from cosmax_torch.device import resolve
from cosmax_torch.samplers.checkpoints import _save_fields, load_state
from cosmax_torch.samplers.diagnostics import autocorr_time
from cosmax_torch.samplers.ensemble import Chain, ChainState, MoveSpec, default_moves
from cosmax_torch.samplers.ensemble import EnsembleSampler as _Sampler


def _split_blobs(log_prob_fn, zero):
    """emcee-style blob detection: a log-prob returning a tuple is
    (logp, *blobs). One call on the zeros point ``zero`` tells.
    Returns (scalar_log_prob, blob_fn | None)."""
    with torch.no_grad():
        out = log_prob_fn(zero)
    if not isinstance(out, tuple) or len(out) < 2:
        return log_prob_fn, None

    def lp(x):
        return log_prob_fn(x)[0]

    def blob_fn(x):
        # always a tuple of the raw blob values; get_blobs decides the
        # layout (emcee stacks homogeneous blobs, keeps heterogeneous
        # ones as object cells)
        return tuple(log_prob_fn(x)[1:])

    return lp, blob_fn


def _coerce_moves(moves):
    if moves is None:
        return default_moves()
    out = []
    for m in moves:
        if isinstance(m, MoveSpec):
            out.append(m)
        else:
            kind, weight = m
            out.append(MoveSpec(str(kind).lower(), float(weight)))
    return tuple(out)


def _start_seed(seed: int, n_starts: int) -> int:
    """The run seed of the ``n_starts``-th fresh start of a facade seeded
    with ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(n_starts)]).generate_state(1, np.uint64)[0])


def _host(x):
    return x.detach().cpu().numpy()


class EnsembleSampler:
    """Drop-in facade for ``emcee.EnsembleSampler`` (see module doc)."""

    def __init__(self, nwalkers, ndim, log_prob_fn, moves=None, seed=0,
                 vmapped_log_prob=None, backend=None, device="cuda"):
        self.device = resolve(device)[0]
        self._log_prob_fn = log_prob_fn
        # the batched log-prob; for a per-walker log_prob_fn it is set
        # once the walkers' dtype is known (_detect_blobs)
        self._batched = vmapped_log_prob
        self._blob_fn = None
        self._s = _Sampler(self._log_prob, nwalkers, ndim, moves=_coerce_moves(moves))
        self.nwalkers = nwalkers
        self.ndim = ndim
        self._seed = seed
        self._chain = None
        self._state = None
        self._n_starts = 0
        self.backend = backend
        if backend is not None and backend.initialized:
            if (backend.nwalkers, backend.ndim) != (nwalkers, ndim):
                raise ValueError(
                    f"backend holds a ({backend.nwalkers}, {backend.ndim}) run, sampler is "
                    f"({nwalkers}, {ndim}); backend.reset() to start over"
                )
            self._state, self._chain = backend.load(self.device)

    def _detect_blobs(self, like):
        """Split off the blobs of a per-walker log_prob_fn, once, by a call
        on a zeros point of ``like``'s device and dtype."""
        if self._batched is None:
            lp, self._blob_fn = _split_blobs(self._log_prob_fn, like.new_zeros(self.ndim))
            self._batched = torch.func.vmap(lp)

    def _log_prob(self, theta):
        self._detect_blobs(theta)
        return self._batched(theta)

    def _walkers(self, coords):
        """Initial coords on the facade's device: a tensor keeps its dtype,
        other coords take the device's default (float32)."""
        dtype = coords.dtype if isinstance(coords, torch.Tensor) else None
        return torch.as_tensor(coords).to(*resolve(self.device, dtype))

    def run_mcmc(self, initial_state, nsteps, progress=False, thin=1, **_):
        if isinstance(initial_state, ChainState):
            # emcee's burn-in idiom: state = run_mcmc(p0, n); reset();
            # run_mcmc(state, n) continues from the returned state
            # (walkers, log-probs and the random stream)
            self._state = initial_state
            self._chain = None
        elif initial_state is not None:
            if self.backend is not None and self.backend.initialized:
                raise ValueError(
                    "the backend already holds a run; pass initial_state=None to resume it "
                    "or backend.reset() to start over (emcee HDFBackend semantics)"
                )
            # explicit coords restart the chain from those positions, as
            # emcee does, on a random stream of their own
            seed = _start_seed(self._seed, self._n_starts)
            self._n_starts += 1
            self._state, self._chain = self._s.run(self._walkers(initial_state), nsteps,
                                                   seed=seed, thin=thin)
            self._persist()
            return self._state
        if self._state is None:
            raise ValueError(
                "Cannot have initial_state=None if run_mcmc has never been called (pass "
                "walker coords of shape [nwalkers, ndim])"
            )
        # continuation, like emcee's second run_mcmc call
        self._state, chain = self._s.run_from_state(self._state, nsteps, thin=thin)
        self._chain = chain if self._chain is None else Chain(
            *(torch.cat([a, b]) for a, b in zip(self._chain, chain)))
        self._persist()
        return self._state

    def _persist(self):
        if self.backend is not None and self._chain is not None:
            self.backend.save(self._state, self._chain)

    def _recorded(self):
        if self._chain is None:
            raise RuntimeError("run_mcmc has not been called")
        return self._chain

    def get_blobs(self, discard=0, thin=1, flat=False):
        """Per-(step, walker) blobs, emcee layout, recomputed from the
        recorded positions in one batched pass (see module doc)."""
        samples = self._recorded().samples[discard::thin]
        self._detect_blobs(samples)
        if self._blob_fn is None:
            return None  # emcee returns None when log_prob has no blobs
        t, w = samples.shape[:2]
        with torch.no_grad():
            outs = [_host(o) for o in torch.func.vmap(self._blob_fn)(
                samples.reshape(t * w, self.ndim))]
        if len(outs) == 1:
            blobs = outs[0]
        elif len({o.shape[1:] for o in outs}) == 1:
            blobs = np.stack(outs, axis=1)  # [t*w, k, ...]
        else:
            # heterogeneous blob shapes: emcee falls back to object cells
            # holding each walker's blob tuple
            blobs = np.empty(t * w, dtype=object)
            for i in range(t * w):
                blobs[i] = tuple(o[i] for o in outs)
        blobs = blobs.reshape((t, w) + blobs.shape[1:])
        return blobs.reshape((t * w,) + blobs.shape[2:]) if flat else blobs

    def get_chain(self, discard=0, thin=1, flat=False):
        """[steps, walkers, dim] like emcee.get_chain."""
        samples = _host(self._recorded().samples[discard::thin])
        return samples.reshape(-1, self.ndim) if flat else samples

    def get_log_prob(self, discard=0, thin=1, flat=False):
        lps = _host(self._recorded().log_probs[discard::thin])
        return lps.reshape(-1) if flat else lps

    def get_autocorr_time(self, discard=0, **_):
        """Integrated autocorrelation time per dimension (emcee semantics;
        raises like emcee when the chain is too short)."""
        chain = self.get_chain(discard=discard)
        tau = np.asarray(autocorr_time(chain))
        if chain.shape[0] < 50 * np.max(tau):
            raise AutocorrError(
                tau, "The chain is shorter than 50 times the integrated autocorrelation time"
            )
        return tau

    @property
    def acceptance_fraction(self):
        return _host(self._recorded().accepted.to(torch.float64).mean(dim=0))

    def reset(self):
        self._chain = None
        self._state = None


class AutocorrError(Exception):
    """Mirror of emcee.autocorr.AutocorrError: carries the tau estimate."""

    def __init__(self, tau, message):
        super().__init__(message)
        self.tau = tau


_CHAIN_KEYS = ("samples", "chain_log_probs", "accepted", "move_index")


class NpzBackend:
    """Persistent chain store with ``emcee.backends.HDFBackend``
    semantics in one npz file: the recorded chain and the live sampler
    state in the ensemble checkpoint format of
    ``cosmax_torch.samplers.checkpoints`` (walkers, log-probs, the run's
    seed and step counter), so ``EnsembleSampler(..., backend=b)`` +
    ``run_mcmc(None, n)`` resumes a crashed run bit for bit where it
    stopped and ``get_chain()`` spans the whole history. Writes are
    atomic."""

    def __init__(self, filename: str):
        self.filename = str(filename)

    @property
    def initialized(self) -> bool:
        return os.path.exists(self.filename)

    def _load_raw(self):
        with np.load(self.filename) as z:
            return {k: z[k] for k in z.files}

    @property
    def iteration(self) -> int:
        """Recorded steps so far (0 for an empty backend)."""
        if not self.initialized:
            return 0
        return int(self._load_raw()["samples"].shape[0])

    @property
    def nwalkers(self):
        return int(self._load_raw()["samples"].shape[1])

    @property
    def ndim(self):
        return int(self._load_raw()["samples"].shape[2])

    def reset(self, nwalkers=None, ndim=None):
        """Drop the stored run (emcee's reset(nwalkers, ndim); the shapes
        are accepted for signature parity -- the next save defines them)."""
        if self.initialized:
            os.remove(self.filename)

    def save(self, state: ChainState, chain: Chain):
        _save_fields(
            self.filename, "ensemble", state.seed,
            dict(walkers=state.walkers, log_probs=state.log_probs, step=state.step,
                 **dict(zip(_CHAIN_KEYS, chain))),
        )

    def load(self, device="cuda"):
        """-> (ChainState, Chain) on ``device``, for resuming."""
        state = load_state(self.filename, device)
        z = self._load_raw()
        chain = Chain(*(torch.as_tensor(z[k], device=state.walkers.device) for k in _CHAIN_KEYS))
        return state, chain

    def get_chain(self, discard=0, thin=1, flat=False):
        s = self._load_raw()["samples"][discard::thin]
        return s.reshape(-1, s.shape[-1]) if flat else s

    def get_log_prob(self, discard=0, thin=1, flat=False):
        lp = self._load_raw()["chain_log_probs"][discard::thin]
        return lp.reshape(-1) if flat else lp

    def get_last_sample(self):
        """Final walker coords [nwalkers, ndim] (emcee's State.coords)."""
        return self._load_raw()["walkers"]
