"""Sampler-state checkpointing (counterpart of
``cosmax/samplers/checkpoints.py``).

The full sampler state round-trips through a single npz file, and
``run_from_state`` resumes bit-exactly: both samplers are pure functions
of their state, whose random stream is keyed by (seed, step). One file
format serves both samplers: a ``kind`` tag plus the state arrays.

* ``ensemble`` — walkers, log-probs, the seed and the step counter;
* ``hmc`` — positions y (unconstrained), logp, grad, seed, step, plus
  the fixed sampler parameters (step_size, inv_mass) and the
  recorded-draw counter;
* ``hmc_warmup`` — a mid-adaptation snapshot: the (HMCState,
  AdaptState) warmup carry plus the absolute warmup step, so a run
  preempted mid-warmup resumes bit-exactly too. When warmup completes
  the file is atomically replaced by the ``hmc`` record.

A checkpoint of the JAX package holds a threefry key (``key_data``)
instead of a seed; the port's Philox generators cannot continue that
stream, so such a file is refused.

A sampler on a device mesh (``mesh=``) checkpoints the global state: rank
0 gathers it and writes the file, the one writer, and every rank waits
for the write; on resume every rank loads the file and takes its own
block. A resumed sharded run equals the straight sharded run bit for bit.
"""

import os

import numpy as np
import torch

from cosmax_torch.device import resolve
from cosmax_torch.samplers.ensemble import ChainState
from cosmax_torch.samplers.hmc import AdaptState, HMCState, retry_seed
from cosmax_torch.utils.io import atomic_savez


def _concat(chains):
    """One chain (ensemble ``Chain`` or ``HMCChain``) from segments along T."""
    return type(chains[0])(*(torch.cat(parts) for parts in zip(*chains)))


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _save_fields(path: str, kind: str, seed: int, fields: dict, metadata: dict = None):
    atomic_savez(
        path,
        kind=np.asarray(kind),
        seed=np.asarray(seed, dtype=np.uint64),
        **{k: _host(v) for k, v in fields.items()},
        **{f"meta_{k}": np.asarray(v) for k, v in (metadata or {}).items()},
    )


def peek_kind(path: str) -> str:
    """The ``kind`` tag of a checkpoint file without loading its arrays."""
    with np.load(path) as z:
        return str(z["kind"]) if "kind" in z.files else "ensemble"


def _check_kind(z, path, expected):
    if "seed" not in z.files:
        if "key_data" in z.files:
            raise ValueError(
                f"{path} was written by the JAX package: its random state is a "
                "threefry key (key_data), which the port's Philox generators "
                "cannot continue — it cannot resume this sampler"
            )
        raise ValueError(f"{path} holds no seed: not a checkpoint of this sampler")
    # files written before the kind tag existed are all ensemble
    kind = str(z["kind"]) if "kind" in z.files else "ensemble"
    if kind != expected:
        raise ValueError(
            f"{path} holds a {kind!r} checkpoint, not {expected!r} — "
            "it cannot resume this sampler"
        )


def _tensor(a, device):
    return torch.as_tensor(np.array(a), device=device)



def _write(sampler, write):
    """``write()`` on the one writer (rank 0 of a sampler's mesh; the
    process itself without one); every rank waits for it."""
    mesh = getattr(sampler, "mesh", None)
    if mesh is None:
        write()
        return
    import torch.distributed as dist

    from cosmax_torch.parallel.mesh import barrier

    if dist.get_rank() == 0:
        write()
    barrier(mesh)


def save_state(path: str, state: ChainState, metadata: dict = None):
    _save_fields(
        path, "ensemble", state.seed,
        dict(walkers=state.walkers, log_probs=state.log_probs, step=state.step),
        metadata,
    )


def load_state(path: str, device="cuda") -> ChainState:
    """The ensemble state in ``path``, on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve(device)[0]
    with np.load(path) as z:
        _check_kind(z, path, "ensemble")
        return ChainState(
            walkers=_tensor(z["walkers"], device),
            log_probs=_tensor(z["log_probs"], device),
            step=int(z["step"]),
            seed=int(z["seed"]),
        )


def _hmc_fields(state: HMCState):
    return dict(y=state.y, logp=state.logp, grad=state.grad, step=state.step)


def _hmc_state(z, device) -> HMCState:
    return HMCState(
        y=_tensor(z["y"], device),
        logp=_tensor(z["logp"], device),
        grad=_tensor(z["grad"], device),
        seed=int(z["seed"]),
        step=int(z["step"]),
    )


def _meta(z):
    return {k[5:]: z[k][()] for k in z.files if k.startswith("meta_")}


def save_hmc_state(path: str, state: HMCState, step_size, inv_mass, n_recorded: int,
                   metadata: dict = None):
    _save_fields(
        path, "hmc", state.seed,
        dict(_hmc_fields(state), step_size=step_size, inv_mass=inv_mass,
             n_recorded=n_recorded),
        metadata,
    )


def load_hmc_state(path: str, device="cuda"):
    """Returns ``(state, step_size, inv_mass, n_recorded, metadata)``, the
    state on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve(device)[0]
    with np.load(path) as z:
        _check_kind(z, path, "hmc")
        return (_hmc_state(z, device), np.array(z["step_size"]), np.array(z["inv_mass"]),
                int(z["n_recorded"]), _meta(z))


def save_hmc_warmup_state(path: str, state: HMCState, adapt: AdaptState, done: int,
                          n_warmup: int, metadata: dict = None):
    """Snapshot the warmup carry after ``done`` of ``n_warmup`` steps."""
    fields = dict(_hmc_fields(state), done=done, n_warmup=n_warmup)
    fields.update({f"ad_{k}": getattr(adapt, k) for k in AdaptState._fields})
    _save_fields(path, "hmc_warmup", state.seed, fields, metadata)


def load_hmc_warmup_state(path: str, device="cuda"):
    """Returns ``(state, adapt, done, n_warmup, metadata)`` on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve(device)[0]
    with np.load(path) as z:
        _check_kind(z, path, "hmc_warmup")
        adapt = AdaptState(**{k: _tensor(z[f"ad_{k}"], device) for k in AdaptState._fields})
        return _hmc_state(z, device), adapt, int(z["done"]), int(z["n_warmup"]), _meta(z)


def _check_shape(path, got, want, what):
    if tuple(got) != tuple(want):
        raise ValueError(
            f"checkpoint {path} holds a [{got[0]}, {got[1]}]-{what} state but the "
            f"sampler is configured for [{want[0]}, {want[1]}] — refusing to resume "
            "a different run (delete the file or match --walkers/--preset to extend it)"
        )


def run_with_checkpoints(sampler, seed: int, initial, n_steps: int, path: str,
                         every: int = 500, thin: int = 1):
    """Run the ensemble sampler in ``every``-step segments, checkpointing
    after each; resumes automatically if ``path`` already holds a state.

    Returns ``(state, chain, start_step)``. On a fresh run ``start_step``
    is 0 and ``chain`` covers the whole run; on resume ``chain`` holds the
    post-resume segments and ``start_step`` is the absolute step count
    already completed (callers offset burn-in discards by ``start_step //
    thin``). ``every`` is rounded up to a multiple of ``thin`` so the
    recorded stride equals a single uninterrupted thinned run's.
    ``initial`` is a tensor on the sampler's device: a resumed state is
    loaded onto that device.
    """
    if every < 1:
        raise ValueError(f"checkpoint interval must be >= 1 (got {every})")
    if not isinstance(initial, torch.Tensor):
        raise TypeError(
            f"initial must be a tensor on the sampler's device (got {type(initial).__name__}): "
            "its device is the one a resumed state is loaded onto"
        )
    every = -(-every // thin) * thin
    if os.path.exists(path):
        state = load_state(path, initial.device)
        _check_shape(path, state.walkers.shape, (sampler.n_walkers, sampler.ndim), "walker")
        state = sampler.shard_state(state)
        start = state.step
        if start >= n_steps:
            return state, None, start
        if start % thin:
            raise ValueError(
                f"cannot extend from a checkpoint at step {start} with thin={thin} "
                f"({start} % {thin} != 0): the recorded stride would misalign. Finish "
                "runs on multiples of thin (pick n_steps divisible by thin) if you "
                "plan to extend them."
            )
    else:
        state = sampler.init_state(initial, seed)
        start = 0
    done = start
    chains = []
    while done < n_steps:
        # the final segment runs the exact remainder: overshooting would
        # checkpoint steps that appear in no returned chain
        seg = min(every, n_steps - done)
        state, chain = sampler.run_from_state(state, seg, thin=thin)
        full = sampler.gather_state(state)
        _write(sampler, lambda: save_state(path, full))
        chains.append(chain)
        done += seg
    if not chains:
        return state, None, start
    return state, _concat(chains), start


def run_hmc_with_checkpoints(sampler, seed: int, n_samples: int, path: str, every: int = 500,
                             n_warmup: int = 500, initial=None, step_size=None,
                             inv_mass=None):
    """HMC twin of :func:`run_with_checkpoints`: adapt in ``every``-step
    checkpointed segments (the warmup carry is snapshotted after each, so
    a run preempted mid-warmup resumes bit-exactly too), checkpoint the
    adapted state, then record in ``every``-step segments, checkpointing
    after each. Resumes automatically if ``path`` already holds an hmc or
    hmc_warmup state.

    With ``n_warmup=0``, ``step_size`` (and optionally ``inv_mass``)
    supply the fixed parameters directly, as in ``HMCSampler.run``.

    Returns ``(state, chain, start)`` with the ensemble version's resume
    semantics. Also sets ``sampler.step_size`` / ``inv_mass`` /
    ``warmup_retries`` / ``n_rejuvenated`` (restored on resume).
    """
    if every < 1:
        raise ValueError(f"checkpoint interval must be >= 1 (got {every})")
    kind = peek_kind(path) if os.path.exists(path) else None
    if kind not in (None, "hmc", "hmc_warmup"):
        raise ValueError(
            f"{path} holds a {kind!r} checkpoint, not 'hmc' — it cannot resume this sampler"
        )
    if kind == "hmc_warmup" and n_warmup == 0:
        raise ValueError(
            f"{path} holds a mid-warmup checkpoint but n_warmup=0 was requested — "
            "refusing to resume a different run"
        )
    kw = dict(device=sampler.device)
    if kind == "hmc":
        state, eps, im, done, meta = load_hmc_state(path, sampler.device)
        _check_shape(path, state.y.shape, (sampler.n_chains, sampler.ndim), "chain hmc")
        state = sampler.shard_state(state)
        sampler.warmup_retries = int(meta.get("warmup_retries", 0))
        sampler.n_rejuvenated = int(meta.get("n_rejuvenated", 0))
        sampler.step_size, sampler.inv_mass = eps, im
        eps = torch.as_tensor(eps, **kw).to(sampler.dtype)
        im = torch.as_tensor(im, **kw).to(sampler.dtype)
        start = done
        if done >= n_samples:
            return state, None, done
    else:
        if n_warmup == 0:
            if step_size is None:
                raise ValueError("n_warmup=0 requires step_size")
            state = sampler.prepare_state(seed, initial)
            eps = torch.as_tensor(step_size, **kw).to(sampler.dtype)
            im = (sampler._mass_eye() if inv_mass is None
                  else torch.as_tensor(inv_mass, **kw).to(sampler.dtype))
            sampler.warmup_retries = 0
            sampler.n_rejuvenated = 0
            sampler.step_size, sampler.inv_mass = eps.cpu().numpy(), im.cpu().numpy()
        else:
            if step_size is not None or inv_mass is not None:
                raise ValueError("step_size/inv_mass are only honoured with n_warmup=0")
            state, eps, im = _warmup_checkpointed(sampler, seed, n_warmup, initial, path,
                                                  every)
        _save_hmc(sampler, path, state, eps, im, 0)
        start = done = 0
    chains = []
    while done < n_samples:
        seg = min(every, n_samples - done)
        state, chain = sampler.run_from_state(state, seg, eps, im)
        done += seg
        _save_hmc(sampler, path, state, eps, im, done)
        chains.append(chain)
    if not chains:
        return state, None, start
    return state, _concat(chains), start


def _warmup_checkpointed(sampler, seed, n_warmup, initial, path, every):
    """Warmup in ``every``-step segments, snapshotting the (HMCState,
    AdaptState) carry after each; resumes from a mid-warmup snapshot at
    ``path``. Bit for bit ``sampler.warmup``: the same steps, the same
    end-of-warmup rejuvenation and the same health-retry policy (the
    retry counter rides in the snapshot, and retry r restarts from the
    initial state with ``retry_seed(seed, r)``). Sets the sampler's
    adapted attributes and returns ``(state, eps, inv_mass)``."""
    if os.path.exists(path) and peek_kind(path) == "hmc_warmup":
        state, adapt, done, n_wu, meta = load_hmc_warmup_state(path, sampler.device)
        _check_shape(path, state.y.shape, (sampler.n_chains, sampler.ndim), "chain warmup")
        state, adapt = sampler.shard_state(state), sampler.shard_adapt(adapt)
        if n_wu != n_warmup:
            raise ValueError(
                f"checkpoint {path} is {done}/{n_wu} steps into a {n_wu}-step warmup "
                f"schedule; resuming it with n_warmup={n_warmup} would change the "
                "adaptation windows mid-flight — match n_warmup to extend it"
            )
        retries = int(meta.get("warmup_retries", 0))
    else:
        state = sampler.prepare_state(seed, initial)
        done, retries = 0, 0
        adapt = sampler.init_adapt_state()
    while True:
        while done < n_warmup:
            stop = min(done + every, n_warmup)
            state, adapt = sampler._warmup_segment(state, adapt, done, stop, n_warmup)
            done = stop
            full, full_adapt = sampler.gather_state(state), sampler.gather_adapt(adapt)
            _write(sampler, lambda: save_hmc_warmup_state(
                path, full, full_adapt, done, n_warmup, dict(warmup_retries=retries)))
        fstate, eps, im, n_rejuv = sampler._finish_warmup(state, adapt)
        if n_rejuv <= 0.2 * sampler.n_chains or retries >= 2:
            break
        retries += 1
        init = sampler.prepare_state(seed, initial)
        state = init._replace(seed=retry_seed(init.seed, retries))
        adapt = sampler.init_adapt_state()
        done = 0
    sampler.warmup_retries = retries
    sampler.n_rejuvenated = n_rejuv
    sampler.step_size = eps.cpu().numpy()
    sampler.inv_mass = im.cpu().numpy()
    return fstate, eps, im


def _save_hmc(sampler, path, state, eps, im, done):
    full = sampler.gather_state(state)
    _write(sampler, lambda: save_hmc_state(path, full, eps, im, done, _hmc_meta(sampler)))


def _hmc_meta(sampler):
    return dict(warmup_retries=sampler.warmup_retries, n_rejuvenated=sampler.n_rejuvenated)
