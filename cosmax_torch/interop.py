"""State carried across from the JAX package as numpy arrays.

This repository has no model weights: what the port takes over from
``cosmax`` is the sampler state (so a chain can continue in the port)
and the build-time constants of a likelihood term (so both packages
compute from identical inputs). Both arrive as numpy, never as jax
arrays, so this module needs no jax.
"""

import numpy as np
import torch


def constants_from_numpy(arrays: dict, device, dtype=torch.float32) -> dict:
    """{name: numpy array} -> {name: contiguous tensor on ``device``}.

    Floating arrays become ``dtype`` (cast from the f64 build values
    once); integer arrays stay int64 (gather indices). An entry named
    ``linv`` must be a square lower-triangular whitening operator: the
    CUDA chi^2 kernel skips its upper triangle, so a full matrix would
    give a wrong chi^2 there and is refused here, at build time.
    """
    out = {}
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        if name == "linv":
            if a.ndim != 2 or a.shape[0] != a.shape[1]:
                raise ValueError(f"linv must be square; got shape {a.shape}")
            if np.any(np.triu(a, 1) != 0.0):
                raise ValueError("linv must be lower-triangular")
        if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
            out[name] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            out[name] = torch.as_tensor(a.astype(np.float64), device=device).to(dtype)
    return out


def chain_state_from_numpy(walkers, log_probs, step, seed, device):
    """The arrays of a ``cosmax.samplers.ensemble.ChainState`` (walkers
    [W, D], log_probs [W], step) as numpy, plus the run's integer seed,
    -> the port's ``ChainState``. The port's random stream is keyed by
    (seed, step), so the chain continues from ``step`` in the port; its
    draws are the port's own, not jax's threefry."""
    from cosmax_torch.samplers.ensemble import ChainState

    # copies: the arrays may be read-only views of jax buffers
    walkers = torch.tensor(np.asarray(walkers), device=device)
    log_probs = torch.tensor(np.asarray(log_probs), device=device).to(walkers.dtype)
    if walkers.dim() != 2 or log_probs.shape != walkers.shape[:1]:
        raise ValueError(
            f"walkers [W, D] and log_probs [W] expected; got "
            f"{tuple(walkers.shape)} and {tuple(log_probs.shape)}"
        )
    return ChainState(walkers, log_probs, int(step), int(seed))
