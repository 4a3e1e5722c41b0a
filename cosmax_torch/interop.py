"""State carried across from the JAX package as numpy arrays.

This repository has no model weights: what the port takes over from
``cosmax`` is the sampler state (so a chain can continue in the port),
the build-time constants of a likelihood term, and a fast preset's
emulator bundle (so both packages compute from identical inputs, whatever
rank each SVD picks). All arrive as numpy, never as jax arrays, so this
module needs no jax.
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


def bundle_from_numpy(bundle, kind, halves, windows):
    """Install a finalized emulator program built elsewhere into the
    port's ``bundle`` (a ``models.linear_chi2._Bundle``, e.g. the
    ``meta["linear_chi2"].bundle`` of a fast preset's terms).

    ``kind``: the grid kind ("native", or "split" for the two halves of
    w0wacdm). ``halves``: per half a dict with ``axes`` (list of [n_i]
    node arrays), ``bw`` [n] and ``rep``: ("tucker", [U_i [n_i, r_i]],
    core), ("exact", table) or ("tt", perm, [G_i], tail). ``windows``:
    {tag: per half ``(slots, B_t [R_t, K], scale)``} with one ``(sl_a,
    sl_d, a_ref)`` slot per curve, matched to the bundle's registrations
    by tag (e.g. "bao-wzcdm"). Every term of the bundle then evaluates on
    these constants; its quadratic forms are rebuilt from the new
    windows.
    """
    f64 = lambda a: np.array(a, dtype=np.float64)  # copies off jax buffers
    new_halves = []
    for h in halves:
        rep = h["rep"]
        if rep[0] == "tucker":
            rep = ("tucker", [f64(u) for u in rep[1]], f64(rep[2]))
        elif rep[0] == "tt":
            rep = ("tt", tuple(int(a) for a in rep[1]), [f64(g) for g in rep[2]], f64(rep[3]))
        else:
            rep = ("exact", f64(rep[1]))
        new_halves.append(dict(rep=rep, axes=[f64(ax) for ax in h["axes"]], bw=f64(h["bw"])))
    by_tag = {key[0]: key for key in bundle.regs}
    if sorted(by_tag) != sorted(windows):
        raise ValueError(f"windows for {sorted(windows)}; the bundle registers {sorted(by_tag)}")
    per_reg = {}
    for tag, per_half in windows.items():
        per_reg[by_tag[tag]] = [
            (
                tuple((sl_a, sl_d, f64(a_ref)) for sl_a, sl_d, a_ref in slots),
                f64(b_t),
                float(scale),
            )
            for slots, b_t, scale in per_half
        ]
    bundle.install((kind, new_halves), per_reg)
