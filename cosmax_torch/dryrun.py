"""Multi-GPU dry run of the port (counterpart of
``__graft_entry__.dryrun_multichip``).

    python -m torch.distributed.run --nproc_per_node=N -m cosmax_torch.dryrun

or, from Python, on ranks that the spawn helper starts (a ``file://``
rendezvous, no network port)::

    from cosmax_torch.parallel import spawn
    results = spawn("cosmax_torch.dryrun:run", N, backend="gloo", device="cpu")

On a mesh ('w', 'd') with d = 2 when N >= 4 and N is even (JAX's rule;
``data`` overrides it), every rank runs, in the order of the JAX dry run:

1. one sharded ensemble step (the default move mixture) of the parity
   flagship ``bao.desi_cmb_des5y``/wzcdm: walkers over 'w', the DES-SN5YR
   whitening's rows over 'd' (``build_sharded_log_prob``);
2. an 8-step chain resumed from a checkpoint after 4 steps, equal to the
   straight sharded run bit for bit;
3. 4 steps of HMC with the chains over the walker axes (fixed step size,
   the sharded potential ``build_sharded_value_and_grad``), and its
   checkpoint resume, bit for bit;
4. one sharded ensemble step of the fast ``joint.multiprobe``/lcdm (one
   fused launch a rank a call);
5. one step each of the fast flagship in wzcdm and w0wacdm;
6. on a multi-slice mesh ('s', 'w', 'd') = (2, N/4, 2) when 4 | N, one
   flagship step;
7. a sharded stepping-stone ladder [K, C, D], rungs over the walker axes
   and chains over 'd', 4 + 4 steps.

With ``eval_walkers`` = E it also holds the sharded log-probs against the
unsharded ``fit.log_prob()`` of every walker: the parity flagship at E
walkers within 1e-6 of max|logp|, the fast flagships at 4 E and the
multiprobe at 2 E bit for bit (and a block of the walkers that starts
inside a kernel block, against the same walkers of the whole call).
Returns a dict of what it checked (the global arrays on every rank) and
the kernels' launches of the sharded calls (``row_block_launches``: the
chi^2's row-block kernel's alone, which a rank of 'd' > 1 launches).
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

FLAGSHIP = "bao.desi_cmb_des5y"
PARITY_RTOL = 1e-6  # sharded vs unsharded parity log-prob, of max|logp|
ROW_OFFSET = 37  # a block of walkers that starts inside a kernel block


def _say(msg):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(f"dryrun_multi: {msg}", flush=True)


def _bench_walkers(fit, n, seed):
    """Walkers near the box centre (mid +- 5% of the span, Gaussian), as
    ``bench.py`` draws them; every rank draws the same."""
    rng = np.random.default_rng(seed)
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    x = 0.5 * (lo + hi) + 0.05 * (hi - lo) * rng.standard_normal((n, fit.spec.dim))
    return torch.as_tensor(x.astype(np.float32), device=fit.device)


def _rank0_first(mesh, build):
    """``build()`` on rank 0, then on the others: they read the on-disk
    table cache that rank 0 wrote instead of building it again."""
    import torch.distributed as dist

    from cosmax_torch.parallel.mesh import barrier

    out = build() if dist.get_rank() == 0 else None
    barrier(mesh)
    return build() if out is None else out


def _launches():
    from cosmax_torch.ops.kernels import fused_log_prob, whitened_chi2

    return {"whitened_chi2": whitened_chi2.LAUNCHES, "fused_log_prob": fused_log_prob.LAUNCHES}


def _row_block_launches():
    from cosmax_torch.ops.kernels import whitened_chi2

    return whitened_chi2.ROWS_LAUNCHES


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


def _finite_or_neg_inf(lp):
    return bool(torch.all(torch.isfinite(lp) | (lp == -torch.inf)))


def _hold_eval(mesh, fit, sharded, n, seed, label, bitwise, out):
    """The sharded log-prob of n walkers against the unsharded call."""
    from cosmax_torch.parallel.mesh import gather_walkers, shard_walkers

    x = _bench_walkers(fit, n, seed)
    before = _launches()
    got = gather_walkers(mesh, sharded(shard_walkers(mesh, x)))
    launches = _since(before)
    unsharded = fit.log_prob()
    want = unsharded(x)
    same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(want)))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 1.0
    err = float((got[fin].double() - want[fin].double()).abs().max()) / scale if bool(fin.any()) else 0.0
    equal = bool(torch.equal(got, want))
    row = dict(walkers=n, max_err=err, bitwise=equal, launches=launches)
    if bitwise:
        # each walker's value from its own row alone: a block that starts
        # inside a kernel block, against the same walkers of the whole call
        part = unsharded(x[ROW_OFFSET:])
        row["offset_bitwise"] = bool(torch.equal(part, want[ROW_OFFSET:]))
        row["offset_max_err"] = float(
            (part[fin[ROW_OFFSET:]].double() - want[ROW_OFFSET:][fin[ROW_OFFSET:]].double())
            .abs().max()) / scale
    if not same_inf or not (equal if bitwise else err <= PARITY_RTOL):
        raise AssertionError(f"{label}: sharded log-prob of {n} walkers vs unsharded: "
                             f"max err {err:.3e} of max|logp|, bitwise {equal}, -inf rows "
                             f"equal {same_inf}")
    out[label] = dict(row, logp=got.cpu().numpy())
    _say(f"{label}: sharded log-prob of {n} walkers vs unsharded: max err {err:.3e} of "
         f"max|logp|, bit for bit {equal}"
         + (f", offset block bit for bit {row['offset_bitwise']}" if bitwise else "")
         + f"; launches {launches}")


def _step_once(mesh, fit, log_prob, n_walkers, init_seed, step_seed):
    from cosmax_torch.samplers import EnsembleSampler, default_moves
    from cosmax_torch.samplers.ensemble import uniform_init

    sampler = EnsembleSampler(log_prob, n_walkers, fit.spec.dim, moves=default_moves(),
                              mesh=mesh)
    gen = torch.Generator(device=fit.device)
    gen.manual_seed(init_seed)
    init = uniform_init(gen, fit.spec.bounds, n_walkers, fit.dtype, fit.device)
    state, accepted, move = sampler.step(sampler.init_state(init, step_seed))
    full = sampler.gather_state(state)
    if tuple(full.walkers.shape) != (n_walkers, fit.spec.dim) or not _finite_or_neg_inf(
            full.log_probs):
        raise AssertionError(f"sharded step: walkers {tuple(full.walkers.shape)}, log-probs "
                             "not all finite or -inf")
    return sampler, init, full, int(sampler._gather(accepted).sum()), move


def run(opts: dict = None) -> dict:
    """The dry run on this rank of an initialised process group (see the
    module's docstring) on the rank's device (the mesh takes it, see
    ``mesh_device_type``). ``opts``: ``data`` (the 'd' size; default JAX's
    rule), ``eval_walkers`` (0: no held evaluation), ``synthetic_sys`` (the
    presets' option: the dense synthetic SN covariance, a full 1829^2
    triangle for DES-SN5YR, whose published whitener is diagonal)."""
    import torch.distributed as dist

    from cosmax_torch.configs import get_preset
    from cosmax_torch.parallel.flagship import (
        build_sharded_log_prob,
        build_sharded_value_and_grad,
    )
    from cosmax_torch.parallel.mesh import (
        barrier,
        make_mesh,
        make_multislice_mesh,
        mesh_device,
        walker_axes,
    )
    from cosmax_torch.samplers import HMCSampler, SteppingStone
    from cosmax_torch.samplers.checkpoints import run_hmc_with_checkpoints, run_with_checkpoints

    opts = dict(opts or {})
    n = dist.get_world_size()
    data = opts.get("data") or (2 if n % 2 == 0 and n >= 4 else 1)
    mesh = make_mesh(walkers=n // data, data=data)
    device = mesh_device(mesh)
    # JAX's 4 x world size, at least 8: the snooker move draws three
    # distinct walkers of the complementary half
    n_walkers = max(4 * n, 8)
    n_eval = opts.get("eval_walkers") or 0
    sys_opt = dict(synthetic_sys=bool(opts.get("synthetic_sys")))
    out = {"mesh": {k: mesh.size(i) for i, k in enumerate(mesh.mesh_dim_names)},
           "device": str(device), "world_size": n}
    start = _launches()
    rows_start = _row_block_launches()

    fit = _rank0_first(mesh, lambda: get_preset(FLAGSHIP, "wzcdm", device=device, **sys_opt))
    batched = build_sharded_log_prob(fit, mesh)
    if n_eval:
        _hold_eval(mesh, fit, batched, n_eval, 0, "parity flagship", False, out)

    sampler, init, state, acc, move = _step_once(mesh, fit, batched, n_walkers, 1, 0)
    out["step"] = dict(walkers=state.walkers.cpu().numpy(), log_probs=state.log_probs.cpu().numpy())
    _say(f"mesh {out['mesh']} ok — one sharded ensemble step on {n_walkers} walkers, "
         f"move={move}, accepted={acc}")

    # a shared directory for the checkpoints: rank 0 makes it
    tmp = [tempfile.mkdtemp(prefix="cosmax_dryrun_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(tmp, src=0)
    tmp = tmp[0]
    try:
        n_steps = 8
        path = os.path.join(tmp, "ckpt.npz")
        state1, _, _ = run_with_checkpoints(sampler, 0, init, n_steps // 2, path,
                                            every=n_steps // 2)
        state2, chain, start_step = run_with_checkpoints(sampler, 0, init, n_steps, path,
                                                         every=n_steps // 2)
        _, straight = sampler.run(init, n_steps, seed=0)
        if start_step != n_steps // 2 or state2.step != n_steps or not torch.equal(
                chain.samples, straight.samples[n_steps // 2:]):
            raise AssertionError("sharded checkpoint resume != straight sharded run")
        out["chain"] = dict(samples=straight.samples.cpu().numpy(),
                            log_probs=straight.log_probs.cpu().numpy(),
                            accepted=straight.accepted.cpu().numpy())
        _say(f"{n_steps}-step sharded chain ok (checkpoint resume bit for bit, acceptance "
             f"{straight.acceptance_fraction:.2f})")

        hmc = HMCSampler(build_sharded_value_and_grad(fit, mesh), fit.spec.bounds, n_walkers,
                         max_leapfrog=4, mesh=mesh)
        _, hchain = hmc.run(2, 4, n_warmup=0, initial=init, step_size=1e-3)
        if tuple(hchain.samples.shape) != (4, n_walkers, fit.spec.dim) or not bool(
                torch.all(torch.isfinite(hchain.samples))):
            raise AssertionError(f"sharded HMC: samples {tuple(hchain.samples.shape)} not finite")
        _say(f"4-step sharded HMC ok (acceptance {hchain.acceptance_fraction:.2f})")
        hpath = os.path.join(tmp, "hmc.npz")
        _, hpart1, _ = run_hmc_with_checkpoints(hmc, 2, 2, hpath, every=2, n_warmup=0,
                                                initial=init, step_size=1e-3)
        _, hpart2, hstart = run_hmc_with_checkpoints(hmc, 2, 4, hpath, every=2, n_warmup=0,
                                                     initial=init, step_size=1e-3)
        both = torch.cat([hpart1.samples, hpart2.samples])
        if hstart != 2 or not torch.equal(both, hchain.samples):
            raise AssertionError("sharded HMC checkpoint resume != straight sharded HMC run")
        out["hmc"] = dict(samples=hchain.samples.cpu().numpy(),
                          log_probs=hchain.log_probs.cpu().numpy())
        _say("sharded HMC checkpoint resume bit for bit "
             f"(divergent trajectories {hchain.n_divergent})")
    finally:
        barrier(mesh)
        if dist.get_rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)

    mfit = _rank0_first(mesh, lambda: get_preset("joint.multiprobe", "lcdm", fast=True,
                                                 device=device, **sys_opt))
    m_lp = build_sharded_log_prob(mfit, mesh)
    if n_eval:
        _hold_eval(mesh, mfit, m_lp, 2 * n_eval, 3, "fast multiprobe lcdm", True, out)
    before = _launches()
    _, _, m_state, m_acc, _ = _step_once(mesh, mfit, m_lp, n_walkers, 3, 4)
    out["multiprobe_step"] = dict(log_probs=m_state.log_probs.cpu().numpy(),
                                  launches=_since(before))
    _say(f"sharded multiprobe step ok (fused fast path, accepted={m_acc}, launches "
         f"{out['multiprobe_step']['launches']})")

    for fam in ("wzcdm", "w0wacdm"):
        ffit = _rank0_first(mesh, lambda: get_preset(FLAGSHIP, fam, fast=True, device=device,
                                                     **sys_opt))
        f_lp = build_sharded_log_prob(ffit, mesh)
        if n_eval:
            _hold_eval(mesh, ffit, f_lp, 4 * n_eval, 8, f"fast flagship {fam}", True, out)
        before = _launches()
        _, _, f_state, f_acc, _ = _step_once(mesh, ffit, f_lp, n_walkers, 8, 9)
        out[f"{fam}_step"] = dict(log_probs=f_state.log_probs.cpu().numpy(),
                                  launches=_since(before))
        _say(f"sharded {fam} flagship step ok (fused fast path, accepted={f_acc}, launches "
             f"{out[f'{fam}_step']['launches']})")

    if n % 4 == 0:
        ms_mesh = make_multislice_mesh(2, walkers=n // 4, data=2)
        _, _, ms_state, ms_acc, _ = _step_once(
            ms_mesh, fit, build_sharded_log_prob(fit, ms_mesh), n_walkers, 5, 6)
        out["multislice_mesh"] = {k: ms_mesh.size(i) for i, k in enumerate(ms_mesh.mesh_dim_names)}
        _say(f"multi-slice mesh {out['multislice_mesh']} ok — one sharded flagship step, "
             f"accepted={ms_acc}")
    else:
        _say(f"multi-slice mesh skipped (world size {n} not divisible by 4)")

    w_size = n // data
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    mid, span = 0.5 * (lo + hi), hi - lo
    # a narrow prior box keeps every (rung, chain) init finite on the
    # flagship joint: this holds the program on the mesh, not the estimate
    nb = np.stack([mid - 0.05 * span, mid + 0.05 * span], axis=1)
    ss = SteppingStone(fit.value_and_grad(), nb, n_rungs=2 * w_size, n_chains=4 * data,
                       max_leapfrog=4, mesh=mesh)
    lls, accs = ss.ladder(7, 4, 4)
    if tuple(lls.shape) != (4, ss.n_rungs, ss.n_chains) or not bool(torch.all(torch.isfinite(lls))):
        raise AssertionError(f"sharded ladder: ln L draws {tuple(lls.shape)} not all finite")
    out["ladder"] = dict(lls=lls.cpu().numpy(), acceptance=float(accs.double().mean()))
    _say(f"sharded evidence ladder ok ([K={ss.n_rungs}, C={ss.n_chains}, D={ss.ndim}], rungs "
         f"over {walker_axes(mesh)}, chains over 'd', mean acceptance "
         f"{out['ladder']['acceptance']:.2f})")
    out["launches"] = _since(start)
    out["row_block_launches"] = _row_block_launches() - rows_start
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", type=int, default=None, help="size of 'd'; default JAX's rule")
    ap.add_argument("--eval-walkers", type=int, default=0,
                    help="hold the sharded log-probs against the unsharded ones at this size")
    ap.add_argument("--synthetic-sys", action="store_true",
                    help="the dense synthetic SN covariance (as cosmax_torch.fit's flag)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default NCCL where CUDA is, else gloo")
    ap.add_argument("--device", default=None,
                    help="cuda (rank r on cuda:<local rank r>), cuda:<i> (gloo) or cpu")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from cosmax_torch.parallel.launch import resolve_rank_device

    backend = args.backend or ("nccl" if torch.cuda.is_available() else "gloo")
    device = args.device or ("cuda" if backend == "nccl" else "cpu")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    resolve_rank_device(device, local_rank, backend)
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:  # torch.distributed.run
            dist.init_process_group(backend, init_method="env://")
        else:  # one rank
            dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=0,
                                    world_size=1)
        try:
            run(dict(data=args.data, eval_walkers=args.eval_walkers,
                     synthetic_sys=args.synthetic_sys))
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
