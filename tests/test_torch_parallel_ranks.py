"""The checks of ``tests/test_torch_parallel.py`` that run on the ranks of
a spawned gloo group (``cosmax_torch.parallel.spawn``), and the seeded
inputs that the test module hands to the JAX package too. It holds no
test of its own, and imports no JAX: the ranks run the port alone.

The bit-for-bit checks give each rank 32 walkers (or chains) of a half:
PyTorch's elementwise CPU kernels run the last elements of a tensor
(fewer than two vector widths, 32 float32 values with AVX-512) through a
scalar path whose transcendentals (sigmoid, log) may differ in the last
bit from the vector path, so a rank with fewer walkers than that would
compute some of them differently from the unsharded batch, before the
sampler did anything. Blocks of 32 values take the vector path at any
batch size."""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ICOV = np.linalg.inv(np.array([[1.0, 0.6], [0.6, 2.0]]))
BOUNDS = np.array([[-6.0, 6.0]] * 2)
FLAGSHIP_WALKERS = 64


def lp(x):
    w = x @ torch.as_tensor(ICOV, dtype=x.dtype)
    return -0.5 * torch.sum(w * x, dim=-1)


def gauss_vg(x):
    """(lp, its gradient -x ICOV) of a batch: the potential of the HMC and
    ladder checks. Written out, each walker's gradient is computed from its
    own row in the same way at any batch size; autograd's backward of ``x @
    ICOV`` multiplies by ICOV^T, a transposed operand for which the CPU's
    matmul picks another kernel at another batch size (2-8 rows against 32
    differ in the last bit), so the unsharded and sharded runs would differ
    before the sampler did anything."""
    w = x @ torch.as_tensor(ICOV, dtype=x.dtype)
    return -0.5 * torch.sum(w * x, dim=-1), -w


def gauss_walkers(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 2)).astype(np.float32)


def chi2_inputs(n, w, seed):
    """(L^-1 [n, n] f64, delta [w, n] f64) of a random SPD covariance."""
    from cosmax_torch.ops.linalg import whitening_operator

    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    linv = np.ascontiguousarray(whitening_operator(a @ a.T + n * np.eye(n)))
    return linv, rng.normal(size=(w, n))


def chi2_cases(world):
    """(name, mesh (slices, walkers, data), n, walkers, seed) of the
    data-sharded chi^2 at world size ``world``: test_parallel.py's N = 37
    and 23 and N = 300, the blocks cut on multiples of 8 rows (N = 37, d =
    2: [0, 24, 37]; d = 4: [0, 16, 24, 32, 37]; N = 300, d = 2: [0, 216,
    300]; d = 4: [0, 152, 216, 256, 300]), and N = 23 at d = 4, [0, 8, 16,
    16, 23], an empty block among them."""
    if world == 8:
        meshes = [("2x4", (None, 2, 4), 37, 16, 0), ("2x4", (None, 2, 4), 300, 16, 2),
                  ("2x4", (None, 2, 4), 23, 16, 4),
                  ("2x2x2", (2, 2, 2), 23, 8, 1), ("2x2x2", (2, 2, 2), 300, 8, 3)]
    else:
        meshes = [("2x2", (None, 2, 2), 37, 16, 0), ("2x2", (None, 2, 2), 300, 16, 2)]
    return [(f"{name}-n{n}", shape, n, w, seed) for name, shape, n, w, seed in meshes]


def flagship_walkers(bounds, n=FLAGSHIP_WALKERS, seed=4):
    rng = np.random.default_rng(seed)
    lo, hi = bounds[:, 0], bounds[:, 1]
    return 0.5 * (lo + hi) + 0.05 * (hi - lo) * rng.standard_normal((n, bounds.shape[0]))


def _mesh(shape):
    from cosmax_torch.parallel import make_mesh, make_multislice_mesh

    s, w, d = shape
    return make_mesh(w, d) if s is None else make_multislice_mesh(s, w, d)


def _host(x):
    return x.detach().cpu().numpy()


def _chains(world):
    from cosmax_torch.parallel import make_mesh, sharded_batched_log_prob
    from cosmax_torch.samplers import EnsembleSampler, default_moves, stretch_only

    mesh = make_mesh() if world == 8 else make_mesh(2, 2)
    n = 64 * mesh.size(0)  # 32 a rank a half
    init = torch.as_tensor(gauss_walkers(n, 1))
    out = {}
    for name, moves in (("stretch", stretch_only()), ("default", default_moves())):
        plain = EnsembleSampler(lp, n, 2, moves=moves)
        _, c_plain = plain.run(init, 40, seed=7)
        shard = EnsembleSampler(sharded_batched_log_prob(lp, mesh), n, 2, moves=moves,
                                mesh=mesh)
        _, c_shard = shard.run(init, 40, seed=7)
        out[name] = {k: (_host(getattr(c_shard, k)), _host(getattr(c_plain, k)))
                     for k in ("samples", "log_probs", "accepted")}
    return out


def _mix(world):
    from cosmax_torch.parallel import make_mesh, sharded_batched_log_prob
    from cosmax_torch.samplers import EnsembleSampler, stretch_only

    mesh = make_mesh()
    s = EnsembleSampler(sharded_batched_log_prob(lp, mesh), 64, 2, moves=stretch_only(),
                        mesh=mesh)
    _, chain = s.run(torch.as_tensor(gauss_walkers(64, 2)), 600, seed=0)
    return dict(mean=_host(chain.flat(discard=200).mean(0)), acc=chain.acceptance_fraction)


def _checkpoints(world, tmp):
    from cosmax_torch.parallel import make_mesh, sharded_batched_log_prob
    from cosmax_torch.samplers import EnsembleSampler, HMCSampler, stretch_only
    from cosmax_torch.samplers.checkpoints import run_hmc_with_checkpoints, run_with_checkpoints

    mesh = make_mesh(world // 2, 2)
    s = EnsembleSampler(sharded_batched_log_prob(lp, mesh), 32, 2, moves=stretch_only(),
                        mesh=mesh)
    init = torch.as_tensor(gauss_walkers(32, 2))
    _, straight = s.run(init, 32, seed=9)
    path = os.path.join(tmp, "c.npz")
    run_with_checkpoints(s, 9, init, 16, path, every=16)
    _, part2, start = run_with_checkpoints(s, 9, init, 32, path, every=16)
    hmc = HMCSampler(gauss_vg, BOUNDS, 32, max_leapfrog=8, mesh=mesh, device="cpu")
    _, h_straight = hmc.run(3, 12, n_warmup=30)
    hpath = os.path.join(tmp, "h.npz")
    # warmup snapshots every 20 steps; resumed after 6 draws
    run_hmc_with_checkpoints(hmc, 3, 6, hpath, every=20, n_warmup=30)
    _, h_part2, h_start = run_hmc_with_checkpoints(hmc, 3, 12, hpath, every=20, n_warmup=30)
    return dict(start=start, part2=_host(part2.samples), straight=_host(straight.samples),
                h_start=h_start, h_part2=_host(h_part2.samples),
                h_straight=_host(h_straight.samples))


def _multislice():
    from cosmax_torch.parallel import (
        make_multislice_mesh,
        sharded_batched_log_prob,
    )
    from cosmax_torch.samplers import EnsembleSampler, stretch_only

    mesh = make_multislice_mesh(2, walkers=2, data=2)
    walkers = torch.as_tensor(gauss_walkers(32, 3))
    from cosmax_torch.parallel.mesh import gather_walkers, shard_walkers

    got = gather_walkers(mesh, sharded_batched_log_prob(lp, mesh)(shard_walkers(mesh, walkers)))
    s = EnsembleSampler(sharded_batched_log_prob(lp, mesh), 32, 2, moves=stretch_only(),
                        mesh=mesh)
    _, chain = s.run(torch.as_tensor(gauss_walkers(32, 5)), 50, seed=4)
    return dict(shape={k: mesh.size(i) for i, k in enumerate(mesh.mesh_dim_names)},
                got=_host(got), want=_host(lp(walkers)), chain_log_probs=_host(chain.log_probs))


def _hmc(world):
    from cosmax_torch.parallel import make_mesh
    from cosmax_torch.samplers import HMCSampler

    mesh = make_mesh()
    n = 32 * world  # 32 chains a rank
    init = gauss_walkers(n, 1)
    out = {}
    for name, kw in (("fixed", dict(n_warmup=0, initial=init, step_size=0.3)),
                     ("warmup", dict(n_warmup=60, initial=init))):
        runs = []
        for m in (None, mesh):
            s = HMCSampler(gauss_vg, BOUNDS, n, max_leapfrog=8, mesh=m, device="cpu")
            _, c = s.run(9, 40, **kw)
            runs.append({k: _host(getattr(c, k)) for k in ("samples", "accepted", "log_probs")}
                        | dict(step_size=np.asarray(s.step_size), inv_mass=s.inv_mass,
                               n_rejuvenated=s.n_rejuvenated))
        out[name] = runs
    return out


def _hmc_recovers(world):
    from cosmax_torch.parallel import make_mesh
    from cosmax_torch.samplers import HMCSampler

    mesh = make_mesh()
    s = HMCSampler(gauss_vg, BOUNDS, 64, max_leapfrog=16, mesh=mesh, device="cpu")
    _, chain = s.run(2, 500, n_warmup=400, initial=gauss_walkers(64, 1))
    return _host(chain.flat())


def _chi2(world):
    from cosmax_torch.parallel.mesh import data_sharded_chi2, gather_walkers, shard_walkers

    out = {}
    for name, shape, n, w, seed in chi2_cases(world):
        mesh = _mesh(shape)
        linv, delta = chi2_inputs(n, w, seed)
        row = {}
        for dtype in (torch.float32, torch.float64):
            chi2 = data_sharded_chi2(linv, mesh, dtype)
            d_loc = shard_walkers(mesh, torch.as_tensor(delta, dtype=dtype))
            row[str(dtype)] = _host(gather_walkers(mesh, chi2(d_loc)))
            if dtype == torch.float64:
                d_loc.requires_grad_(True)
                weights = torch.arange(1.0, w + 1.0, dtype=dtype)
                (g,) = torch.autograd.grad((chi2(d_loc) * shard_walkers(mesh, weights)).sum(),
                                           d_loc)
                row["grad"] = _host(gather_walkers(mesh, g))
        row["rows"] = chi2.rows
        out[name] = row
    return out


def _flagship():
    from cosmax_torch.configs import get_preset
    from cosmax_torch.parallel import build_sharded_log_prob, build_sharded_value_and_grad
    from cosmax_torch.parallel import make_mesh
    from cosmax_torch.parallel.mesh import gather_walkers, shard_walkers

    mesh = make_mesh(2, 2)
    fit = get_preset("bao.desi_cmb_des5y", "wzcdm", device="cpu", dtype=torch.float64)
    x = torch.as_tensor(flagship_walkers(fit.spec.bounds))
    x_loc = shard_walkers(mesh, x)
    logp = gather_walkers(mesh, build_sharded_log_prob(fit, mesh)(x_loc))
    v, g = build_sharded_value_and_grad(fit, mesh)(x_loc)
    v0, g0 = fit.value_and_grad()(x)
    return dict(logp=_host(logp), plain=_host(fit.log_prob()(x)), value=_host(gather_walkers(mesh, v)),
                grad=_host(gather_walkers(mesh, g)), value_plain=_host(v0), grad_plain=_host(g0))


def _fast_flagship():
    """The fast flagship on a (2, 2) mesh: no large term, so the walkers
    are split over 'd' too and each rank's fused call takes its own 32."""
    import torch.distributed as dist

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fused
    from cosmax_torch.parallel import build_sharded_log_prob, make_mesh
    from cosmax_torch.parallel.mesh import gather_walkers, shard_walkers

    mesh = make_mesh(2, 2)
    build = lambda: get_preset("bao.desi_cmb_des5y", "wzcdm", fast=True, device="cpu")
    fit = build() if dist.get_rank() == 0 else None  # rank 0 fills the table cache
    dist.barrier()
    fit = fit or build()
    x = torch.as_tensor(flagship_walkers(fit.spec.bounds, 128, 5).astype(np.float32))
    seen, call = [], fused.fused_log_prob

    def counted(packed, theta):
        seen.append(theta.shape[0])
        return call(packed, theta)

    fused.fused_log_prob = counted
    try:
        sharded = build_sharded_log_prob(fit, mesh)
        logp = gather_walkers(mesh, sharded(shard_walkers(mesh, x)))
    finally:
        fused.fused_log_prob = call
    return dict(logp=_host(logp), plain=_host(fit.log_prob()(x)), rows=seen)


def _ladder(world):
    from cosmax_torch.parallel import make_mesh
    from cosmax_torch.samplers import SteppingStone

    mesh = make_mesh(world // 2, 2)
    runs = []
    for m in (None, mesh):
        # 2 rungs x 16 chains a rank
        ss = SteppingStone(gauss_vg, BOUNDS, n_rungs=world, n_chains=32,
                           max_leapfrog=4, mesh=m, device="cpu")
        lls, accs = ss.ladder(7, 6, 4)
        runs.append(dict(lls=_host(lls), accs=_host(accs)))
    return runs


def run(world_checks: dict = None) -> dict:
    """Every check of this world size on this rank; returns their results
    (rank 0's are the ones the tests read)."""
    import torch.distributed as dist

    from cosmax_torch.parallel import make_mesh

    world = dist.get_world_size()
    out = {"jax_imported": "jax" in sys.modules}
    shapes = {}
    for label, (w, d) in (("default", (None, 1)), ("wd", (world // 2, 2))):
        m = make_mesh(w, d)
        shapes[label] = {k: m.size(i) for i, k in enumerate(m.mesh_dim_names)}
    try:
        make_mesh(3, 2)
        shapes["raises"] = False
    except ValueError:
        shapes["raises"] = True
    # the mesh takes the rank's device (the spawn helper's "cpu") and
    # refuses another
    shapes["device_type"] = make_mesh().device_type
    try:
        make_mesh(device_type="cuda")
        shapes["other_device_raises"] = False
    except ValueError:
        shapes["other_device_raises"] = True
    out["mesh_shapes"] = shapes

    from cosmax_torch.parallel import sharded_batched_log_prob
    from cosmax_torch.parallel.mesh import gather_walkers, shard_walkers

    mesh = make_mesh(world // 2, 2)
    walkers = torch.as_tensor(gauss_walkers(64, 0))
    out["batched_lp"] = _host(gather_walkers(
        mesh, sharded_batched_log_prob(lp, mesh)(shard_walkers(mesh, walkers))))
    out["chi2"] = _chi2(world)
    out["chains"] = _chains(world)
    out["hmc"] = _hmc(world)
    out["ladder"] = _ladder(world)
    tmp = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(tmp, src=0)
    try:
        out["checkpoints"] = _checkpoints(world, tmp[0])
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(tmp[0], ignore_errors=True)
    if world == 8:
        out["multislice"] = _multislice()
    else:
        out["mix"] = _mix(world)
        out["hmc_recovers"] = _hmc_recovers(world)
        out["flagship"] = _flagship()
        out["fast_flagship"] = _fast_flagship()
    out["jax_imported"] |= "jax" in sys.modules
    return out
