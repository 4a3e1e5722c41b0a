"""cosmax_torch.parallel and the sharded samplers on the CPU: the cases of
tests/test_parallel.py as cases of the port, held against the JAX package.

The JAX functions run here, on the 8 virtual CPU devices that conftest
sets up. The port runs on ranks of a spawned gloo group, one per world
size (4 and 8) for the module, one torch thread a rank; the ranks import
no JAX (``tests/test_torch_parallel_ranks.py`` holds what they run and the
seeded inputs both packages take). Sharding changes no chain: the
sharded ensemble, HMC (warmup too) and the stepping-stone ladder equal
the unsharded port bit for bit, and a resumed sharded run the straight
one. Also here: the chi^2 kernel's row blocks (plain version) and the
equal-work split of L^-1's rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.configs import get_preset as jax_preset
from cosmax.parallel import data_sharded_chi2 as jax_data_sharded_chi2
from cosmax.parallel import make_mesh as jax_make_mesh
from cosmax.parallel import make_multislice_mesh as jax_make_multislice_mesh
from cosmax.parallel import sharded_batched_log_prob as jax_sharded_batched_log_prob
from cosmax.parallel.flagship import build_sharded_log_prob as jax_build_sharded_log_prob
from cosmax_torch.ops.kernels.whitened_chi2 import (
    ROW_STEP,
    row_blocks,
    whitened_chi2_grad,
    whitened_chi2_reference,
    whitened_chi2_rows,
    whitened_chi2_rows_reference,
)
from cosmax_torch.parallel import spawn
from cosmax_torch.parallel.mesh import mesh_device_type
from tests import test_torch_parallel_ranks as checks

WORLDS = (4, 8)


@pytest.fixture(scope="module")
def ranks():
    """{world size: rank 0's results}, each world size one spawned group."""
    return {w: spawn("tests.test_torch_parallel_ranks:run", w, threads=1, timeout=600)[0]
            for w in WORLDS}


def _jax_lp(x):
    w = x @ jnp.asarray(checks.ICOV)
    return -0.5 * jnp.sum(w * x)


_JAX_CHI2 = {}


def _jax_chi2(shape, n, w, seed, dtype):
    """JAX's data-sharded chi^2 of the case's inputs and, in f64, its
    jax.grad of sum_w c_w chi2_w, computed once for both tests."""
    key = (shape, n, w, seed, dtype)
    if key not in _JAX_CHI2:
        linv, delta = checks.chi2_inputs(n, w, seed)
        weights = np.arange(1.0, w + 1.0)
        with jax.enable_x64(dtype == "float64"):
            chi2 = jax_data_sharded_chi2(linv, _jax_mesh(shape))
            x = jnp.asarray(delta.astype(dtype))
            value = np.asarray(chi2(x))
            grad = (np.asarray(jax.grad(lambda v: jnp.sum(chi2(v) * weights))(x))
                    if dtype == "float64" else None)
        _JAX_CHI2[key] = value, grad
    return _JAX_CHI2[key]


def _jax_mesh(shape):
    s, w, d = shape
    devices = jax.devices()[: (s or 1) * w * d]
    if s is None:
        return jax_make_mesh(walkers=w, data=d, devices=devices)
    return jax_make_multislice_mesh(s, walkers=w, data=d, devices=devices)


@pytest.mark.parametrize("world", WORLDS)
def test_workers_import_no_jax(ranks, world):
    assert ranks[world]["jax_imported"] is False


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes(ranks, world):
    got = ranks[world]["mesh_shapes"]
    assert got["default"] == {"w": world, "d": 1}
    assert got["wd"] == {"w": world // 2, "d": 2}
    assert got["raises"] is True  # 3 x 2 is not the world
    assert got["device_type"] == "cpu"  # the spawn helper's rank device
    assert got["other_device_raises"] is True


@pytest.mark.parametrize("rank_device,requested,backend,want", [
    ("cuda:0", None, "gloo", "cuda"),  # gloo pair on one card: the card
    ("cuda:1", None, "nccl", "cuda"),
    ("cpu", None, "gloo", "cpu"),
    (None, None, "nccl", "cuda"),
    ("cpu", "cpu", "gloo", "cpu"),
    ("cuda:0", "cuda", "gloo", "cuda"),
    ("cpu", "cuda", "gloo", ValueError),
    ("cuda:0", "cpu", "gloo", ValueError),
])
def test_mesh_device_follows_the_rank(rank_device, requested, backend, want):
    """A mesh built without a device type takes the rank's device's (the
    one the spawn helper or the dry run's CLI set), and one asked for
    another type raises: nothing runs on the CPU unless the caller asks."""
    if want is ValueError:
        with pytest.raises(ValueError):
            mesh_device_type(requested, rank_device, backend)
    else:
        assert mesh_device_type(requested, rank_device, backend) == want


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_log_prob_matches_vmap(ranks, world):
    walkers = checks.gauss_walkers(64, 0)
    got = ranks[world]["batched_lp"]
    want = checks.lp(torch.as_tensor(walkers)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    mesh = _jax_mesh((None, world // 2, 2))
    jax_got = np.asarray(jax_sharded_batched_log_prob(_jax_lp, mesh)(jnp.asarray(walkers)))
    np.testing.assert_allclose(got, jax_got, rtol=2e-6)


CHI2_CASES = [(w, *case) for w in WORLDS for case in checks.chi2_cases(w)]


@pytest.mark.parametrize("world,name,shape,n,w,seed", CHI2_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CHI2_CASES])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_data_sharded_chi2_matches_jax(ranks, world, name, shape, n, w, seed, dtype):
    """rtol 5e-5 in f32 (as test_parallel.py), 1e-12 in f64; every N is
    split over 'd' (N = 23 at d = 4 with an empty block)."""
    got = ranks[world]["chi2"][name][f"torch.{dtype}"]
    want = _jax_chi2(shape, n, w, seed, dtype)[0]
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, want, rtol=5e-5 if dtype == "float32" else 1e-12)
    cuts = row_blocks(n, shape[2])
    assert ranks[world]["chi2"][name]["rows"] == (cuts[0], cuts[1])  # rank 0's block


@pytest.mark.parametrize("world,name,shape,n,w,seed", CHI2_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CHI2_CASES])
def test_data_sharded_chi2_gradient(ranks, world, name, shape, n, w, seed):
    """d/d delta of sum_w c_w chi2_w through the sharded chi^2 (its backward
    sums each rank's share over 'd') against the unsharded autograd and
    jax.grad of JAX's data_sharded_chi2, f64, rtol 1e-9."""
    got = ranks[world]["chi2"][name]["grad"]
    linv, delta = checks.chi2_inputs(n, w, seed)
    weights = np.arange(1.0, w + 1.0)
    d = torch.as_tensor(delta).requires_grad_(True)
    (want,) = torch.autograd.grad(
        (whitened_chi2_reference(torch.as_tensor(linv), d) * torch.as_tensor(weights)).sum(), d)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-9, atol=1e-9 * np.abs(want.numpy()).max())
    jgrad = _jax_chi2(shape, n, w, seed, "float64")[1]
    np.testing.assert_allclose(got, jgrad, rtol=1e-9, atol=1e-9 * np.abs(jgrad).max())


def test_sharded_sampler_runs_and_mixes(ranks):
    """600 stretch steps of 64 walkers over 4 ranks (test_parallel.py: 8
    devices; a gloo collective among 8 CPU processes takes ~7 ms against
    ~2 ms among 4, and a step makes two)."""
    got = ranks[4]["mix"]
    np.testing.assert_allclose(got["mean"], [0, 0], atol=0.2)
    assert 0.1 < got["acc"] < 0.9


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("moves", ["stretch", "default"])
def test_sharded_run_equals_unsharded(ranks, world, moves):
    """Same seed, same chain: walkers over every rank ('w' 8, or 'w' 2 x 'd'
    2 with the log-prob split over 'd' too), 40 steps, bit for bit."""
    for key, (shard, plain) in ranks[world]["chains"][moves].items():
        np.testing.assert_array_equal(shard, plain, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sampler", ["ensemble", "hmc"])
def test_sharded_checkpoint_resume_equals_straight(ranks, world, sampler):
    """Rank 0 writes the gathered state; every rank resumes its block. HMC
    snapshots its warmup every 20 of 30 steps and resumes after 6 of 12
    draws."""
    got = ranks[world]["checkpoints"]
    if sampler == "ensemble":
        assert got["start"] == 16
        np.testing.assert_array_equal(got["part2"], got["straight"][16:])
    else:
        assert got["h_start"] == 6
        np.testing.assert_array_equal(got["h_part2"], got["h_straight"][6:])


def test_multislice_mesh_runs_and_matches(ranks):
    """2 slices x 2 walker ranks x 2 data ranks; the chi^2 on it is a case
    of test_data_sharded_chi2_matches_jax."""
    got = ranks[8]["multislice"]
    assert got["shape"] == {"s": 2, "w": 2, "d": 2}
    np.testing.assert_allclose(got["got"], got["want"], rtol=2e-6)
    assert got["chain_log_probs"].shape == (50, 32)
    assert np.isfinite(got["chain_log_probs"]).all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("phase", ["fixed", "warmup"])
def test_sharded_hmc_equals_unsharded(ranks, world, phase):
    """Chains over every rank. Fixed parameters: no cross-chain reduction.
    With warmup: the pooled mass, the quartile cuts and the rejuvenation's
    donors over the gathered chains, the same on every rank. Bit for bit,
    the adapted step sizes and mass too."""
    plain, shard = ranks[world]["hmc"][phase]
    for key in plain:
        np.testing.assert_array_equal(shard[key], plain[key], err_msg=key)


def test_sharded_hmc_full_run_recovers_gaussian(ranks):
    flat = ranks[4]["hmc_recovers"]
    cov = np.linalg.inv(checks.ICOV)
    np.testing.assert_allclose(flat.mean(0), [0.0, 0.0], atol=0.15)
    np.testing.assert_allclose(flat.var(0), np.diag(cov), rtol=0.15)


def test_sharded_flagship_matches_jax(ranks):
    """build_sharded_log_prob on the parity flagship (DES-SN5YR's rows over
    'd' = 2) in f64 on 64 walkers against JAX's and the unsharded port,
    relative 1e-9; its value_and_grad against the unsharded one."""
    got = ranks[4]["flagship"]
    with jax.enable_x64(True):
        jfit = jax_preset("bao.desi_cmb_des5y", "wzcdm")
        mesh = _jax_mesh((None, 2, 2))
        x = checks.flagship_walkers(jfit.spec.bounds)
        want = np.asarray(jax.jit(jax_build_sharded_log_prob(jfit, mesh))(jnp.asarray(x)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got["logp"], want, rtol=1e-9)
    np.testing.assert_allclose(got["logp"], got["plain"], rtol=1e-9)
    np.testing.assert_allclose(got["value"], got["value_plain"], rtol=1e-9)
    scale = np.abs(got["grad_plain"]).max(axis=0)
    assert np.all(np.abs(got["grad"] - got["grad_plain"]).max(axis=0) <= 1e-9 * scale)


def test_sharded_fast_flagship_splits_over_d(ranks):
    """A fast preset has no large term: build_sharded_log_prob splits its
    walkers over every dim of the (2, 2) mesh, each rank's fused call
    takes 32 of the 128, and the gathered log-probs equal the unsharded
    call bit for bit."""
    got = ranks[4]["fast_flagship"]
    assert got["rows"] == [32]
    assert np.isfinite(got["plain"]).all()
    np.testing.assert_array_equal(got["logp"], got["plain"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ladder(ranks, world):
    """[K, C, D] with rungs over the walker axes and chains over 'd': finite
    ln L draws [steps, K, C], equal to the unsharded ladder bit for bit."""
    plain, shard = ranks[world]["ladder"]
    assert shard["lls"].shape == (4, world, 32)
    assert np.isfinite(shard["lls"]).all()
    for key in plain:
        np.testing.assert_array_equal(shard[key], plain[key], err_msg=key)


# -- the chi^2 kernel's row blocks (the plain version) --------------------


@pytest.mark.parametrize("n", [37, 300, 1829])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_row_blocks_sum_to_square(n, parts):
    """The blocks' shares add up to chi^2; f64, rtol 1e-12."""
    linv, delta = checks.chi2_inputs(n, 16, 3)
    linv, delta = torch.as_tensor(linv), torch.as_tensor(delta)
    want = whitened_chi2_reference(linv, delta)
    cuts = row_blocks(n, parts)
    got = sum(whitened_chi2_rows(linv[r0:r1, :r1].contiguous(), delta)
              for r0, r1 in zip(cuts, cuts[1:]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


@pytest.mark.parametrize("n,parts,want", [
    (1829, 2, [0, 1296, 1829]),
    (1829, 4, [0, 912, 1296, 1584, 1829]),
    (1829, 1, [0, 1829]),
    (37, 4, [0, 16, 24, 32, 37]),
    (4096, 4, [0, 2048, 2896, 3544, 4096]),
])
def test_row_blocks_round_to_the_tile(n, parts, want):
    """b_k = N sqrt(k / d) rounded to ROW_STEP, 8 rows (the row-block
    kernel takes any rows): the triangle's work r1^2 - r0^2 split evenly
    (equal rows would give the last of two blocks 3/4 of it), each block
    within 5% of the mean from N = 1024 on."""
    cuts = row_blocks(n, parts)
    assert cuts == want
    assert all(c % ROW_STEP == 0 for c in cuts[:-1])
    work = np.diff(np.square(np.asarray(cuts, dtype=float)))
    if n >= 1024:
        assert work.max() <= 1.05 * n * n / parts


@pytest.mark.parametrize("r0,r1", [(0, 37), (0, 16), (16, 37), (8, 24)])
def test_row_block_gradient(r0, r1):
    """whitened_chi2_grad on a slab (the backward of the kernel's row-block
    entry), 2 g (delta L_b^T) L_b, against autograd of the plain version,
    f64, rtol 1e-12."""
    linv, delta = checks.chi2_inputs(37, 8, 5)
    slab = torch.as_tensor(linv[r0:r1, :r1].copy())
    g = torch.linspace(0.5, 2.0, 8, dtype=torch.float64)
    d = torch.as_tensor(delta).requires_grad_(True)
    (want,) = torch.autograd.grad((whitened_chi2_rows_reference(slab, d) * g).sum(), d)
    got = whitened_chi2_grad(slab, d.detach(), g)
    assert got.shape == d.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
