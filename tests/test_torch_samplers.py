"""cosmax_torch.samplers against cosmax.samplers.

* each move fed the JAX package's own draws (jax.random on the same key
  as the JAX proposal) gives the JAX proposal and log factor, in f32;
* the sampler recovers a correlated 2-D Gaussian's mean and covariance;
* a chain state round-trips through ``interop.chain_state_from_numpy``
  and a resumed chain equals the uninterrupted one;
* the CLI runs a short fit on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.samplers import ensemble as je
from cosmax_torch import fit as tfit_cli
from cosmax_torch.interop import chain_state_from_numpy
from cosmax_torch.samplers import ensemble as te


def _jax_draws(kind, key, nh, nc, ndim):
    """The random numbers the JAX proposal of ``kind`` draws from ``key``
    (the same splits as cosmax/samplers/ensemble.py)."""
    if kind == "stretch":
        k1, k2 = jax.random.split(key)
        (j,) = je._rand_distinct(k2, nc, (nh,), 1)
        return dict(u=jax.random.uniform(k1, (nh,), dtype=jnp.float32), j=j)
    if kind == "de":
        k1, k2 = jax.random.split(key)
        j, k = je._rand_distinct(k1, nc, (nh,), 2)
        return dict(j=j, k=k, eps=jax.random.normal(k2, (nh,), dtype=jnp.float32))
    if kind == "snooker":
        j, k, l = je._rand_distinct(key, nc, (nh,), 3)
        return dict(j=j, k=k, l=l)
    k1, k2 = jax.random.split(key)
    (j,) = je._rand_distinct(k1, nc, (nh,), 1)
    return dict(j=j, eps=jax.random.normal(k2, (nh, ndim), dtype=jnp.float32))


@pytest.mark.parametrize("kind", ["stretch", "de", "snooker", "kde"])
def test_move_matches_jax_on_jax_draws(kind):
    rng = np.random.default_rng(0)
    nh, ndim = 40, 6
    active = rng.standard_normal((nh, ndim)).astype(np.float32)
    comp = (rng.standard_normal((nh, ndim)) @ np.diag([1, 2, 0.5, 1, 3, 0.2])).astype(np.float32)
    spec = je.MoveSpec(kind, 1.0)
    key = jax.random.PRNGKey(3)
    want_prop, want_fac = je._PROPOSALS[kind](key, jnp.asarray(active), jnp.asarray(comp), spec)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in _jax_draws(kind, key, nh, nh, ndim).items()}
    draws = {k: v.long() if not v.is_floating_point() else v for k, v in draws.items()}
    _, move = te.MOVES[kind]
    prop, fac = move(
        torch.as_tensor(active), torch.as_tensor(comp), te.MoveSpec(kind, 1.0), **draws
    )
    assert prop.dtype == torch.float32 and prop.shape == (nh, ndim)
    np.testing.assert_allclose(prop.numpy(), np.asarray(want_prop), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fac.numpy(), np.asarray(want_fac), rtol=1e-6, atol=1e-5)


def test_rand_distinct_is_distinct_and_in_range():
    gen = torch.Generator().manual_seed(0)
    j, k, l = te.rand_distinct(gen, 5, 4000, 3, "cpu")
    idx = torch.stack([j, k, l])
    assert int(idx.min()) >= 0 and int(idx.max()) < 5
    assert bool(((j != k) & (j != l) & (k != l)).all())
    # uniform over ordered distinct triples: 60 of them
    codes = (j * 25 + k * 5 + l).numpy()
    counts = np.bincount(codes, minlength=125)
    assert (counts > 0).sum() == 60


def test_gaussian_2d_mean_and_covariance():
    mean = torch.tensor([1.0, -2.0], dtype=torch.float64)
    cov = torch.tensor([[1.0, 0.6], [0.6, 2.0]], dtype=torch.float64)
    prec = torch.linalg.inv(cov)

    def log_prob(theta):
        d = theta - mean
        return -0.5 * torch.einsum("wi,ij,wj->w", d, prec, d)

    sampler = te.EnsembleSampler(log_prob, 64, 2)
    gen = torch.Generator().manual_seed(1)
    init = te.uniform_init(gen, np.array([[-4.0, 6.0], [-7.0, 3.0]]), 64, torch.float64, device="cpu")
    _, chain = sampler.run(init, 500, seed=2)
    flat = chain.flat(discard=100).numpy()
    assert 0.2 < chain.acceptance_fraction < 0.9
    np.testing.assert_allclose(flat.mean(0), mean.numpy(), atol=0.08)
    np.testing.assert_allclose(np.cov(flat.T), cov.numpy(), atol=0.15)


def test_chain_state_round_trip_and_resume():
    def log_prob(theta):
        return -0.5 * (theta**2).sum(-1)

    sampler = te.EnsembleSampler(log_prob, 16, 3)
    gen = torch.Generator().manual_seed(0)
    init = te.uniform_init(gen, np.array([[-1.0, 1.0]] * 3), 16, torch.float64, device="cpu")
    straight, chain = sampler.run(init, 6, seed=9)
    assert chain.samples.shape == (6, 16, 3)
    half, _ = sampler.run(init, 3, seed=9)
    # as a cosmax ChainState would hand it over: numpy arrays + the step
    state = chain_state_from_numpy(
        half.walkers.numpy(), half.log_probs.numpy(), half.step, 9, "cpu"
    )
    assert torch.equal(state.walkers, half.walkers) and state.step == 3
    resumed, _ = sampler.run_from_state(state, 3)
    assert torch.equal(resumed.walkers, straight.walkers)
    assert torch.equal(resumed.log_probs, straight.log_probs)
    # a JAX chain state's arrays continue in the port
    jstate = je.ChainState(
        jnp.asarray(init.numpy().astype(np.float32)),
        jnp.asarray(log_prob(init).numpy().astype(np.float32)),
        jax.random.PRNGKey(0), jnp.asarray(4),
    )
    state = chain_state_from_numpy(
        np.asarray(jstate.walkers), np.asarray(jstate.log_probs), int(jstate.step), 0, "cpu"
    )
    assert state.walkers.dtype == torch.float32
    np.testing.assert_array_equal(state.walkers.numpy(), np.asarray(jstate.walkers))
    cont, thinned = sampler.run_from_state(state, 4, thin=2)
    assert cont.step == 8 and thinned.samples.shape == (2, 16, 3)


def test_cli_short_fit(tmp_path, capsys):
    out = tmp_path / "run"
    rc = tfit_cli.main([
        "--preset", "bao.desi_cmb_des5y", "--model", "wzcdm", "--steps", "4",
        "--walkers", "16", "--seed", "0", "--device", "cpu", "--no-plots",
        "--out", str(out),
    ])
    assert rc == 0
    text = capsys.readouterr().out
    assert "clamping burn-in to 2" in text and "Chi squared" in text
    chain = np.load(out / "chain.npy")
    assert chain.shape == (2, 16, 6) and np.all(np.isfinite(chain))
    summary = json.loads((out / "summary.json").read_text())
    assert 0.0 <= summary["acceptance_fraction"] <= 1.0
    assert set(summary["chi2"]) == {"bao", "cmb_desi", "sn"}


# --fast, --sampler hmc, --checkpoint and the figures under --out are
# ported: their cases run (the fast one, fs8.fs8 in w0wacdm, on the reduced
# split grid of test_torch_w0wa_joint.py)
@pytest.mark.parametrize("flag", [["--sampler", "hmc"], ["--checkpoint", "c.npz"],
                                  ["--fast", "--model", "w0wacdm", "--preset", "fs8.fs8"],
                                  ["--out", "x"]])
def test_cli_ported_flags_run(flag, tmp_path, capsys):
    argv = ["--preset", "bao.desi", "--device", "cpu", *flag]
    if "--sampler" in flag or "--checkpoint" in flag:
        if "--checkpoint" in flag:
            argv[-1] = str(tmp_path / "c.npz")
            run = ["--steps", "6", "--checkpoint-every", "4"]
        else:
            run = ["--steps", "16", "--burn-in", "8", "--max-leapfrog", "8"]
        out = tmp_path / "run"
        n = torch.get_num_threads()
        torch.set_num_threads(1)  # small tensors: no thread pool spinning per op
        try:
            assert tfit_cli.main([*argv, *run, "--walkers", "8", "--no-plots",
                                  "--out", str(out)]) == 0
        finally:
            torch.set_num_threads(n)
        chain = np.load(out / "chain.npy")
        assert chain.shape[1:] == (8, 3) and len(chain) > 0 and np.all(np.isfinite(chain))
        summary = json.loads((out / "summary.json").read_text())
        if "--sampler" in flag:
            assert summary["sampler"]["kind"] == "hmc" and chain.shape[0] == 8
        else:
            assert (tmp_path / "c.npz").exists()
        return
    if "--fast" in flag:
        from threadpoolctl import threadpool_limits

        from tests.test_torch_w0wa_joint import small_split_grid

        with small_split_grid(), threadpool_limits(1):
            rc = tfit_cli.main([*argv, "--steps", "3", "--walkers", "8", "--no-plots",
                                "--out", str(tmp_path)])
        assert rc == 0 and "fast path" in capsys.readouterr().out
        assert np.all(np.isfinite(np.load(tmp_path / "chain.npy")))
        return
    # --out without --no-plots writes the JAX package's set of files
    argv[-1] = str(tmp_path / "x")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tfit_cli.main([*argv, "--steps", "6", "--walkers", "8"]) == 0
    finally:
        torch.set_num_threads(n)
    assert sorted(p.name for p in (tmp_path / "x").iterdir()) == [
        "chain.npy", "corner.png", "predictions_bao.png", "summary.json", "trace.png"]


def test_cli_fast_w0wacdm_on_the_cpu(tmp_path, capsys):
    """--fast --model w0wacdm on bao.desi: the split grid's BAO-only build
    and the fused log-prob's plain version on the CPU."""
    from threadpoolctl import threadpool_limits

    out = tmp_path / "run"
    # one BLAS thread: the build's SVDs gain little from threads, and beside
    # other test processes threaded SVDs spin against each other
    with threadpool_limits(1):
        rc = tfit_cli.main([
            "--preset", "bao.desi", "--model", "w0wacdm", "--fast", "--steps", "3",
            "--walkers", "16", "--seed", "0", "--device", "cpu", "--no-plots",
            "--out", str(out),
        ])
    assert rc == 0
    assert "fast path" in capsys.readouterr().out
    chain = np.load(out / "chain.npy")
    assert chain.shape[1:] == (16, 4) and np.all(np.isfinite(chain))
