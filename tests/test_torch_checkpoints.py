"""cosmax_torch.samplers.checkpoints: the cases of tests/test_checkpoints.py
as cases of the port, each bit for bit (both samplers are pure functions
of their state, whose random stream is keyed by (seed, step)), and the
refusal of a checkpoint file written by the JAX package (its random state
is a threefry key)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.samplers import EnsembleSampler as JaxEnsemble
from cosmax.samplers import stretch_only as jax_stretch_only
from cosmax.samplers.checkpoints import save_state as jax_save_state
from cosmax_torch.likelihoods.base import autograd_value_and_grad
from cosmax_torch.samplers import EnsembleSampler, HMCSampler, stretch_only
from cosmax_torch.samplers import checkpoints as ck
from cosmax_torch.samplers.checkpoints import (
    load_hmc_state,
    load_hmc_warmup_state,
    load_state,
    peek_kind,
    run_hmc_with_checkpoints,
    run_with_checkpoints,
    save_hmc_state,
    save_hmc_warmup_state,
    save_state,
)

MU = torch.tensor([1.5, -0.5])
ICOV = torch.tensor(np.linalg.inv(np.array([[1.0, 0.6], [0.6, 2.0]])), dtype=torch.float32)
BOUNDS = np.array([[-6.0, 6.0], [-6.0, 6.0]])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The samplers run thousands of small tensor ops: on one intra-op
    thread each; beside other test processes a thread pool per op spins
    (a 10 s case took 450 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gauss_lp(x):
    d = x - MU
    return -0.5 * ((d @ ICOV) * d).sum(-1)


def _sampler(n_walkers=32):
    return EnsembleSampler(gauss_lp, n_walkers, 2, moves=stretch_only())


def _hmc(n_chains=16, bounds=BOUNDS):
    return HMCSampler(autograd_value_and_grad(gauss_lp), bounds, n_chains, max_leapfrog=8, device="cpu")


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_save_load_state_roundtrip(tmp_path):
    s = _sampler()
    state, _ = s.run(torch.zeros((32, 2)), 10, seed=5)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state, metadata={"n_steps": 10})
    loaded = load_state(path, device="cpu")
    _eq(loaded.walkers, state.walkers)
    _eq(loaded.log_probs, state.log_probs)
    assert (loaded.seed, loaded.step) == (state.seed, 10)
    # continuing from the loaded state equals continuing from memory
    _, c1 = s.run_from_state(state, 7)
    _, c2 = s.run_from_state(loaded, 7)
    _eq(c1.samples, c2.samples)


def test_fresh_checkpointed_run_equals_straight_run(tmp_path):
    s = _sampler()
    init = torch.zeros((32, 2))
    _, straight = s.run(init, 40, seed=11)
    state, merged, start = run_with_checkpoints(s, 11, init, 40, str(tmp_path / "c.npz"),
                                                every=16)
    # segments 16 + 16 + 8: nothing overshot
    assert start == 0 and state.step == 40
    _eq(merged.samples, straight.samples)


def test_no_steps_lost_across_resume_with_remainder(tmp_path):
    s = _sampler()
    init = torch.zeros((32, 2))
    path = str(tmp_path / "c.npz")
    _, part1, _ = run_with_checkpoints(s, 23, init, 40, path, every=16)
    state, part2, start = run_with_checkpoints(s, 23, init, 60, path, every=16)
    assert start == 40 and state.step == 60
    _, straight = s.run(init, 60, seed=23)
    _eq(torch.cat([part1.samples, part2.samples]), straight.samples)


def test_resume_continues_where_crash_left_off(tmp_path):
    s = _sampler()
    init = torch.zeros((32, 2))
    path = str(tmp_path / "c.npz")
    _, part1, start1 = run_with_checkpoints(s, 13, init, 32, path, every=16)
    assert start1 == 0
    # a fresh process passes the same seed and init; the checkpoint wins
    state, part2, start2 = run_with_checkpoints(s, 13, init, 64, path, every=16)
    assert start2 == 32 and state.step == 64
    _, straight = s.run(init, 64, seed=13)
    _eq(part2.samples, straight.samples[32:])


def test_checkpointed_thinning_keeps_global_stride(tmp_path):
    s = _sampler()
    init = torch.zeros((32, 2))
    _, straight = s.run(init, 24, seed=17, thin=4)
    # every=10 rounds up to 12, a multiple of thin
    _, merged, _ = run_with_checkpoints(s, 17, init, 24, str(tmp_path / "c.npz"), every=10,
                                        thin=4)
    _eq(merged.samples, straight.samples)


def test_already_complete_checkpoint_returns_none(tmp_path):
    s = _sampler()
    init = torch.zeros((32, 2))
    path = str(tmp_path / "c.npz")
    run_with_checkpoints(s, 19, init, 32, path, every=16)
    _, chain, start = run_with_checkpoints(s, 19, init, 32, path, every=16)
    assert chain is None and start == 32


def test_rerun_completed_job_with_odd_thin(tmp_path):
    s = _sampler()
    init = torch.zeros((32, 2))
    path = str(tmp_path / "c.npz")
    run_with_checkpoints(s, 29, init, 10, path, every=6, thin=3)
    _, chain, start = run_with_checkpoints(s, 29, init, 10, path, every=6, thin=3)
    assert chain is None and start == 10
    with pytest.raises(ValueError, match="cannot extend"):
        run_with_checkpoints(s, 29, init, 20, path, every=6, thin=3)


def test_invalid_every_rejected(tmp_path):
    with pytest.raises(ValueError, match=">= 1"):
        run_with_checkpoints(_sampler(), 0, torch.zeros((32, 2)), 10, str(tmp_path / "c.npz"),
                             every=0)


def test_hmc_state_roundtrip(tmp_path):
    s = _hmc()
    state, eps, im = s.warmup(3, 100)
    path = str(tmp_path / "h.npz")
    save_hmc_state(path, state, eps, im, 42, {"warmup_retries": 1})
    loaded, eps2, im2, n_rec, meta = load_hmc_state(path, device="cpu")
    for a, b in zip(loaded[:3], state[:3]):  # y, logp, grad
        _eq(a, b)
    assert (loaded.seed, loaded.step) == (state.seed, state.step)
    assert n_rec == 42 and int(meta["warmup_retries"]) == 1
    _eq(eps2, eps)
    _eq(im2, im)
    _, c1 = s.run_from_state(state, 5, eps, im)
    _, c2 = s.run_from_state(loaded, 5, eps2, im2)
    _eq(c1.samples, c2.samples)


def test_hmc_resume_equals_straight_run(tmp_path):
    path = str(tmp_path / "h.npz")
    s2 = _hmc()
    state0, eps, im = s2.warmup(7, 120)
    _, straight = s2.run_from_state(state0, 40, eps, im)
    s = _hmc()
    # "crash" after 2 of 5 segments
    _, part1, start1 = run_hmc_with_checkpoints(s, 7, 16, path, every=8, n_warmup=120)
    assert start1 == 0
    _, part2, start2 = run_hmc_with_checkpoints(s, 7, 40, path, every=8, n_warmup=120)
    assert start2 == 16
    _eq(torch.cat([part1.samples, part2.samples]), straight.samples)
    assert tuple(part2.divergent.shape) == (24, 16)


def test_hmc_checkpoint_already_complete(tmp_path):
    s = _hmc()
    path = str(tmp_path / "h.npz")
    run_hmc_with_checkpoints(s, 1, 10, path, every=4, n_warmup=60)
    _, chain, start = run_hmc_with_checkpoints(s, 1, 10, path, every=4, n_warmup=60)
    assert chain is None and start == 10
    assert s.warmup_retries == 0
    assert np.asarray(s.step_size).shape == (16,)  # per-chain eps


def test_hmc_checkpoint_fixed_params_no_warmup(tmp_path):
    s = _hmc()
    init = np.tile([[1.5, -0.5]], (16, 1)) + 0.01 * np.arange(16)[:, None]
    _, chain, start = run_hmc_with_checkpoints(s, 2, 12, str(tmp_path / "h.npz"), every=5,
                                               n_warmup=0, initial=init, step_size=0.3)
    assert start == 0 and tuple(chain.samples.shape) == (12, 16, 2)
    assert torch.isfinite(chain.samples).all()


def test_checkpoint_kind_mismatch_rejected(tmp_path):
    s = _sampler(16)
    state, _ = s.run(torch.zeros((16, 2)), 4, seed=0)
    path = str(tmp_path / "e.npz")
    save_state(path, state)
    with pytest.raises(ValueError, match="ensemble"):
        load_hmc_state(path, device="cpu")
    hstate, eps, im = _hmc().warmup(0, 50)
    hpath = str(tmp_path / "h.npz")
    save_hmc_state(hpath, hstate, eps, im, 0)
    with pytest.raises(ValueError, match="hmc"):
        load_state(hpath, device="cpu")


def test_jax_checkpoint_refused(tmp_path):
    """A checkpoint of the JAX package holds a threefry key, not a seed:
    the port's Philox streams cannot continue it, and it says so."""
    js = JaxEnsemble(lambda x: -0.5 * jnp.sum(x**2), 16, 2, moves=jax_stretch_only())
    jstate, _ = js.run(jax.random.PRNGKey(0), jnp.zeros((16, 2)), 2)
    path = str(tmp_path / "jax.npz")
    jax_save_state(path, jstate)
    with pytest.raises(ValueError, match="threefry"):
        load_state(path, device="cpu")
    with pytest.raises(ValueError, match="threefry"):
        run_with_checkpoints(_sampler(16), 0, torch.zeros((16, 2)), 4, path, every=2)


def test_numpy_initial_refused_fresh_and_on_resume(tmp_path):
    """The device of a resumed state is the device of ``initial``: a numpy
    ``initial`` has none, so it is refused, on a fresh run and on resume
    alike, instead of loading the state onto a device the sampler may not
    run on."""
    path = str(tmp_path / "ck.npz")
    init = np.zeros((16, 2), dtype=np.float32)
    with pytest.raises(TypeError, match="tensor on the sampler's device"):
        run_with_checkpoints(_sampler(16), 0, init, 8, path, every=4)
    run_with_checkpoints(_sampler(16), 0, torch.as_tensor(init), 4, path, every=4)
    with pytest.raises(TypeError, match="tensor on the sampler's device"):
        run_with_checkpoints(_sampler(16), 0, init, 8, path, every=4)
    state, chain, start = run_with_checkpoints(_sampler(16), 0, torch.as_tensor(init), 8, path,
                                               every=4)
    assert start == 4 and state.walkers.device.type == "cpu" and chain.samples.shape[0] == 4


def test_resume_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ck.npz")
    run_with_checkpoints(_sampler(16), 0, torch.zeros((16, 2)), 8, path, every=4)
    with pytest.raises(ValueError, match="refusing to resume"):
        run_with_checkpoints(_sampler(32), 0, torch.zeros((32, 2)), 16, path, every=4)


def test_hmc_resume_shape_mismatch_rejected(tmp_path):
    bounds = np.array([[-5.0, 5.0], [-5.0, 5.0]])
    path = str(tmp_path / "hmc.npz")
    run_hmc_with_checkpoints(_hmc(8, bounds), 0, 6, path, every=3, n_warmup=20)
    with pytest.raises(ValueError, match="refusing to resume"):
        run_hmc_with_checkpoints(_hmc(16, bounds), 0, 12, path, every=3, n_warmup=20)


def test_atomic_savez_survives_failed_rewrite(tmp_path, monkeypatch):
    path = str(tmp_path / "a.npz")
    ck.atomic_savez(path, x=np.arange(3))
    before = np.load(path)["x"].copy()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        ck.atomic_savez(path, x=np.arange(5))
    _eq(np.load(path)["x"], before)
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]


def test_segmented_warmup_bitwise():
    """Warmup in segments + ``_finish_warmup`` equals ``warmup`` in one
    go bit for bit: what mid-warmup checkpointing rests on."""
    s = _hmc()
    n_warmup = 60
    st_a, eps_a, im_a = s.warmup(11, n_warmup)
    nr_a = s.n_rejuvenated
    st, ad = s.prepare_state(11), s.init_adapt_state()
    for lo, hi in [(0, 13), (13, 14), (14, 40), (40, 60)]:
        st, ad = s._warmup_segment(st, ad, lo, hi, n_warmup)
    st_b, eps_b, im_b, nr_b = s._finish_warmup(st, ad)
    _eq(st_a.y, st_b.y)
    _eq(st_a.logp, st_b.logp)
    _eq(eps_a, eps_b)
    _eq(im_a, im_b)
    assert nr_a == nr_b


def test_hmc_mid_warmup_resume_equals_straight_run(tmp_path):
    n_warmup, n_samples = 40, 12
    sa = _hmc()
    _, straight, _ = run_hmc_with_checkpoints(sa, 9, n_samples, str(tmp_path / "a.npz"),
                                              every=1000, n_warmup=n_warmup)
    # the snapshot a run killed at 15/40 warmup steps would leave
    sb = _hmc()
    st, ad = sb._warmup_segment(sb.prepare_state(9), sb.init_adapt_state(), 0, 15, n_warmup)
    pathb = str(tmp_path / "b.npz")
    save_hmc_warmup_state(pathb, st, ad, 15, n_warmup, dict(warmup_retries=0))
    assert peek_kind(pathb) == "hmc_warmup"
    st2, _, done, n_wu, _ = load_hmc_warmup_state(pathb, device="cpu")
    assert (done, n_wu) == (15, n_warmup)
    _eq(st2.y, st.y)
    _, resumed, start = run_hmc_with_checkpoints(sb, 9, n_samples, pathb, every=1000,
                                                 n_warmup=n_warmup)
    assert start == 0
    _eq(resumed.samples, straight.samples)
    _eq(sa.step_size, sb.step_size)
    _eq(sa.inv_mass, sb.inv_mass)
    assert peek_kind(pathb) == "hmc"


def test_mid_warmup_resume_guards(tmp_path):
    s = _hmc()
    st, ad = s._warmup_segment(s.prepare_state(0), s.init_adapt_state(), 0, 10, 40)
    path = str(tmp_path / "w.npz")
    save_hmc_warmup_state(path, st, ad, 10, 40, dict(warmup_retries=0))
    with pytest.raises(ValueError, match="n_warmup"):
        run_hmc_with_checkpoints(s, 0, 4, path, every=100, n_warmup=80)
    with pytest.raises(ValueError, match="n_warmup=0"):
        run_hmc_with_checkpoints(s, 0, 4, path, every=100, n_warmup=0, step_size=0.3)
