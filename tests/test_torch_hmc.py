"""cosmax_torch.samplers.hmc against cosmax.samplers.hmc.

* The deterministic pieces against the JAX package's own, driven from
  here in f64 to 1e-10: ``BoxTransform`` (values, log-Jacobian and its
  gradient), ``_da_update``, ``_welford_update`` (dense and diagonal,
  with and without the logp trim), the warmup schedule, and one HMC
  trajectory with JAX's momenta and accept uniforms injected (dense mass,
  per-chain step sizes).
* The JAX tests' cases as cases of the port (tests/test_hmc.py): a
  correlated Gaussian's recovery, the bao.desi posterior against its
  exact grid marginals (medians within 0.05 sigma, widths within 6%),
  bit reproducibility, the refusal of fixed parameters with warmup and
  of a bad init, rejuvenation, and the MAP-jitter init on a thin
  correlated shell.

Torch's Philox is not JAX's threefry: the statistical cases hold the
port to mathematics, not to the JAX chains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.samplers import hmc as jh
from cosmax_torch.data import load_bao
from cosmax_torch.likelihoods import bao as tbao
from cosmax_torch.likelihoods.base import ParamSpec, autograd_value_and_grad, make_log_prob
from cosmax_torch.samplers import hmc as th
from cosmax_torch.samplers.ensemble import uniform_init
from cosmax_torch.samplers.optimize import map_jitter_init

F64 = torch.float64
BOUNDS = np.array([[-4.0, 4.0], [-3.0, 5.0], [-2.0, 6.0]])
MEAN = np.array([0.3, -0.2, 1.0])
COV = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.3], [0.2, -0.3, 0.5]])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The samplers run thousands of small tensor ops: on one intra-op
    thread each; beside other test processes a thread pool per op spins
    (a 10 s case took 450 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(a, b, tol=1e-10):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _gauss(dtype=F64):
    mean = torch.tensor(MEAN, dtype=dtype)
    prec = torch.tensor(np.linalg.inv(COV), dtype=dtype)

    def lp(x):
        d = x - mean
        return -0.5 * ((d @ prec) * d).sum(-1)

    return lp


def _jax_gauss(x):
    d = x - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(np.linalg.inv(COV)) @ d


def _adapt(rng, c, d, dense):
    m2 = rng.standard_normal((d, d))
    return dict(
        log_eps=rng.standard_normal(c), log_eps_bar=rng.standard_normal(c),
        h_bar=rng.standard_normal(c), mu=rng.standard_normal(c), t=np.float64(7.0),
        w_mean=rng.standard_normal(d), w_m2=m2 @ m2.T if dense else rng.random(d),
        w_n=np.float64(40.0), inv_mass=np.eye(d) if dense else np.ones(d),
    )


def test_box_transform_matches_jax():
    rng = np.random.default_rng(0)
    x = BOUNDS[:, 0] + (BOUNDS[:, 1] - BOUNDS[:, 0]) * rng.random((9, 3))
    y = rng.standard_normal((9, 3)) * 3.0
    with jax.enable_x64(True):
        jt = jh.BoxTransform.from_bounds(BOUNDS, jnp.float64)
        want = dict(to_x=jt.to_x(y), to_y=jt.to_y(x), log_jac=jt.log_jac(y),
                    grad=jax.vmap(jax.grad(jt.log_jac))(jnp.asarray(y)),
                    dx=jax.vmap(lambda v: jnp.diag(jax.jacobian(jt.to_x)(v)))(jnp.asarray(y)))
    tt = th.BoxTransform.from_bounds(BOUNDS, F64, device="cpu")
    ty, tx = torch.as_tensor(y), torch.as_tensor(x)
    _close(tt.to_x(ty), want["to_x"])
    _close(tt.to_y(tx), want["to_y"])
    _close(tt.log_jac(ty), want["log_jac"])
    _close(tt.grad_log_jac(ty), want["grad"])
    _close(tt.dx_dy(ty), want["dx"])


def test_da_update_matches_jax():
    a = _adapt(np.random.default_rng(1), 6, 3, True)
    acc = np.random.default_rng(2).random(6)
    with jax.enable_x64(True):
        want = jh._da_update(jh.AdaptState(**{k: jnp.asarray(v) for k, v in a.items()}),
                             jnp.asarray(acc), 0.8)
    got = th._da_update(th.AdaptState(**{k: torch.as_tensor(v) for k, v in a.items()}),
                        torch.as_tensor(acc), 0.8)
    for k in th.AdaptState._fields:
        _close(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("trim", [True, False])
def test_welford_update_matches_jax(dense, trim):
    rng = np.random.default_rng(3)
    a = _adapt(rng, 40, 3, dense)
    y = rng.standard_normal((40, 3))
    logp = rng.standard_normal(40) * 30.0
    logp[:3] -= 500.0  # far below the best: trimmed beside the quartile
    with jax.enable_x64(True):
        want = jh._welford_update(jh.AdaptState(**{k: jnp.asarray(v) for k, v in a.items()}),
                                  jnp.asarray(y), dense, jnp.asarray(logp) if trim else None)
    got = th._welford_update(th.AdaptState(**{k: torch.as_tensor(v) for k, v in a.items()}),
                             torch.as_tensor(y), dense, torch.as_tensor(logp) if trim else None)
    for k in ("w_mean", "w_m2", "w_n"):
        _close(getattr(got, k), getattr(want, k))


def test_warmup_schedule_matches_jax():
    js = jh.HMCSampler(_jax_gauss, BOUNDS, 4)
    ts = th.HMCSampler(autograd_value_and_grad(_gauss()), BOUNDS, 4, dtype=F64, device="cpu")
    for n in (1, 2, 7, 10, 60, 100, 333, 500, 1000):
        assert ts._warmup_schedule(n) == js._warmup_schedule(n), n


def test_one_trajectory_with_injected_momenta_matches_jax():
    """JAX's ``_step`` on a key, and the port's with the momentum normals
    and accept uniforms that key draws: the same trajectory to 1e-10."""
    c, d, n_leap = 12, 3, 7
    rng = np.random.default_rng(4)
    x0 = MEAN + 0.5 * rng.standard_normal((c, d))
    m = rng.standard_normal((d, d))
    inv_mass = m @ m.T / d + 0.3 * np.eye(d)
    eps = 0.2 + 0.4 * rng.random(c)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        js = jh.HMCSampler(_jax_gauss, BOUNDS, c, max_leapfrog=8)
        jstate = js.init_state(key, jnp.asarray(x0))
        _, k_mom, _, k_acc = jax.random.split(jstate.key, 4)
        z = np.array(jax.random.normal(k_mom, (c, d), dtype=jnp.float64))
        u = np.array(jax.random.uniform(k_acc, (c,), dtype=jnp.float64))
        jnew, jacc, jprob, jdiv = js._step(jstate, jnp.asarray(eps), jnp.asarray(inv_mass),
                                           n_leap)
    ts = th.HMCSampler(autograd_value_and_grad(_gauss()), BOUNDS, c, max_leapfrog=8, dtype=F64, device="cpu")
    tstate = ts.init_state(0, torch.as_tensor(x0))
    for a, b in zip(tstate[:3], jstate[:3]):
        _close(a, b)
    tnew, tacc, tprob, tdiv = ts._step(tstate, torch.as_tensor(eps), torch.as_tensor(inv_mass),
                                       z=torch.as_tensor(z), u=torch.as_tensor(u),
                                       n_leap=n_leap)
    for a, b in zip(tnew[:3], jnew[:3]):
        _close(a, b)
    _close(tprob, jprob)
    assert np.array_equal(_np(tacc), np.asarray(jacc))
    assert np.array_equal(_np(tdiv), np.asarray(jdiv))
    assert 0 < int(np.asarray(jacc).sum()) < c  # both branches of the select ran


def test_hmc_gaussian_recovery():
    """tests/test_hmc.py's case with 128 chains (64 there): the adapted
    mass's scatter over seeds is the same in both packages (the [1, 1]
    ratio 3.86 +- 0.12 here, 3.92 +- 0.13 in JAX over 12 seeds at 64
    chains), which puts the 0.25 limit ~2 sigma out; 128 chains halve
    the variance."""
    s = th.HMCSampler(autograd_value_and_grad(_gauss(torch.float32)), np.array([[-8.0, 8.0]] * 3),
                      n_chains=128, max_leapfrog=24, device="cpu")
    _, ch = s.run(0, 500, n_warmup=600)
    flat = ch.flat().numpy()
    assert 0.6 < ch.acceptance_fraction < 0.95
    assert ch.n_divergent == 0
    assert tuple(ch.divergent.shape) == (500, 128)
    assert ch.divergences_per_chain.tolist() == [0] * 128
    assert np.allclose(flat.mean(0), MEAN, atol=0.05)
    assert np.allclose(flat.var(0), np.diag(COV), rtol=0.08)
    r = np.corrcoef(flat[:, 0], flat[:, 1])[0, 1]
    assert r == pytest.approx(0.6 / np.sqrt(2.0), abs=0.05)
    assert s.inv_mass.shape == (3, 3)
    assert np.allclose(s.inv_mass / s.inv_mass[2, 2], COV / COV[2, 2], atol=0.25)


def _bao_setup():
    """tests/test_exact_posterior.py's posterior in the port: bao.desi
    lcdm with GL-32 distances, f64."""
    spec = ParamSpec(("h", "Om"), np.array([(0.5, 0.8), (0.1, 0.7)]))
    term = tbao.build_bao_term(load_bao("desi_dr2"), "lcdm", tbao.rd_fixed(147.09), "cpu", F64,
                               grid=("gl", 32))
    return spec, make_log_prob(spec, [term], lambda p: {**p, "H0": 100 * p["h"]})


def _grid_marginals(log_prob, spec, n=400):
    """Exact marginal quantiles by 2-D grid integration (f64), as
    tests/test_exact_posterior.py computes them."""
    hs = np.linspace(spec.bounds[0, 0], spec.bounds[0, 1], n + 2)[1:-1]
    oms = np.linspace(spec.bounds[1, 0], spec.bounds[1, 1], n + 2)[1:-1]
    hh, oo = np.meshgrid(hs, oms, indexing="ij")
    pts = torch.as_tensor(np.stack([hh.ravel(), oo.ravel()], axis=1))
    ll = log_prob(pts).numpy().reshape(n, n)
    w = np.exp(ll - ll.max())

    def quantiles(axis, grid):
        m = w.sum(axis=1 - axis)
        c = np.cumsum(m) - 0.5 * m
        c /= m.sum()
        return tuple(np.interp(q, c, grid) for q in (0.159, 0.5, 0.841))

    return quantiles(0, hs), quantiles(1, oms)


def test_hmc_matches_exact_grid_posterior():
    spec, log_prob = _bao_setup()
    (h_lo, h_med, h_hi), (o_lo, o_med, o_hi) = _grid_marginals(log_prob, spec)
    s = th.HMCSampler(autograd_value_and_grad(log_prob), spec.bounds, n_chains=32,
                      max_leapfrog=12, dtype=F64, device="cpu")
    _, chain = s.run(5, 400, n_warmup=300)
    flat = chain.flat().numpy()
    h_sig, o_sig = 0.5 * (h_hi - h_lo), 0.5 * (o_hi - o_lo)
    assert np.median(flat[:, 0]) == pytest.approx(h_med, abs=0.05 * h_sig)
    assert np.median(flat[:, 1]) == pytest.approx(o_med, abs=0.05 * o_sig)
    q = np.percentile(flat, [15.9, 84.1], axis=0)
    assert 0.5 * (q[1, 0] - q[0, 0]) == pytest.approx(h_sig, rel=0.06)
    assert 0.5 * (q[1, 1] - q[0, 1]) == pytest.approx(o_sig, rel=0.06)


def _std_normal_vg():
    return autograd_value_and_grad(lambda x: -0.5 * (x**2).sum(-1))


def test_hmc_bit_reproducible():
    bounds = np.array([[-5.0, 5.0]] * 2)
    gen = torch.Generator()
    gen.manual_seed(1)
    init = uniform_init(gen, bounds, 16, device="cpu")
    s = th.HMCSampler(_std_normal_vg(), bounds, n_chains=16, max_leapfrog=8, device="cpu")
    _, c1 = s.run(7, 50, n_warmup=50, initial=init)
    _, c2 = s.run(7, 50, n_warmup=50, initial=init)
    assert torch.equal(c1.samples, c2.samples)
    _, c3 = s.run(8, 50, n_warmup=50, initial=init)
    assert not torch.equal(c1.samples, c3.samples)


def test_hmc_rejects_ignored_fixed_params():
    s = th.HMCSampler(_std_normal_vg(), np.array([[-5.0, 5.0]] * 2), n_chains=4, device="cpu")
    with pytest.raises(ValueError, match="n_warmup=0"):
        s.run(0, 10, n_warmup=10, step_size=0.1)
    with pytest.raises(ValueError, match="n_warmup=0"):
        s.run(0, 10, n_warmup=10, inv_mass=np.eye(2))


def test_hmc_rejects_bad_init():
    def lp(x):
        inside = torch.all(x.abs() < 1, dim=-1)
        return torch.where(inside, torch.zeros_like(x[:, 0]), torch.full_like(x[:, 0], -torch.inf))

    s = th.HMCSampler(autograd_value_and_grad(lp), np.array([[-5.0, 5.0]] * 2), n_chains=4, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        s.run(0, 10, n_warmup=10, initial=np.full((4, 2), 4.0))


def test_hmc_rejuvenates_stuck_chains():
    s = th.HMCSampler(_std_normal_vg(), np.array([[-5.0, 5.0]] * 2), 32, device="cpu")
    y = torch.as_tensor(np.concatenate([np.zeros((29, 2)), np.full((3, 2), 3.0)]),
                        dtype=torch.float32)
    state = s.init_state(0, y)
    logp = state.logp.clone()
    logp[-3:] -= 500.0  # the 3 outliers far below the bulk
    state = state._replace(logp=logp)
    new, n, _ = s._rejuvenate(state)
    assert n == 3
    assert torch.allclose(new.y[-3:], torch.zeros(3, 2))
    assert torch.allclose(new.logp[-3:], logp[:29].max().expand(3))
    assert torch.equal(new.y[:29], state.y[:29])


def test_map_jitter_init_lands_on_correlated_shell():
    cov = np.array([[1.0, 0.999], [0.999, 1.0]])  # thin ellipse
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)

    def lp(x):
        return -0.5 * ((x @ prec) * x).sum(-1)

    class FitStub:
        spec = ParamSpec(("a", "b"), np.array([[-5.0, 5.0], [-5.0, 5.0]]))
        device, dtype = torch.device("cpu"), torch.float32

        @staticmethod
        def differentiable_log_prob():
            return lp

    gen = torch.Generator()
    gen.manual_seed(0)
    init = map_jitter_init(FitStub(), gen, 256)
    # the mean logp cost of a covariance-matched jitter is ~ -D/2
    assert float(torch.median(lp(init))) > -4.0
    assert tuple(init.shape) == (256, 2)
    assert bool((init.abs() < 5.0).all())
