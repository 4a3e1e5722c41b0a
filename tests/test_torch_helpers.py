"""The port's public helpers, constants and package exports against the
JAX package's: each helper at the same numpy inputs (drawn from a seed)
in float64, within 1e-12 relative; each constant equal; each JAX
``__all__`` name exported by the port's package of the same name."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

RTOL = 1e-12
MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")


def _walkers(seed, n=3):
    """n parameter points of every model: H0, Om, w0, wa."""
    rng = np.random.default_rng(seed)
    return dict(H0=rng.uniform(60.0, 75.0, n), Om=rng.uniform(0.2, 0.4, n),
                w0=rng.uniform(-1.3, -0.6, n), wa=rng.uniform(-1.5, 0.8, n))


def _sn_inputs(seed):
    """A trapezoid grid and SN redshifts on it, one past its end (clamped)."""
    rng = np.random.default_rng(seed)
    z_grid = np.linspace(0.0, 2.3, 401)
    z_data = np.concatenate([np.sort(rng.uniform(0.01, 2.2, 40)), [2.3, 2.4]])
    return z_grid, z_data, 1.0 + z_data + rng.uniform(-1e-3, 1e-3, z_data.shape)


def _per_walker(fn, p):
    """The JAX helper (scalar parameters) at each walker -> [W, ...]."""
    return np.stack([np.asarray(fn({k: float(v[i]) for k, v in p.items()}))
                     for i in range(len(p["Om"]))])


def _sn_case(name, model):
    def case():
        from cosmax.models import distances as jd
        from cosmax_torch.models import distances as td

        p = _walkers(1)
        z_grid, z_data, zhel = _sn_inputs(2)
        tp = {k: torch.as_tensor(v) for k, v in p.items()}
        zg = torch.as_tensor(z_grid)
        if name == "sn_comoving_integral":
            want = _per_walker(lambda q: jd.sn_comoving_integral(q, model, jnp.asarray(z_grid),
                                                                 jnp.asarray(z_data)), p)
            got = td.sn_comoving_integral(tp, model, zg, z_data)
        elif name == "apparent_magnitude":
            want = _per_walker(lambda q: jd.apparent_magnitude(
                q, model, jnp.asarray(z_grid), jnp.asarray(z_data), jnp.asarray(zhel), q["H0"],
                -0.11), p)
            got = td.apparent_magnitude(tp, model, zg, z_data, torch.as_tensor(zhel),
                                        tp["H0"][:, None], -0.11)
        else:
            want = _per_walker(lambda q: jd.h0_free_log_dl(
                q, model, jnp.asarray(z_grid), jnp.asarray(z_data), jnp.asarray(zhel)), p)
            got = td.h0_free_log_dl(tp, model, zg, z_data, torch.as_tensor(zhel))
        return want, got
    return case


def _omega_r_of():
    from cosmax.models.background import omega_r_of as jax_fn
    from cosmax_torch.models.background import omega_r_of as port_fn

    p = _walkers(3, 16)
    h = p["H0"] / 100.0
    return (np.asarray(jax_fn(jnp.asarray(h), jnp.asarray(p["Om"]))),
            port_fn(torch.as_tensor(h), torch.as_tensor(p["Om"])))


def _gl_integrate_01():
    from cosmax.ops.quadrature import gl_integrate_01 as jax_fn
    from cosmax_torch.ops.quadrature import gl_integrate_01 as port_fn

    a = np.random.default_rng(4).uniform(0.5, 3.0, (5, 1))
    want = jax_fn(lambda t: jnp.exp(-jnp.asarray(a) * t) * jnp.sin(3.0 * t), 24,
                  dtype=jnp.float64)
    ta = torch.as_tensor(a)
    got = port_fn(lambda t: torch.exp(-ta * t) * torch.sin(3.0 * t), 24, dtype=torch.float64,
                  device="cpu")
    return np.asarray(want), got


def _synthetic_sys_enabled():
    from cosmax.data import loaders as jl
    from cosmax_torch.data import loaders as tl

    seen = []
    for on in (True, False):
        with jl.use_synthetic_sys(on), tl.use_synthetic_sys(on):
            seen.append((jl.synthetic_sys_enabled(), tl.synthetic_sys_enabled()))
    seen.append((jl.synthetic_sys_enabled(), tl.synthetic_sys_enabled()))
    want, got = zip(*seen)
    return np.array(want, dtype=float), torch.tensor(got, dtype=torch.float64)


def _store_path():
    from cosmax.data import store_path as jax_fn
    from cosmax_torch.data import store_path as port_fn

    assert os.path.samefile(jax_fn(), port_fn())
    return np.zeros(1), torch.zeros(1, dtype=torch.float64)


def _constant(jax_mod, port_mod, name):
    def case():
        import importlib

        want = getattr(importlib.import_module(f"cosmax.{jax_mod}"), name)
        got = getattr(importlib.import_module(f"cosmax_torch.{port_mod}"), name)
        if isinstance(want, tuple) and isinstance(want[0], str):
            assert got == want
            return np.zeros(1), torch.zeros(1, dtype=torch.float64)
        return (np.atleast_1d(np.asarray(want, dtype=float)),
                torch.atleast_1d(torch.tensor(got, dtype=torch.float64)))
    return case


CASES = {
    **{f"{name}[{model}]": _sn_case(name, model)
       for name in ("sn_comoving_integral", "apparent_magnitude", "h0_free_log_dl")
       for model in MODELS},
    "omega_r_of": _omega_r_of,
    "gl_integrate_01": _gl_integrate_01,
    "synthetic_sys_enabled": _synthetic_sys_enabled,
    "store_path": _store_path,
    "THETA_100_PLANCK": _constant("likelihoods.priors", "likelihoods.priors", "THETA_100_PLANCK"),
    "DE_PARAMS": _constant("configs.presets", "configs.presets", "DE_PARAMS"),
    "ORH2_ACT": _constant("configs.presets", "configs.presets", "ORH2_ACT"),
    "GL_ORDER": _constant("likelihoods.fastmode", "likelihoods.fastmode", "GL_ORDER"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_helper_matches_the_jax_package(name):
    with jax.enable_x64(True):
        want, got = CASES[name]()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    got = got.numpy()
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("package", ["", "ops", "models", "likelihoods", "configs", "data",
                                     "samplers"])
def test_package_exports_the_jax_names(package):
    """Every name of a JAX package's ``__all__`` (but ``enable_x64``, which
    the port leaves out: it passes dtypes explicitly) is exported by the
    port's package of the same name; the preset registries hold the same
    names."""
    import importlib

    jax_pkg = importlib.import_module("cosmax" + (f".{package}" if package else ""))
    port_pkg = importlib.import_module("cosmax_torch" + (f".{package}" if package else ""))
    want = set(jax_pkg.__all__) - {"enable_x64"}
    assert want <= set(port_pkg.__all__), sorted(want - set(port_pkg.__all__))
    for name in want:
        assert hasattr(port_pkg, name), name
    if package == "configs":
        assert set(port_pkg.PRESETS) == set(jax_pkg.PRESETS)


def test_version_matches_the_jax_package():
    import cosmax.version
    import cosmax_torch

    assert cosmax_torch.__version__ == cosmax.version.__version__
