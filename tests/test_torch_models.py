"""cosmax_torch.models against cosmax.models in f64 for all four dark-
energy models: E(z), distances, the sound horizon and the comoving
distance to z*, to 1e-12 relative. Parameters are a seeded walker batch;
the JAX side runs un-jitted and vmapped over it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.models import background as jb
from cosmax.models import distances as jd
from cosmax.models import recombination as jr
from cosmax.ops.quadrature import trapz_grid_weights
from cosmax_torch.models import background as tb
from cosmax_torch.models import distances as td
from cosmax_torch.models import recombination as tr

MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")
Z = np.array([0.295, 0.51, 0.706, 0.934, 1.321, 1.484, 2.33])
RTOL = 1e-12


def _params(seed, radiation):
    rng = np.random.default_rng(seed)
    w = 4
    p = dict(
        H0=rng.uniform(60, 75, w),
        Om=rng.uniform(0.25, 0.4, w),
        Obh2=rng.uniform(0.020, 0.024, w),
        w0=rng.uniform(-1.3, -0.6, w),
        wa=rng.uniform(-1.0, 0.5, w),
    )
    if radiation:
        p["Or"] = 4.15e-5 / (p["H0"] / 100.0) ** 2
    return p


def _jax_batch(fn, p):
    """vmap ``fn(scalar params)`` over the walker batch in f64, no jit."""
    with jax.enable_x64(True):
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        return np.asarray(jax.vmap(fn)(pj))


def _torch(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("radiation", [False, True])
def test_e_of_z(model, radiation):
    p = _params(0, radiation)
    z = np.linspace(0.0, 3.0, 50)
    want = _jax_batch(lambda q: jb.e_of_z(jnp.asarray(z), q, model), p)
    got = tb.e_of_z(torch.as_tensor(z), tb.expand_params(_torch(p), 1), model).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("model", MODELS)
def test_distances(model):
    p = _params(1, radiation=False)
    tp = _torch(p)
    zt = torch.as_tensor(Z)
    grid, weights = trapz_grid_weights(Z, 250)

    def jax_all(q):
        dh = jd.hubble_distance(jnp.asarray(Z), q, model)
        dm = jd.comoving_distance_trapz(q, model, jnp.asarray(grid), jnp.asarray(weights))
        return jnp.stack([
            dh,
            dm,
            jd.volume_distance(jnp.asarray(Z), dh, dm),
            jd.comoving_distance_gl(jnp.asarray(Z), q, model, order=64),
            jd.make_prefix_comoving_integral(Z, model, order=8)(q),
        ])

    want = _jax_batch(jax_all, p)
    dh = td.hubble_distance(zt, tp, model)
    dm = td.comoving_distance_trapz(tp, model, torch.as_tensor(grid), torch.as_tensor(weights))
    prefix = td.make_prefix_comoving_integral(Z, model, "cpu", torch.float64, order=8)
    got = torch.stack([
        dh,
        dm,
        td.volume_distance(zt, dh, dm),
        td.comoving_distance_gl(zt, tp, model, order=64),
        prefix(tp),
    ], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("model", MODELS)
def test_sound_horizon_and_distance_to_zstar(model):
    p = _params(2, radiation=True)
    tp = _torch(p)

    def jax_all(q):
        wm = q["Om"] * (q["H0"] / 100.0) ** 2
        zs = jr.z_star(q["Obh2"], wm)
        zh = jr.z_star_hu(q["Obh2"], wm)
        return jnp.stack([
            zs,
            zh,
            jr.sound_horizon(zs, q, model, q["H0"], q["Obh2"], order=48),
            jr.comoving_distance_to(zs, q, model, q["H0"], order=24),
            jr.sound_horizon(zh, q, model, q["H0"], q["Obh2"], order=48, o_gamma_h2=2.4729e-5),
        ])

    want = _jax_batch(jax_all, p)
    wm = tp["Om"] * (tp["H0"] / 100.0) ** 2
    zs = tr.z_star(tp["Obh2"], wm)
    zh = tr.z_star_hu(tp["Obh2"], wm)
    got = torch.stack([
        zs,
        zh,
        tr.sound_horizon(zs, tp, model, tp["H0"], tp["Obh2"], order=48),
        tr.comoving_distance_to(zs, tp, model, tp["H0"], order=24),
        tr.sound_horizon(zh, tp, model, tp["H0"], tp["Obh2"], order=48, o_gamma_h2=2.4729e-5),
    ], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_negative_e2_gives_nan_not_an_exception():
    # Om far outside any prior box with a phantom w0: E^2 < 0 at high z
    p = {"Om": torch.tensor([0.3, -2.0]), "w0": torch.tensor([-1.0, -3.0])}
    e = tb.e_of_z(torch.linspace(0.0, 3.0, 5), tb.expand_params(p, 1), "wcdm")
    assert bool(torch.isfinite(e[0]).all()) and bool(torch.isnan(e[1]).any())
