"""cosmax_torch.ops against cosmax.ops: quadrature primitives in f64 and
the whitened chi^2 (plain version and wrapper) in f32.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against the plain version there. Here the wrapper takes the plain
version because the tensors lie on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate
import torch

from cosmax.ops import quadrature as jq
from cosmax.ops import linalg as jl
from cosmax.ops.linalg import chi2_from_whitener as jax_chi2
from cosmax.ops.pallas.chi2 import whitened_chi2_pallas
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.ops import linalg as tl
from cosmax_torch.ops import quadrature as tq
from cosmax_torch.ops.kernels import whitened_chi2 as kmod


def test_whitening_operator_and_log_det_match():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 40))
    cov = a @ a.T + 40 * np.eye(40)
    linv = tl.whitening_operator(cov)
    np.testing.assert_array_equal(linv, jl.whitening_operator(cov))
    assert np.all(np.triu(linv, 1) == 0.0)
    np.testing.assert_allclose(linv @ cov @ linv.T, np.eye(40), atol=1e-12)
    assert tl.log_det_cov(cov) == jl.log_det_cov(cov)


def test_gl_nodes_match():
    for order in (8, 24, 48, 64):
        t_j, w_j = jq.gl_nodes_01(order)
        t_t, w_t = tq.gl_nodes_01(order)
        np.testing.assert_allclose(t_t, t_j, rtol=1e-12, atol=0)
        np.testing.assert_allclose(w_t, w_j, rtol=1e-12, atol=0)
        assert abs(w_t.sum() - 1.0) < 1e-12


def test_trapz_grid_weights_match():
    z = np.array([0.295, 0.51, 0.706, 0.934, 1.321, 1.484, 2.33])
    for n_base, dynamic in ((250, True), (300, True), (40, False)):
        g_j, w_j = jq.trapz_grid_weights(z, n_base, dynamic=dynamic)
        g_t, w_t = tq.trapz_grid_weights(z, n_base, dynamic=dynamic)
        np.testing.assert_array_equal(g_t, g_j)
        np.testing.assert_array_equal(w_t, w_j)
        # and the rule integrates like np.trapz on the unpadded grid
        f = lambda x: 1.0 / np.sqrt(0.3 * (1 + x) ** 3 + 0.7)
        got = np.sum(f(g_t) * w_t, axis=1)
        m = max(n_base, int(n_base * z[-1])) if dynamic else n_base
        x = np.linspace(0.0, z[-1], m)
        np.testing.assert_allclose(got[-1], np.trapezoid(f(x), x), rtol=1e-12)


def test_cumtrapz_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 2.3, 1000)
    y = rng.standard_normal((3, 1000))
    got = tq.cumtrapz(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jq.cumtrapz(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    ref = scipy.integrate.cumulative_trapezoid(y, x, initial=0)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_interp_matches_jnp_interp_including_endpoints():
    rng = np.random.default_rng(1)
    xp = np.linspace(0.0, 2.26, 1000)
    fp = np.cumsum(rng.random((2, 1000)), axis=1)
    x = np.concatenate([rng.uniform(0.0, 2.26, 200), [0.0, xp[500], 2.26], [-0.1, 2.5]])
    idx, t = tq.interp_weights(x, xp)
    got = tq.interp_apply(torch.as_tensor(fp), torch.as_tensor(idx), torch.as_tensor(t)).numpy()
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jnp.interp(x, xp, row)) for row in fp])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("w, n, block_w, block_n", [(64, 100, 32, 64), (19, 37, 16, 16)])
def test_plain_chi2_matches_jax_and_pallas(w, n, block_w, block_n):
    """The JAX tests' own shapes (tests/test_pallas_ops.py), f32, rtol 5e-5."""
    rng = np.random.default_rng(w)
    a = rng.normal(size=(n, n))
    linv = tl.whitening_operator(a @ a.T + n * np.eye(n)).astype(np.float32)
    delta = rng.normal(size=(w, n)).astype(np.float32)
    dense = np.asarray(jax_chi2(jnp.asarray(linv), jnp.asarray(delta)))
    pallas = np.asarray(
        whitened_chi2_pallas(
            jnp.asarray(linv), jnp.asarray(delta),
            block_w=block_w, block_n=block_n, interpret=True,
        )
    )
    c = constants_from_numpy(dict(linv=linv, delta=delta), "cpu")
    plain = kmod.whitened_chi2_reference(c["linv"], c["delta"]).numpy()
    before = kmod.LAUNCHES
    wrapped = tl.chi2_from_whitener(c["linv"], c["delta"]).numpy()
    assert kmod.LAUNCHES == before  # CPU tensors never reach the kernel
    assert plain.shape == wrapped.shape == (w,)
    np.testing.assert_allclose(plain, dense, rtol=5e-5)
    np.testing.assert_allclose(plain, pallas, rtol=5e-5)
    np.testing.assert_array_equal(wrapped, plain)


def test_nan_row_stays_in_its_row():
    rng = np.random.default_rng(2)
    n = 13
    a = rng.normal(size=(n, n))
    linv = torch.as_tensor(np.ascontiguousarray(tl.whitening_operator(a @ a.T + n * np.eye(n))))
    delta = torch.as_tensor(rng.normal(size=(5, n)))
    delta[2, 4] = float("nan")
    out = tl.chi2_from_whitener(linv, delta)
    assert torch.isnan(out[2]) and bool(torch.isfinite(out[[0, 1, 3, 4]]).all())


def test_wrapper_input_checks():
    linv = torch.eye(4)
    with pytest.raises(ValueError, match="delta"):
        kmod.whitened_chi2(linv, torch.zeros(4))
    with pytest.raises(ValueError, match="linv must be"):
        kmod.whitened_chi2(torch.eye(3), torch.zeros(2, 4))
    meta = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        kmod.whitened_chi2(torch.eye(4, device="meta"), meta)
    with pytest.raises(ValueError, match="linv on"):
        kmod.whitened_chi2(linv, meta)


def test_constants_refuse_a_full_whitener():
    with pytest.raises(ValueError, match="lower-triangular"):
        constants_from_numpy(dict(linv=np.ones((3, 3))), "cpu")
    c = constants_from_numpy(
        dict(linv=np.asfortranarray(np.tril(np.ones((3, 3)))), idx=np.arange(3)),
        "cpu", torch.float32,
    )
    assert c["linv"].is_contiguous() and c["linv"].dtype == torch.float32
    assert c["idx"].dtype == torch.int64
