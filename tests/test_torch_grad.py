"""Gradients of the port against ``jax.grad`` of the JAX package's fits,
in f64 on the CPU.

* ``FitSpec.value_and_grad`` (the parity path's autograd; on the fast
  path the fused log-prob's value and autograd through the per-term fast
  path) and each term alone (``make_log_prob`` over one term) against
  ``jax.grad`` of the JAX fit's log-prob at the same theta: per parameter,
  max |dg| <= 1e-9 of that parameter's max |g| (GRAD_RTOL). Presets:
  ``bao.desi`` lcdm; ``bao.desi_cmb_des5y`` wzcdm (its dense DES5Y term,
  with the synthetic systematic covariance); ``cc.cc`` lcdm (the
  log-normalisation of the rescaled CC term); the fast flagship wzcdm with
  the JAX bundle carried across; the fast flagship w0wacdm on the 12-node
  split grid (``small_split_grid``), JAX's bundle carried across.
* The chi^2 kernel's backward, ``whitened_chi2_grad``, against autograd
  of the plain version (1e-12 relative), and the autograd Function with
  the plain version in the kernel's place: gradient and Hessian-vector
  product.
* The per-term path's split grid in float32 against f64 on a draw with
  walkers on both sides of the seam: finite on the same rows (each half
  sees the other's walkers at the seam).

The JAX gradients of a fit are one jitted program (whole and each term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cosmax.configs import get_preset as jax_preset
from cosmax.likelihoods.base import make_log_prob as jax_make_log_prob
from cosmax_torch.configs import get_preset
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods.base import autograd_value_and_grad, make_log_prob
from cosmax_torch.ops.kernels import whitened_chi2 as kmod
from tests.test_torch_fast import _jax_bundle as _jax_tucker_bundle
from tests.test_torch_w0wa_joint import _bundle, _jax_bundle_of, small_split_grid

F64 = torch.float64
N_THETA = 8
GRAD_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Split-grid builds are SVDs that gain little from BLAS threads and,
    beside other test processes, spin against each other; so do torch's
    intra-op threads on small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _thetas(bounds, seed, n=N_THETA, spread=0.05):
    rng = np.random.default_rng(seed)
    lo, hi = bounds[:, 0], bounds[:, 1]
    return 0.5 * (lo + hi) + spread * (hi - lo) * rng.standard_normal((n, len(lo)))


def _jax_grads(jfit, theta):
    """{"whole" | term name: [n, D]} of jax.grad of the JAX fit's log-prob,
    whole and each term alone, in one jitted f64 program."""
    fns = {"whole": jfit.log_prob()}
    fns.update({t.name: jax_make_log_prob(jfit.spec, [t], jfit.derive) for t in jfit.terms})
    with jax.enable_x64(True):
        prog = jax.jit(lambda th: {k: jax.vmap(jax.grad(f))(th) for k, f in fns.items()})
        return {k: np.asarray(v) for k, v in prog(jnp.asarray(theta)).items()}


def _port_grads(tfit, theta):
    th = torch.as_tensor(theta)
    out = {"whole": tfit.value_and_grad()(th)[1]}
    for t in tfit.terms:
        out[t.name] = autograd_value_and_grad(make_log_prob(tfit.spec, [t], tfit.derive))(th)[1]
    return {k: v.numpy() for k, v in out.items()}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        diff = np.max(np.abs(got[name] - w), axis=0)
        scale = np.max(np.abs(w), axis=0)
        assert np.all(np.isfinite(got[name])), name
        assert np.all(diff <= GRAD_RTOL * scale), (name, diff / np.where(scale > 0, scale, 1))


@pytest.mark.parametrize("name,model,opts", [
    ("bao.desi", "lcdm", {}),
    ("bao.desi_cmb_des5y", "wzcdm", {"synthetic_sys": True}),
    ("cc.cc", "lcdm", {}),
])
def test_parity_gradients_match_jax(name, model, opts):
    with jax.enable_x64(True):
        jfit = jax_preset(name, model, **opts)
    tfit = get_preset(name, model, device="cpu", dtype=F64, **opts)
    theta = _thetas(tfit.spec.bounds, seed=3)
    _assert_grads(_port_grads(tfit, theta), _jax_grads(jfit, theta))


def test_fast_flagship_gradients_match_jax():
    """wzcdm, both packages on JAX's bundle."""
    with jax.enable_x64(True):
        jfit = jax_preset("bao.desi_cmb_des5y", "wzcdm", fast=True)
    tfit = get_preset("bao.desi_cmb_des5y", "wzcdm", fast=True, device="cpu", dtype=F64)
    bundle_from_numpy(tfit.terms[0].meta["linear_chi2"].bundle, *_jax_tucker_bundle(jfit))
    theta = _thetas(tfit.spec.bounds, seed=4)
    _assert_grads(_port_grads(tfit, theta), _jax_grads(jfit, theta))


def _split_thetas(fit, seed):
    """Walkers on both sides of the seam s = w0 + wa = 0."""
    theta = _thetas(fit.spec.bounds, seed)
    names = list(fit.spec.names)
    i_w0, i_wa = names.index("w0"), names.index("wa")
    theta[: N_THETA // 2, i_wa] = 0.3 - theta[: N_THETA // 2, i_w0]  # s = 0.3: half 1
    return theta


def test_fast_w0wacdm_gradients_match_jax_on_the_small_split_grid():
    with small_split_grid():
        with jax.enable_x64(True):
            jfit = jax_preset("bao.desi_cmb_des5y", "w0wacdm", fast=True)
        tfit = get_preset("bao.desi_cmb_des5y", "w0wacdm", fast=True, device="cpu", dtype=F64)
        bundle_from_numpy(_bundle(tfit), *_jax_bundle_of(jfit))
        theta = _split_thetas(tfit, seed=5)
        _assert_grads(_port_grads(tfit, theta), _jax_grads(jfit, theta))
        # float32: finite on the same rows (the bench draw's half 0 and a
        # half-1 draw), within 1e-3 of f64 per parameter
        t32 = get_preset("bao.desi_cmb_des5y", "w0wacdm", fast=True, device="cpu")
        th = _split_thetas(t32, seed=6)
        g32 = t32.value_and_grad()(torch.as_tensor(th, dtype=torch.float32))[1].double()
        g64 = tfit.value_and_grad()(torch.as_tensor(th))[1]
        assert torch.isfinite(g32).all() and torch.isfinite(g64).all()
        gap = (g32 - g64).abs().amax(0) / g64.abs().amax(0)
        assert float(gap.max()) < 1e-3, gap


def _linv_delta(n=37, w=5, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    linv = np.linalg.inv(np.linalg.cholesky(a @ a.T / n + np.eye(n)))
    return torch.as_tensor(np.tril(linv)), torch.as_tensor(rng.standard_normal((w, n)))


def test_chi2_backward_formula_matches_autograd():
    linv, delta = _linv_delta()
    g = torch.linspace(0.5, 2.0, delta.shape[0], dtype=F64)
    d = delta.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((kmod.whitened_chi2_reference(linv, d) * g).sum(), d)
    got = kmod.whitened_chi2_grad(linv, delta, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0)


def test_chi2_function_gradient_and_hessian(monkeypatch):
    """The autograd Function with the plain version in the kernel's
    place: its gradient and a Hessian-vector product (double backward
    through the backward) equal autograd of the plain version."""
    monkeypatch.setattr(kmod, "_launch", kmod.whitened_chi2_reference)
    linv, delta = _linv_delta(seed=1)
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(delta.shape))
    out = {}
    for label, fn in (("function", kmod._WhitenedChi2.apply),
                      ("plain", kmod.whitened_chi2_reference)):
        d = delta.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(linv, d).sum(), d, create_graph=True)
        (hv,) = torch.autograd.grad((g * v).sum(), d)
        out[label] = (g.detach(), hv)
    for a, b in zip(out["function"], out["plain"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    hv_exact = 2.0 * (v @ linv.T) @ linv
    np.testing.assert_allclose(out["function"][1].numpy(), hv_exact.numpy(), rtol=1e-12)
