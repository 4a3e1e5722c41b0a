"""cosmax_torch.models.emu_core and linear_chi2's table cache against the
JAX package's emulator build.

* ``bary_vector`` against JAX's at random points and exactly at a node;
* ``svd_rank_factor``, ``tucker`` and ``compress`` on one f64 table: the
  same ranks, and a composed error within the tolerance;
* ``coeff_contract`` against JAX's on the same representation (the
  tensor train's own tests are in test_torch_w0wa.py);
* the on-disk table cache keeps wcdm and wzcdm apart with the in-memory
  finalize memo cleared first, so that the disk is really read.

f64 throughout; the JAX functions run un-jitted, vmapped over N_X points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmax.models import emu_core as jemu
from cosmax_torch.models import emu_core as temu
from cosmax_torch.models import linear_chi2 as tlc

N_X = 8  # every JAX evaluation in this file takes this many points


def _table():
    """A smooth [32, 32, 13] table over (Om, w0) with the tolerance the
    emulator holds it to: 1/E(z) of wzcdm at 13 redshifts."""
    axes = [temu.cheb_nodes(32, 0.1, 0.6), temu.cheb_nodes(32, -2.0, 0.0)]
    flat = temu.flatten_grid(axes)
    z = np.linspace(0.1, 2.5, 13)
    cubed = (1.0 + z) ** 3
    om, w0 = flat[:, :1], flat[:, 1:]
    rho = (2.0 * cubed / (1.0 + cubed)) ** (2.0 * (1.0 + w0))
    stacked = 1.0 / np.sqrt(om * cubed + (1.0 - om) * rho)
    return axes, stacked, 1e-6 * np.max(np.abs(stacked))


def test_cheb_nodes_and_weights_match():
    for n, lo, hi in ((32, 0.085, 0.615), (48, -2.06, 0.06)):
        np.testing.assert_array_equal(temu.cheb_nodes(n, lo, hi), jemu.cheb_nodes(n, lo, hi))
        np.testing.assert_array_equal(temu.bary_weights(n), jemu.bary_weights(n))
    axes = [np.arange(3.0), np.arange(4.0)]
    np.testing.assert_array_equal(temu.flatten_grid(axes), jemu.flatten_grid(axes))


def test_bary_vector_matches_jax_and_is_one_hot_at_a_node():
    nodes = temu.cheb_nodes(32, 0.085, 0.615)
    bw = temu.bary_weights(32)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.085, 0.615, N_X)
    x[3] = nodes[7]  # exactly on a node
    got = temu.bary_vector(torch.as_tensor(x), torch.as_tensor(nodes), torch.as_tensor(bw))
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(lambda v: jemu.bary_vector(v, jnp.asarray(nodes), jnp.asarray(bw)))(
            jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(got[3].numpy(), np.eye(32)[7])
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-12)
    for xi in (x[0], nodes[7]):
        np.testing.assert_array_equal(temu.bary_vector_np(xi, nodes), jemu.bary_vector_np(xi, nodes))


def test_svd_tucker_compress_match_jax():
    axes, stacked, tol = _table()
    a_t, b_t = temu.svd_rank_factor(stacked, tol)
    a_j, b_j = jemu.svd_rank_factor(stacked, tol)
    assert a_t.shape == a_j.shape and b_t.shape == b_j.shape  # the same rank
    np.testing.assert_allclose(a_t @ b_t, a_j @ b_j, rtol=0, atol=1e-12)
    assert np.max(np.abs(a_t @ b_t - stacked)) <= tol

    node_shape = [32, 32]
    table = a_t.reshape(32, 32, -1)
    with jax.enable_x64(True):
        f_j, c_j = jemu.tucker(table, node_shape, tol, b_t, stacked)
        rep_j = jemu.compress(table, node_shape, tol, b_t, stacked)
    f_t, c_t = temu.tucker(table, node_shape, tol, b_t, stacked)
    assert [u.shape for u in f_t] == [u.shape for u in f_j]  # the same ranks
    assert c_t.shape == c_j.shape
    rec = np.einsum("ir,js,rsk->ijk", f_t[0], f_t[1], c_t)
    assert temu.composed_err(rec, b_t, stacked) <= tol

    rep_t = temu.compress(table, node_shape, tol, b_t, stacked)
    assert rep_t[0] == rep_j[0] == "tucker"
    assert temu.eval_flops(rep_t) == jemu.eval_flops(rep_j)
    rec_j = np.einsum("ir,js,rsk->ijk", *[np.asarray(u) for u in rep_j[1]], np.asarray(rep_j[2]))
    np.testing.assert_allclose(rec, rec_j, rtol=0, atol=1e-12)


def test_coeff_contract_matches_jax_on_the_same_rep():
    axes, stacked, tol = _table()
    a, b = temu.svd_rank_factor(stacked, tol)
    rep = temu.compress(a.reshape(32, 32, -1), [32, 32], tol, b, stacked)
    rng = np.random.default_rng(1)
    xs = [rng.uniform(ax[0], ax[-1], N_X) for ax in axes]
    bw = temu.bary_weights(32)
    weights = [
        temu.bary_vector(torch.as_tensor(x), torch.as_tensor(ax), torch.as_tensor(bw))
        for x, ax in zip(xs, axes)
    ]
    for r in (rep, ("exact", a.reshape(32, 32, -1))):
        r_t = (r[0], [torch.as_tensor(u) for u in r[1]], torch.as_tensor(r[2])) \
            if r[0] == "tucker" else (r[0], torch.as_tensor(r[1]))
        got = temu.coeff_contract(weights, r_t).numpy()
        with jax.enable_x64(True):
            r_j = (r[0], [jnp.asarray(u) for u in r[1]], jnp.asarray(r[2])) \
                if r[0] == "tucker" else (r[0], jnp.asarray(r[1]))
            want = np.asarray(jax.vmap(lambda x0, x1: jemu.coeff_contract(
                [jemu.bary_vector(x0, jnp.asarray(axes[0]), jnp.asarray(bw)),
                 jemu.bary_vector(x1, jnp.asarray(axes[1]), jnp.asarray(bw))], r_j))(
                jnp.asarray(xs[0]), jnp.asarray(xs[1])))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12, err_msg=r[0])
        # and through the basis it interpolates the table within the contract
        exact = 1.0 / np.sqrt(
            xs[0][:, None] * (1 + np.linspace(0.1, 2.5, 13)) ** 3
            + (1 - xs[0][:, None]) * (2 * (1 + np.linspace(0.1, 2.5, 13)) ** 3
                                      / (1 + (1 + np.linspace(0.1, 2.5, 13)) ** 3))
            ** (2 * (1 + xs[1][:, None])))
        assert np.max(np.abs(got @ b - exact)) < 1e-4


def test_tensor_train_raises_naming_item_9():
    """The tensor train is ported (item 9): a 3-axis table too small for it
    to pay stays exact, as in the JAX package; a hand-made train
    contracts; the w0wacdm grid is the split one. What stays unported
    builds (items 9 and 9b)."""
    table = np.random.default_rng(0).standard_normal((3, 3, 3, 2))
    args = (table, [3, 3, 3], 1e-6, np.eye(2), table.reshape(27, 2))
    assert temu.tt(*args) is None and jemu.tt(*args) is None
    assert temu.compress(*args)[0] == "exact"
    cores = [np.ones((3, 1)), np.ones((1, 3, 1)), np.ones((1, 3, 1))]
    tail = np.array([[1.0, 2.0]])
    weights = [torch.full((2, 3), 1.0 / 3.0, dtype=torch.float64)] * 3
    got = temu.coeff_contract(weights, ("tt", (2, 0, 1), [torch.as_tensor(c) for c in cores],
                                        torch.as_tensor(tail)))
    np.testing.assert_allclose(got.numpy(), [[1.0, 2.0]] * 2, rtol=1e-15)
    assert temu.eval_flops(("tt", (0, 1, 2), cores, tail)) == jemu.eval_flops(
        ("tt", (0, 1, 2), cores, tail))
    from cosmax.models import linear_chi2 as jlc

    kind, halves = tlc._grid_spec("w0wacdm", None, {})
    jkind, jhalves = jlc._grid_spec("w0wacdm", None, {})
    assert kind == jkind == "split" and len(halves) == len(jhalves) == 2
    for (axes, _, tag, ref), (jaxes, _, jtag, jref) in zip(halves, jhalves):
        assert tag == jtag and ref == jref
        for ax, jax_ in zip(axes, jaxes):
            np.testing.assert_array_equal(ax, np.asarray(jax_))
    from cosmax_torch.configs import get_preset

    class Building(Exception):
        pass

    def building(*args, **kwargs):
        raise Building

    # fs8.fs8 in w0wacdm is no longer refused: it goes on to build its tables
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlc, "table_cached", building)
        mp.setattr(tlc, "_FINALIZE_MEMO", {})
        with pytest.raises(Building):
            get_preset("fs8.fs8", "w0wacdm", fast=True, device="cpu")


def test_table_cache_reads_back_and_can_be_off(tmp_path, monkeypatch):
    monkeypatch.setenv(temu.TABLE_CACHE_ENV, str(tmp_path))
    calls = []

    def build():
        calls.append(1)
        return np.arange(6.0).reshape(2, 3)

    first = temu.table_cached("t", ("k", 1), build)
    again = temu.table_cached("t", ("k", 1), build)
    np.testing.assert_array_equal(first, again)
    assert len(calls) == 1 and len(list(tmp_path.iterdir())) == 1
    temu.table_cached("t", ("k", 2), build)
    assert len(calls) == 2
    monkeypatch.setenv(temu.TABLE_CACHE_ENV, "off")
    assert temu.table_cache_path("t", ("k", 1)) is None


def test_table_cache_isolates_model_families(tmp_path, monkeypatch):
    """wcdm and wzcdm share the grid parameters ("Om", "w0"), so their
    nodes coincide on equal domains: the disk key must separate them by
    the model. One tag and key for both families, the finalize memo
    cleared, wcdm built first: the wzcdm term must read its own tables
    (the reference's test_table_cache_isolates_model_families ran with a
    warm memo, so it never read the disk)."""
    from cosmax_torch.models.background import e_of_z, expand_params

    monkeypatch.setenv(temu.TABLE_CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(tlc, "_FINALIZE_MEMO", {})
    z = torch.linspace(0.2, 2.0, 6, dtype=torch.float64)
    data = np.linspace(1.0, 0.5, 6)

    def make(model):
        def curve_fn(flat, to_params):
            p = to_params(torch.as_tensor(flat))
            return (1.0 / e_of_z(z, expand_params(p, 1), model)).numpy()

        return tlc.make_linear_chi2(model, curve_fn, "shared", "same-key", data, float(data @ data),
                                    "cpu", torch.float64)

    def direct(model, p):
        r = data - 1.0 / e_of_z(z, expand_params(p, 1), model).numpy()
        return (r * r).sum(-1)

    chi_w = make("wcdm")
    tlc._FINALIZE_MEMO.clear()
    chi_z = make("wzcdm")
    assert len(list(tmp_path.iterdir())) == 4  # base and Or tables per family
    p = dict(Om=torch.full((N_X,), 0.31, dtype=torch.float64),
             w0=torch.linspace(-1.4, -0.6, N_X, dtype=torch.float64))
    for model, chi in (("wcdm", chi_w), ("wzcdm", chi_z)):
        np.testing.assert_allclose(chi(p).numpy(), direct(model, p), rtol=0, atol=1e-6)
    # the families differ there, so a served copy would have failed above
    assert np.max(np.abs(direct("wcdm", p) - direct("wzcdm", p))) > 1e-3
