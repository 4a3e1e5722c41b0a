"""The port's w0wacdm fast path (the split grid on s = w0 + wa, the tensor
train, the fused log-prob's split-grid branch) against the JAX package.

* ``tt``, ``compress`` and the TT ``coeff_contract`` on a small seeded
  table: the same axis order, ranks and representation as the JAX
  package, contractions equal to 1e-12;
* the w0wacdm flagship built by each package: the same axis order and
  bond ranks per half (within one), per-term chi^2 within the truncation
  contract 1e-3 + 2e-4 sqrt(chi^2), at walkers in both halves; and with
  the JAX bundle carried across (``interop.bundle_from_numpy``) within
  1e-9 relative in f64;
* ``fused_log_prob_reference`` over the packed buffers against
  ``make_log_prob`` over the fast terms, 1e-10 relative in f64, on 70
  walkers over both halves, bad rows -inf (a port of
  ``test_megakernel_blocked_log_prob_matches_vmap``);
* a port of ``test_w0wacdm_seam_continuity`` (tests/test_linear_chi2.py)
  on the flagship's emulated SN and BAO terms: chi^2 and its gradient,
  through torch.autograd, across s = 0;
* the split kernel's numerics on the CPU: its sweep as block products in
  3xTF32 (each operand split into two TF32 parts, rounded to nearest with
  ties away, as ``cvt.rna.tf32.f32``) within 2e-5 of max|logp| of the f64
  plain version; on a model of the tensor cores' truncating f32 adds,
  bao.desi holds the card's limit against the f32 plain version with the
  kernel's per-slice flush and breaks it without; and the grouping by
  half, through the plain version: on a batch whose walkers alternate
  halves and on one all in half 1, each
  walker's logp is the one it gets alone; bonds padded with zeros to the
  block products' least r_in leave logp as it was;
* the w0wacdm presets outside the flagship family build and pack (on a
  reduced split grid; tests/test_torch_w0wa_joint.py holds them against
  the JAX package).

The CUDA kernel runs only on a card (``chip_smoke.py`` phase 12 holds it
against the plain version there); here the wrapper takes the plain
version because the tensors lie on the CPU. One flagship build per
package (module fixture); every JAX evaluation takes N_THETA points."""

import inspect
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cosmax.configs import get_preset as jax_preset
from cosmax.models import emu_core as jemu
from cosmax_torch.configs import get_preset
from cosmax_torch.interop import bundle_from_numpy
from cosmax_torch.likelihoods.base import make_log_prob
from cosmax_torch.models import emu_core as temu
from cosmax_torch.ops.kernels import fused_log_prob as fl

F64 = torch.float64
N_THETA = 16
FLAGSHIP = ("bao.desi_cmb_des5y", "w0wacdm")


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """The tensor-train builds are SVDs that gain little from BLAS
    threads; beside other test processes (pytest-xdist), threaded SVDs
    spin against each other and take ten times longer."""
    with threadpool_limits(1):
        yield


def _thetas(bounds, names, seed, n=N_THETA):
    """Half the walkers near the box centre (s = w0 + wa ~ -1.5, half 0),
    half uniform over the box with s > 0 (half 1)."""
    rng = np.random.default_rng(seed)
    lo, hi = bounds[:, 0], bounds[:, 1]
    near = 0.5 * (lo + hi) + 0.05 * (hi - lo) * rng.standard_normal((n // 2, len(lo)))
    box = lo + (hi - lo) * rng.uniform(0.02, 0.98, (64 * n, len(lo)))
    box = box[box[:, names.index("w0")] + box[:, names.index("wa")] > 0.0][:n - n // 2]
    return np.concatenate([near, box])


def _jax_bundle(jfit):
    """The JAX fast preset's finalized bundle as numpy: the arguments of
    ``bundle_from_numpy``."""
    jb = inspect.getclosurevars(jfit.terms[0].chi2).nonlocals["bundle"]
    kind, halves = jb.finalized()
    out = []
    for h in halves:
        _, perm, cores, tail = h["rep"]
        out.append(dict(axes=[np.asarray(a) for a in h["axes"]], bw=np.asarray(h["bw"]),
                        rep=("tt", perm, [np.asarray(g) for g in cores], np.asarray(tail))))
    windows = {key[0]: handle.per_half for key, (_, handle) in jb.regs.items()}
    return kind, out, windows


@pytest.fixture(scope="module")
def flagship():
    with jax.enable_x64(True):
        jfit = jax_preset(*FLAGSHIP, fast=True)
        theta = _thetas(jfit.spec.bounds, list(jfit.spec.names), seed=0)
        jchi = {k: np.asarray(v) for k, v in
                jax.jit(jax.vmap(jfit.chi2_breakdown()))(jnp.asarray(theta)).items()}
    tfit = get_preset(*FLAGSHIP, fast=True, device="cpu", dtype=F64)
    return dict(jfit=jfit, tfit=tfit, theta=theta, jchi=jchi)


def _smooth_table(n=12, r=12):
    """A smooth [n, n, n, r] table on Chebyshev nodes of (s, wa, Om): the
    CPL 1/E(z) at r redshifts. Its tensor train pays, in the axis order
    (Om, wa, s)."""
    axes = [temu.cheb_nodes(n, -3.0, 0.0), temu.cheb_nodes(n, -2.0, 1.0),
            temu.cheb_nodes(n, 0.1, 0.6)]
    s, wa, om = (g[..., None] for g in np.meshgrid(*axes, indexing="ij"))
    opz = 1.0 + np.linspace(0.1, 2.5, r)
    rho = np.exp(3.0 * (1.0 + s) * np.log(opz) - 3.0 * wa * (opz - 1.0) / opz)
    return axes, 1.0 / np.sqrt(om * opz**3 + (1.0 - om) * rho)


def test_tt_compress_contract_match_jax():
    axes, table = _smooth_table()
    shape = [len(ax) for ax in axes]
    ref = table.reshape(-1, table.shape[-1])
    tol = 1e-6 * np.max(np.abs(table))
    proj = np.eye(table.shape[-1])
    perm, cores, tail = temu.tt(table, shape, tol, proj, ref)
    with jax.enable_x64(True):
        jperm, jcores, jtail = jemu.tt(table, shape, tol, proj, ref)
        jrep = jemu.compress(table, shape, tol, proj, ref)
    assert perm == tuple(jperm) == (2, 1, 0)
    assert [c.shape for c in cores] == [c.shape for c in jcores]
    assert tail.shape == jtail.shape
    rep = temu.compress(table, shape, tol, proj, ref)
    assert rep[0] == jrep[0] == "tt"
    assert temu.eval_flops(rep) == jemu.eval_flops(jrep)

    rng = np.random.default_rng(3)
    xs = [rng.uniform(ax[0], ax[-1], 64) for ax in axes]
    xs[2][:3] = axes[2][[0, 5, 11]]  # on a node: the one-hot weights
    bw = temu.bary_weights(len(axes[0]))
    weights = [temu.bary_vector(torch.as_tensor(x), torch.as_tensor(ax), torch.as_tensor(bw))
               for x, ax in zip(xs, axes)]
    rep_t = ("tt", perm, [torch.as_tensor(c) for c in cores], torch.as_tensor(tail))
    got = temu.coeff_contract(weights, rep_t).numpy()
    with jax.enable_x64(True):
        jrep_np = ("tt", tuple(jperm), [jnp.asarray(c) for c in cores], jnp.asarray(tail))
        want = np.asarray(jax.vmap(lambda a, b, c: jemu.coeff_contract(
            [jemu.bary_vector(x, jnp.asarray(ax), jnp.asarray(bw))
             for x, ax in zip((a, b, c), axes)], jrep_np))(*map(jnp.asarray, xs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # walker chunks give the same rows
    temu_bytes = temu.TT_TEMP_BYTES
    try:
        temu.TT_TEMP_BYTES = 8 * 7 * max(c.shape[0] * c.shape[-1] for c in cores[1:])
        chunked = temu.coeff_contract(weights, rep_t).numpy()
    finally:
        temu.TT_TEMP_BYTES = temu_bytes
    np.testing.assert_array_equal(chunked, got)


def test_flagship_ranks_match_jax(flagship):
    tkind, thalves = flagship["tfit"].terms[0].meta["linear_chi2"].bundle.finalized()
    jkind, jhalves, _ = _jax_bundle(flagship["jfit"])
    assert tkind == jkind == "split"
    for th, jh in zip(thalves, jhalves):
        assert th["rep"][0] == jh["rep"][0] == "tt"
        assert th["rep"][1] == tuple(jh["rep"][1])
        t_bonds = [g.shape[-1] for g in th["rep"][2]]
        j_bonds = [g.shape[-1] for g in jh["rep"][2]]
        assert all(abs(a - b) <= 1 for a, b in zip(t_bonds, j_bonds)), (t_bonds, j_bonds)
        for ax_t, ax_j in zip(th["axes"], jh["axes"]):
            np.testing.assert_allclose(ax_t, ax_j, rtol=1e-15, atol=0)


def test_flagship_own_bundles_within_the_truncation_contract(flagship):
    got = flagship["tfit"].chi2_breakdown()(torch.as_tensor(flagship["theta"]))
    assert set(got) == set(flagship["jchi"]) == {"bao", "cmb_desi", "sn"}
    for name, want in flagship["jchi"].items():
        tol = 1e-3 + 2e-4 * np.sqrt(np.maximum(want, 0.0))
        assert np.all(np.abs(got[name].numpy() - want) <= tol), name


def test_flagship_with_the_jax_bundle_carried_across(flagship):
    tfit = get_preset(*FLAGSHIP, fast=True, device="cpu", dtype=F64)
    bundle_from_numpy(tfit.terms[0].meta["linear_chi2"].bundle, *_jax_bundle(flagship["jfit"]))
    got = tfit.chi2_breakdown()(torch.as_tensor(flagship["theta"]))
    for name, want in flagship["jchi"].items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-9, atol=0, err_msg=name)


def test_fused_plain_matches_make_log_prob_at_70_walkers(flagship):
    """Port of test_megakernel_blocked_log_prob_matches_vmap on the split
    grid: each walker's own half only, against the per-term path's
    select of both; bad walkers touch no other row."""
    tfit = flagship["tfit"]
    names = list(tfit.spec.names)
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, names, seed=1, n=70))
    s = theta[:, names.index("w0")] + theta[:, names.index("wa")]
    assert int((s <= 0).sum()) == 35 and int((s > 0).sum()) == 35
    packed = fl.pack(tfit)
    assert packed.hdr["H_SPLIT"] == 1 and len(packed.halves) == 2
    before = fl.LAUNCHES
    fused = fl.fused_log_prob(packed, theta)
    assert fl.LAUNCHES == before  # CPU tensors never reach the kernel
    terms = make_log_prob(tfit.spec, tfit.terms, tfit.derive)(theta)
    assert fused.shape == (70,) and bool(torch.isfinite(fused).all())
    np.testing.assert_allclose(fused.numpy(), terms.numpy(), rtol=1e-10, atol=0)

    bad = torch.cat([theta, theta[:4].clone()])
    bad[70, 2] = 0.95  # Om beyond its bound (0.1, 0.6)
    bad[71, 0] = float("nan")
    bad[72, names.index("w0")] = float("nan")  # s = NaN: half 1, then -inf
    bad[73, names.index("wa")] = tfit.spec.bounds[names.index("wa"), 1]  # on the edge
    lp = fl.fused_log_prob_reference(packed, bad)
    assert bool(torch.all(lp[70:] == -torch.inf))
    np.testing.assert_allclose(lp[:70].numpy(), fused.numpy(), rtol=1e-12, atol=0)

    ops0, prod0, nbytes = fl.work_per_walker(packed, 0)
    ops1, prod1, _ = fl.work_per_walker(packed, 1)
    assert nbytes == 4 * (len(names) + 1)
    # the TT sweep of each half, as emu_core.eval_flops counts it; the
    # products with r_in > 1 (the tensor cores' share) 2 n r_in r each
    _, halves = tfit.terms[0].meta["linear_chi2"].bundle.finalized()
    for ops, prod, half in ((ops0, prod0, halves[0]), (ops1, prod1, halves[1])):
        total = ops + prod
        assert temu.eval_flops(half["rep"]) < total < temu.eval_flops(half["rep"]) + 6000
        cores = half["rep"][2]
        assert prod == sum(2 * g.shape[0] * g.shape[1] * g.shape[2] for g in cores[1:])


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: the bit pattern of cvt.rna.tf32.f32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _sweep(packed, h, coords, product):
    """The split kernel's sweep of half ``h`` in float32, from the packed
    device buffer: the first step per walker, each later step
    ``product(a, g)`` with A[b, (m, p)] = w_m(b) v_b[p] formed in f32 and
    G [n r_in, r]; then a = v^T tail."""
    lay, buf, dev = packed.halves[h], packed.buf, packed.dev
    n_nodes = packed.hdr["H_N1"]
    bw = buf[packed.hdr["H_OFF_BW1"]:packed.hdr["H_OFF_BW1"] + n_nodes]
    r_prev, v = 1, None
    for i in range(3):
        n, r = lay[f"T_N{i}"], lay[f"T_R{i + 1}"]
        k, kp, np8 = n * r_prev, -(-n * r_prev // fl.KSLICE) * fl.KSLICE, -(-r // 8) * 8
        g = dev[lay[f"T_G{i}"]:lay[f"T_G{i}"] + kp * np8].reshape(kp, np8)[:k, :r]
        nodes = buf[lay[f"T_AX{i}"]:lay[f"T_AX{i}"] + n]
        w = temu.bary_vector(coords[lay[f"T_PERM{i}"]], nodes, bw)
        if i == 0:
            v = w @ g
        else:
            v = product((w[:, :, None] * v[:, None, :]).reshape(-1, k), g)
        r_prev = r
    tail = dev[lay["T_TAIL"]:lay["T_TAIL"] + r_prev * 4 * lay["T_NQ"]].reshape(r_prev, -1)
    return v @ tail


def _tf32_product(a, g, passes):
    """a g in 3xTF32 (``passes`` 3: a_lo b_hi + a_hi b_lo + a_hi b_hi) or
    in one TF32 pass, each pass an f32 matmul."""
    a_hi, g_hi = _tf32(a), _tf32(g)
    v = a_hi @ g_hi
    if passes == 3:
        v = _tf32(a - a_hi) @ g_hi + a_hi @ _tf32(g - g_hi) + v
    return v


def test_split_sweep_in_3xtf32_keeps_f32_accuracy(flagship, monkeypatch):
    """The kernel's tensor-core sweep, emulated: 3xTF32 stays within 2e-5
    of max|logp| of the f64 plain version on the 70 walkers over both
    halves (one TF32 pass, printed beside it, is not asserted)."""
    tfit = flagship["tfit"]
    names = list(tfit.spec.names)
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, names, seed=1, n=70))
    packed = fl.pack(tfit)
    want = fl.fused_log_prob_reference(packed, theta).numpy()
    p32 = replace(packed, buf=packed.buf.float(), dev=packed.dev.float())
    assert bool(np.isfinite(want).all())
    scale = np.max(np.abs(want))
    near = slice(0, 35)  # the bench-like walkers of half 0, |logp| far smaller
    errs = {}
    for passes in (3, 1):
        monkeypatch.setattr(fl, "_tt_coeff", lambda p, h, c: _sweep(
            p, h, c, lambda a, g: _tf32_product(a, g, passes)))
        got = fl.fused_log_prob_reference(p32, theta.float()).double().numpy()
        err = np.abs(got - want)
        errs[passes] = (err.max() / scale, err[near].max() / np.max(np.abs(want[near])))
    print(f"3xTF32 sweep vs f64: {errs[3][0]:.3e} of max|logp| ({errs[3][1]:.3e} on the 35 "
          f"half-0 walkers of their own); one TF32 pass: {errs[1][0]:.3e} ({errs[1][1]:.3e})")
    assert errs[3][0] <= 2e-5 and errs[3][1] <= 2e-5, errs


# The tensor cores' f32 adds, modelled: an mma's eight TF32 products are
# exact; they and the accumulator are aligned to the largest of the nine,
# cut toward zero to MMA_BITS bits below its leading bit, summed, and the
# sum is cut toward zero to MMA_BITS bits. The adder's width is not
# published: with 22 bits the model drifts over a whole K as much as an
# H100 was measured to without the per-slice flush (PERF.md); with 24
# bits it drifts several times less.
MMA_BITS = 22


def _cut(x, like):
    """x cut toward zero to MMA_BITS bits below the leading bit of |like|."""
    q = torch.ldexp(torch.ones_like(x), torch.frexp(like).exponent - MMA_BITS)
    return torch.trunc(x / q) * q


def _mma(c, a, b):
    """c + a b of one m16n8k8 TF32 mma, as modelled above: c [B, N] f32,
    a [B, 8] and b [8, N] TF32 values."""
    terms = torch.cat([c.double()[..., None], a.double()[:, None, :] * b.double().T[None]], -1)
    s = _cut(terms, terms.abs().amax(-1, keepdim=True)).sum(-1)
    return _cut(s, s).float()


def _mma_product(a, g, flush):
    """a g as the kernel runs it, on the model of the tensor cores: 3xTF32
    over k-steps of 8 (a_lo b_hi, a_hi b_lo, a_hi b_hi, each an mma), K
    padded with zeros to slices of KSLICE rows whose sums start from zero
    and are added to the accumulators in rounded f32 (``flush``, as the
    kernel does), or accumulated in the mma over the whole K."""
    kp = -(-a.shape[1] // fl.KSLICE) * fl.KSLICE
    a = torch.nn.functional.pad(a, (0, kp - a.shape[1]))
    g = torch.nn.functional.pad(g, (0, 0, 0, kp - g.shape[0]))
    a_hi, g_hi = _tf32(a), _tf32(g)
    a_lo, g_lo = _tf32(a - a_hi), _tf32(g - g_hi)
    v = torch.zeros(a.shape[0], g.shape[1])
    for k0 in range(0, kp, fl.KSLICE):
        part = torch.zeros_like(v) if flush else v
        for kk in range(k0, k0 + fl.KSLICE, 8):
            ks = slice(kk, kk + 8)
            for x, y in ((a_lo, g_hi), (a_hi, g_lo), (a_hi, g_hi)):
                part = _mma(part, x[:, ks], y[ks])
        v = v + part if flush else part
    return v


def test_split_sweep_flushes_the_tensor_cores_truncating_sums(monkeypatch):
    """On the tensor-core model, bao.desi in w0wacdm (where the card
    showed the drift) at 1,024 bench walkers, held as phase 12 of
    chip_smoke.py holds the kernel, against the f32 plain version at 1e-4
    of max|logp|: the kernel's per-slice flush passes, and the mma
    accumulating over the whole K fails."""
    fit = get_preset("bao.desi", "w0wacdm", fast=True, device="cpu", dtype=F64)
    packed = fl.pack(fit)
    p32 = replace(packed, buf=packed.buf.float(), dev=packed.dev.float())
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    rng = np.random.default_rng(7)
    walkers = 0.5 * (lo + hi) + 0.05 * (hi - lo) * rng.standard_normal((1024, len(lo)))
    theta = torch.as_tensor(walkers.astype(np.float32))
    want = fl.fused_log_prob_reference(p32, theta)
    assert bool(torch.isfinite(want).all())
    scale = float(want.abs().max())
    errs = {}
    for flush in (True, False):
        monkeypatch.setattr(fl, "_tt_coeff", lambda p, h, c: _sweep(
            p, h, c, lambda a, g: _mma_product(a, g, flush)))
        got = fl.fused_log_prob_reference(p32, theta)
        errs[flush] = float((got - want).abs().max()) / scale
    print(f"tensor-core model ({MMA_BITS} bits) vs the f32 plain version: {errs[True]:.3e} of "
          f"max|logp| with the per-slice flush, {errs[False]:.3e} without")
    assert errs[True] <= 1e-4 < errs[False], errs


def test_flagship_keeps_the_3xtf32_sweep(flagship):
    """The w0wacdm flagship's groups stay far below the f64 sweep's ratio
    (H_SWEEP_F64): its box does not reach Om = 0."""
    tfit = flagship["tfit"]
    packed = fl.pack(tfit)
    emulated = [(t, *fl._emulated(t)) for t in tfit.terms if fl._emulated(t) is not None]
    worst = max(fl.sweep_cancellation(emulated, h) for h in range(2))
    assert packed.hdr["H_SWEEP_F64"] == 0 and fl.instance(packed) == 1 and worst < 20, worst


def test_packer_pads_small_bonds_with_zeros(flagship, monkeypatch):
    """The kernel's block products take r_in >= MIN_RIN; the packer pads a
    smaller bond with zeros, the same tensor train: raised here to 24, the
    first bond of each half (17, 13) is padded and logp does not move."""
    tfit = flagship["tfit"]
    theta = torch.as_tensor(_thetas(tfit.spec.bounds, list(tfit.spec.names), seed=1, n=70))
    packed = fl.pack(tfit)
    want = fl.fused_log_prob_reference(packed, theta).numpy()
    monkeypatch.setattr(fl, "MIN_RIN", 24)
    padded = fl.pack(tfit)
    for lay, plain in zip(padded.halves, packed.halves):
        assert plain["T_R1"] < 24 == lay["T_R1"] and lay["T_R2"] == plain["T_R2"]
    np.testing.assert_allclose(fl.fused_log_prob_reference(padded, theta).numpy(), want,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("batch", ["alternating", "half 1"])
def test_grouping_by_half_keeps_each_walker_its_row(flagship, batch):
    """A batch whose walkers alternate halves, and one all in half 1: each
    walker's logp equals the one it gets alone (the plain version; the
    kernel groups a block's walkers by half the same way)."""
    tfit = flagship["tfit"]
    names = list(tfit.spec.names)
    lo, hi = tfit.spec.bounds[:, 0], tfit.spec.bounds[:, 1]
    box = lo + (hi - lo) * np.random.default_rng(9).uniform(0.02, 0.98, (400, len(lo)))
    s = box[:, names.index("w0")] + box[:, names.index("wa")]
    if batch == "alternating":
        walkers = np.stack([box[s <= 0][:12], box[s > 0][:12]], axis=1).reshape(24, -1)
    else:
        walkers = box[s > 0][:24]
    theta = torch.as_tensor(walkers)
    s_t = theta[:, names.index("w0")] + theta[:, names.index("wa")]
    halves = (s_t > 0).long().tolist()
    assert halves == ([0, 1] * 12 if batch == "alternating" else [1] * 24)
    packed = fl.pack(tfit)
    together = fl.fused_log_prob(packed, theta).numpy()
    alone = np.array([float(fl.fused_log_prob(packed, theta[i:i + 1])[0]) for i in range(24)])
    assert np.all(np.isfinite(together))
    # one walker against a batch: BLAS may block the products otherwise
    np.testing.assert_allclose(together, alone, rtol=1e-12, atol=0)


def test_w0wacdm_seam_continuity(flagship):
    """chi^2 and its (w0, wa) gradient across the split-half seam
    s = w0 + wa = 0, where two independently built interpolants meet,
    on the flagship's emulated SN and BAO terms. s = 0 is a
    Chebyshev-Lobatto endpoint of both half grids and both interpolate
    the same curves, so the jump is bounded by twice the truncation
    contract. Points, steps and tolerances as the reference test."""
    terms = {t.name: t for t in flagship["tfit"].terms}
    assert terms["bao"].meta["linear_chi2"].bundle.finalized()[0] == "split"

    def chi2(term, p, key=None):
        x = {k: torch.tensor([v], dtype=F64, requires_grad=k == key) for k, v in p.items()}
        c = term.chi2(x)[0]
        if key is None:
            return float(c)
        (g,) = torch.autograd.grad(c, x[key])
        return float(g[0])

    for name, nuis in (("sn", {"dM": -0.05, "H0": 68.0}), ("bao", {"H0": 68.0, "rd": 147.0})):
        term = terms[name]
        for om, w0 in ((0.31, -0.9), (0.25, -1.2), (0.42, -0.6)):
            for eps in (1e-7, 1e-5):
                lo = dict(nuis, Om=om, w0=w0, wa=-w0 - eps)  # s = -eps
                hi = dict(nuis, Om=om, w0=w0, wa=-w0 + eps)  # s = +eps
                c_lo, c_hi = chi2(term, lo), chi2(term, hi)
                scale = max(1.0, np.sqrt(max(c_lo, c_hi)))
                assert abs(c_hi - c_lo) <= 6e-3 * scale + 10.0 * eps, (
                    name, om, w0, eps, c_lo, c_hi)
            for k in ("w0", "wa"):
                eps = 1e-5
                lo = dict(nuis, Om=om, w0=w0, wa=-w0 - eps)
                hi = dict(nuis, Om=om, w0=w0, wa=-w0 + eps)
                g = [chi2(term, pp, k) for pp in (lo, hi)]
                ref = max(1.0, abs(g[0]), abs(g[1]))
                assert abs(g[0] - g[1]) <= 2e-2 * ref, (name, k, om, w0, g)


@pytest.mark.parametrize("name", ["fs8.fs8", "joint.multiprobe", "cc.cc_union3", "cc.cc_des5y"])
def test_w0wacdm_outside_the_flagship_family_refuses_before_building(name, monkeypatch):
    """No longer refused: each w0wacdm preset outside the flagship family
    builds its tables (on the reduced split grid of
    tests/test_torch_w0wa_joint.py) and the packer takes it into the split
    instance, every form kind in both halves."""
    from cosmax_torch.models import linear_chi2 as tlc
    from tests.test_torch_w0wa_joint import KINDS, small_split_grid

    built, table_cached = [], tlc.table_cached
    monkeypatch.setattr(tlc, "table_cached", lambda *a: built.append(a[0]) or table_cached(*a))
    with small_split_grid():
        packed = fl.pack(get_preset(name, "w0wacdm", fast=True, device="cpu"))
    assert built and packed.hdr["H_SPLIT"] == 1 and len(packed.halves) == 2
    for lay in packed.halves:
        assert [fl.KINDS[f["F_KIND"]] for f in lay["forms"]] == KINDS[name]
