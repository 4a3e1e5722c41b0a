"""The chi^2 kernel's arithmetic (``cosmax_torch/csrc/whitened_chi2.cu``),
emulated on the CPU, on realistic residuals: delta_w = z_w L^T with z ~
N(0, I) and L the Cholesky factor of Union2.1's covariance (N = 580, the
synthetic systematics ``chip_smoke.py`` phase 15 uses), 64 walkers, held
against chi^2 in f64 of the same float32 inputs at ``RTOL_CHI2_F64``, the
tolerance of the chip run's realistic-residual check (phases 3 and 15).

* 3xTF32 (x = hi + lo, each rounded to TF32 as ``cvt.rna.tf32.f32``; a_lo
  b_hi + a_hi b_lo + a_hi b_hi), each stage of BK k summed from zero and
  added to f32 running sums, stays within it; one TF32 pass does not.
* On the model of the tensor cores' truncating f32 adds
  (``tests/test_torch_w0wa.py``), the kernel's per-stage sums stay within
  it, and one accumulator over the whole K does not: the two planted
  faults the chip run must catch.

The CUDA kernel runs only on a card; this pins the tolerance here."""

import numpy as np
import pytest
import torch

from chip_smoke import RTOL_CHI2_F64
from cosmax_torch.data.loaders import load_sn, use_synthetic_sys
from tests.test_torch_w0wa import _mma, _tf32

BK = 32  # the kernel's k a stage (whitened_chi2.cu)
BR = 128  # its Linv rows a row tile


@pytest.fixture(scope="module")
def draw():
    """(delta [64, N] f32, Linv [N, N] f32, chi^2 [64] in f64 of those)."""
    with use_synthetic_sys(True):
        sn = load_sn("union21")
    rng = np.random.default_rng(580)
    z = rng.standard_normal((64, sn.n))
    delta = torch.as_tensor(z @ np.linalg.cholesky(sn.cov).T).float()
    linv = torch.as_tensor(np.ascontiguousarray(sn.linv)).float()
    want = ((delta.double() @ linv.double().T) ** 2).sum(-1)
    return delta, linv, want


def _chi2(y):
    return (y.double() ** 2).sum(-1).float()


def _stages(n, r0):
    """The stages of the row tile at r0, in the kernel's order: k up in
    even tiles, down in odd ones (k < min(r0 + BR, N))."""
    out = list(range(-(-min(r0 + BR, n) // BK)))
    return out[::-1] if (r0 // BR) % 2 else out


def _emulate(delta, linv, passes):
    """Y = delta Linv^T as the kernel sums it: per row tile, each stage's
    products in f64 (TF32 products are exact there), rounded to f32 and
    added to f32 running sums; 3xTF32 (``passes`` 3) or one TF32 pass."""
    n = delta.shape[1]
    a_hi, b_hi = _tf32(delta), _tf32(linv)
    a_lo, b_lo = _tf32(delta - a_hi), _tf32(linv - b_hi)
    pairs = [(a_hi, b_hi)] + ([(a_lo, b_hi), (a_hi, b_lo)] if passes == 3 else [])
    y = torch.zeros(delta.shape[0], n)
    for r0 in range(0, n, BR):
        rows = slice(r0, min(r0 + BR, n))
        for s in _stages(n, r0):
            ks = slice(s * BK, min(s * BK + BK, n))
            part = sum(a[:, ks].double() @ b[rows, ks].double().T for a, b in pairs)
            y[:, rows] += part.float()
    return y


def _on_the_model(delta, linv, flush):
    """Y on the tensor-core model: 3xTF32 mma over k-steps of 8, each
    stage's sums from zero added to f32 running sums (``flush``, the
    kernel), or one accumulator over the row tile's whole K."""
    n = delta.shape[1]
    kp = -(-n // BK) * BK
    a = torch.nn.functional.pad(delta, (0, kp - n))
    b = torch.nn.functional.pad(linv, (0, kp - n))
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    y = torch.zeros(delta.shape[0], n)
    for r0 in range(0, n, BR):
        rows = slice(r0, min(r0 + BR, n))
        acc = torch.zeros(delta.shape[0], rows.stop - r0)
        part = torch.zeros_like(acc)
        for s in _stages(n, r0):
            for kk in range(s * BK, s * BK + BK, 8):
                ks = slice(kk, kk + 8)
                for x, w in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                    part = _mma(part, x[:, ks], w[rows, ks].T)
            if flush:
                acc, part = acc + part, torch.zeros_like(part)
        y[:, rows] = acc + part
    return y


def _rel(got, want):
    return float(((got.double() - want).abs() / want.abs()).max())


def test_3xtf32_with_stage_sums_meets_the_f64_check(draw):
    delta, linv, want = draw
    errs = {p: _rel(_chi2(_emulate(delta, linv, p)), want) for p in (3, 1)}
    print(f"chi^2 at N = 580 against f64: 3xTF32 {errs[3]:.3e}, one TF32 pass {errs[1]:.3e} "
          f"(limit {RTOL_CHI2_F64:g})")
    assert errs[3] <= RTOL_CHI2_F64 < errs[1], errs


def test_stage_sums_keep_the_tensor_cores_truncation_within_the_check(draw):
    delta, linv, want = draw
    errs = {f: _rel(_chi2(_on_the_model(delta, linv, f)), want) for f in (True, False)}
    print(f"chi^2 at N = 580 on the tensor-core model against f64: per-stage sums "
          f"{errs[True]:.3e}, one accumulator over the whole K {errs[False]:.3e}")
    assert errs[True] <= RTOL_CHI2_F64 < errs[False], errs
