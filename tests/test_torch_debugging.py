"""The port's debugging helpers (``cosmax_torch.utils.debugging``): NaN
checks that raise and name the term (or the rows on the fused path), a
profiler trace written to disk, and timed evaluations."""

import os

import numpy as np
import pytest
import torch

from cosmax_torch.configs import get_preset
from cosmax_torch.likelihoods.base import ParamSpec, Term, make_log_prob
from cosmax_torch.utils import debugging


@pytest.fixture
def checks():
    debugging.enable_nan_checks(True)
    yield
    debugging.enable_nan_checks(False)


def _poisoned():
    spec = ParamSpec(("a",), np.array([[-1.0, 1.0]]))
    good = Term("good", chi2=lambda p: p["a"] ** 2)
    bad = Term("poisoned", chi2=lambda p: torch.where(p["a"] > 0, torch.nan, 0.0 * p["a"]))
    return make_log_prob(spec, [good, bad])


def test_guard_maps_nan_to_minus_inf_without_checks():
    out = _poisoned()(torch.tensor([[-0.5], [0.5]], dtype=torch.float64))
    assert np.isfinite(float(out[0])) and float(out[1]) == -np.inf


def test_nan_checks_raise_naming_the_term(checks):
    lp = _poisoned()
    assert torch.isfinite(lp(torch.tensor([[-0.5]], dtype=torch.float64))).all()
    with pytest.raises(FloatingPointError, match="'poisoned'.*rows \\[1\\]"):
        lp(torch.tensor([[-0.5], [0.5]], dtype=torch.float64))
    # out-of-box walkers stay -inf, as without the checks
    assert float(lp(torch.tensor([[1.5]], dtype=torch.float64))[0]) == -np.inf
    assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()


def test_nan_checks_name_the_rows_on_the_fast_path(checks):
    fit = get_preset("bao.desi", "lcdm", fast=True, device="cpu")
    lp = fit.log_prob()
    mid = fit.spec.bounds.mean(axis=1)
    theta = torch.as_tensor(np.stack([mid, mid]), dtype=torch.float32)
    assert torch.isfinite(lp(theta)).all()
    theta[1, 0] = torch.nan
    # a NaN parameter is not inside the box: -inf, no error
    assert float(lp(theta)[1]) == -np.inf
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    real = fl.fused_log_prob
    try:
        fl.fused_log_prob = lambda packed, th: torch.where(
            torch.arange(th.shape[0]) == 0, real(packed, th), torch.nan)
        with pytest.raises(FloatingPointError, match="fused log-prob of bao.desi.*rows \\[1\\]"):
            fit.log_prob()(torch.as_tensor(np.stack([mid, mid]), dtype=torch.float32))
    finally:
        fl.fused_log_prob = real


def test_profile_trace_writes_a_trace(tmp_path):
    lp = _poisoned()
    with debugging.profile_trace(str(tmp_path)) as prof:
        lp(torch.tensor([[-0.5], [0.2]], dtype=torch.float64))
    files = os.listdir(tmp_path)
    assert any(f.endswith(".pt.trace.json") for f in files), files
    assert prof.key_averages()


def test_timed_evals_runs():
    calls = []
    rate, seconds = debugging.timed_evals(lambda x: calls.append(x) or x, (1,), iters=5,
                                          warmup=2)
    assert len(calls) == 7 and seconds > 0 and rate == pytest.approx(5 / seconds)
