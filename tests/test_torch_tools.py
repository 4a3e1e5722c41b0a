"""The port's tools: ``tools/torch_validate.py`` carries the JAX sweep's
cases unchanged, and ``tools/torch_profile_terms.py`` runs its ablation
on one small preset on the CPU."""

import importlib.util
from pathlib import Path

import pytest
import torch

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_validate_cases_equal_the_jax_sweep():
    port, jax_sweep = _load("torch_validate"), _load("validate")
    assert port.CASES == jax_sweep.CASES
    assert len({port._label(c) for c in port.CASES}) == len(port.CASES)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "parity"])
def test_profile_terms_runs_on_the_cpu(fast):
    tool = _load("torch_profile_terms")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tool.profile_terms("bao.desi_cmb_des5y", "lcdm", walkers=64, iters=1, fast=fast,
                                 device="cpu")
    finally:
        torch.set_num_threads(n)
    assert set(out["terms"]) == {"bao", "cmb_desi", "sn"}
    assert out["full_ms"] > 0 and all(w > 0 for w, _ in out["terms"].values())
    # no kernel runs on the CPU: the wrappers take their plain versions
    assert out["launches"] == dict(fused_log_prob=0, whitened_chi2=0)
