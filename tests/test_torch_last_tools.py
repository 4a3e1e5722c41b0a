"""The port's last tools against the JAX package's:

* ``tools/torch_precheck_rows.py``: its ``check_case`` against the JAX
  tool's (``tools/precheck_rows.py``, loaded unchanged) on three cheap
  ``CASES`` rows, one with a profiled parameter: chi^2 within 1e-9
  relative, each profiled parameter within 1e-6 of its bounds' width;
* ``tools/torch_warmup_sweep.py`` and ``tools/torch_evidence_convergence.py``
  on ``bao.desi`` lcdm on the CPU at tiny budgets: every line carries the
  JAX tool's keys (read from its source), the suite is the JAX tool's, and
  the evidence summary's ``pass`` follows the JAX tool's rule on planted
  stage values. Statistical tools on another RNG: no draw is compared."""

import ast
import importlib.util
import json
import re
from collections import namedtuple
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

TOOLS = Path(__file__).resolve().parents[1] / "tools"
PRECHECK_ROWS = ("bao.desi[lcdm]", "cc.cc[lcdm]", "bao.desi_union3_omh2[lcdm]")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_precheck():
    """The JAX tool, whose import turns float64 on for the whole process:
    the flag is put back, and its functions run under ``enable_x64``."""
    prev = jax.config.jax_enable_x64
    try:
        return _load("precheck_rows")
    finally:
        jax.config.update("jax_enable_x64", prev)


def _jax_keys(tool, var):
    """The constant keys the JAX tool's source gives the dict ``var``: its
    literal and the keys assigned to it afterwards."""
    keys = set()
    for node in ast.walk(ast.parse((TOOLS / f"{tool}.py").read_text())):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == var and isinstance(node.value,
                                                                              ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == var and isinstance(tgt.slice, ast.Constant):
                    keys.add(tgt.slice.value)
    assert keys, (tool, var)
    return keys


@pytest.mark.parametrize("row", PRECHECK_ROWS)
def test_precheck_matches_the_jax_tool(row, jax_precheck):
    port = _load("torch_precheck_rows")
    from torch_validate import CASES

    (case,) = [c for c in CASES if port.label(c) == row]
    chi2, prof = port.check_case(*case)
    with jax.enable_x64(True):
        want_chi2, want_prof = jax_precheck.check_case(*case)
    assert chi2 == pytest.approx(want_chi2, rel=1e-9)
    assert set(prof) == set(want_prof)
    if prof:
        from cosmax_torch.configs import get_preset

        spec = get_preset(case[0], case[1], device="cpu").spec
        bounds, names = spec.bounds, list(spec.names)
        for p, v in prof.items():
            lo, hi = bounds[names.index(p)]
            assert abs(v - want_prof[p]) <= 1e-6 * (hi - lo), (p, v, want_prof[p])
    # the row is one the JAX precheck passes (chip_smoke.py phase 20 holds it)
    assert abs(chi2 - case[4]) < port.FLAG


def test_precheck_main_prints_every_selected_row(capsys):
    port = _load("torch_precheck_rows")
    assert port.main(["--only", "cc.cc[lcdm]"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"cc\.cc\[lcdm\]\s+chi2@pub\s+30\.389\s+pub\s+30\.39\s+d -0\.001", out)
    assert out.rstrip().endswith("0 rows flagged")


def test_warmup_sweep_lines_carry_the_jax_keys(capsys):
    port, jax_tool = _load("torch_warmup_sweep"), _load("warmup_sweep")
    assert port.SUITE == jax_tool.SUITE
    assert port.main(["--preset", "bao.desi", "--model", "lcdm", "--device", "cpu", "--seeds",
                      "2", "--chains", "8", "--warmup", "12", "--samples", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    seeds = [ln for ln in lines if ln.startswith("seed")]
    assert len(seeds) == 2
    for ln in seeds:
        # the JAX tool's line, then the gradient evaluations
        assert re.match(r"seed +\d+: rejuvenated +\d+/8 \( *[\d.]+%\), retries \d, divergent "
                        r"\d+, [\d.]+s, \d+ gradient evaluations \([\d.]+/s\)$", ln), ln
    summary = json.loads(lines[-1])
    assert _jax_keys("warmup_sweep", "summary") <= set(summary)
    assert summary["device"] == "cpu" and summary["seeds"] == 2
    assert summary["first_warmup_failures"] <= 2


def test_evidence_convergence_lines_carry_the_jax_keys(capsys):
    port = _load("torch_evidence_convergence")
    records = port.run(["--preset", "bao.desi", "--model", "lcdm", "--device", "cpu",
                        "--replicates", "2", "--base-warmup", "3", "--base-samples", "3",
                        "--max-doublings", "1", "--golden-mult", "2"])
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == [json.dumps(r) for r in records]
    assert [r["stage"] for r in records] == ["default", "until_stable", "golden", "summary"]
    jax_rec = _jax_keys("evidence_convergence", "rec")
    optional = {"converged", "history"}
    for rec in records[:3]:
        assert jax_rec - optional <= set(rec)
        assert np.isfinite(rec["log_evidence"]) and len(rec["per_replicate"]) == 2
        # no kernel on the CPU: the fused wrapper takes its plain version
        assert rec["fused_launches"] == 0
    assert optional <= set(records[1]) and len(records[1]["history"]) == 2
    assert _jax_keys("evidence_convergence", "summary") <= set(records[3])


Stage = namedtuple("Stage", "log_evidence error")


@pytest.mark.parametrize("stable, golden, threshold, want", [
    (Stage(-10.0, 0.1), Stage(-10.5, 0.2), 0.1, True),    # within 2 (err_s + err_g)
    (Stage(-10.0, 0.01), Stage(-10.08, 0.01), 0.1, True),  # within the threshold
    (Stage(-10.0, 0.05), Stage(-10.5, 0.05), 0.1, False),  # beyond both
    (Stage(-10.0, 0.05), Stage(-9.75, 0.05), 0.2, False),  # beyond both, golden above
])
def test_evidence_summary_follows_the_pass_rule(stable, golden, threshold, want):
    port = _load("torch_evidence_convergence")
    default = Stage(-11.0, 0.3)
    s = port.summary_record(default, stable, golden, threshold)
    assert s["pass"] is want
    assert s["default_minus_golden"] == pytest.approx(default.log_evidence - golden.log_evidence)
    assert s["until_stable_minus_golden"] == pytest.approx(stable.log_evidence
                                                           - golden.log_evidence)
    assert s["tolerance_2err"] == pytest.approx(2.0 * (stable.error + golden.error))
