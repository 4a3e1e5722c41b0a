"""cosmax_torch never imports jax, the JAX package or pandas (the card's
machine has none): in a fresh interpreter where all three are blocked,
every module of the port imports."""

import subprocess
import sys
from pathlib import Path

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cosmax"] = None
sys.modules["pandas"] = None
import cosmax_torch
names = sorted(m.name for m in pkgutil.walk_packages(cosmax_torch.__path__, "cosmax_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "pandas")
                            or m.startswith(("jax.", "jaxlib", "cosmax.", "pandas.")))
)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=root, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 32  # every module of the port was walked


_TOOLS_PROBE = """
import importlib.util, sys
sys.modules["jax"] = None
sys.modules["cosmax"] = None
sys.modules["pandas"] = None
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(name, "tools/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import cosmax_torch.compat, cosmax_torch.field, cosmax_torch.gp.__main__
import cosmax_torch.data.fetch, cosmax_torch.data.ingest, cosmax_torch.report.plots
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "pandas")
                            or m.startswith(("jax.", "jaxlib", "cosmax.", "pandas.")))
)
assert not leaked, leaked
"""


def test_port_tools_import_without_jax():
    """The port's tools (the ablation, the validation sweep, the row
    precheck, the warmup sweep, the evidence convergence) and the modules
    of its outer layers (the emcee facade, the GP and field CLIs, data
    preparation, the figures) import with jax, the JAX package and pandas
    blocked."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _TOOLS_PROBE, "torch_profile_terms", "torch_validate",
         "torch_precheck_rows", "torch_warmup_sweep", "torch_evidence_convergence"],
        cwd=root, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_tf32_stays_off():
    """The port's counterpart of test_all_dots_pin_highest_precision
    (tests/test_likelihood_parity.py): ``device.resolve`` leaves both TF32
    switches off and float32 matmuls at "highest", and no module of the
    port turns TF32 on or lowers the matmul precision (the kernels' 3xTF32
    keeps f32 accuracy by hand; a single TF32 pass keeps ~3 digits)."""
    import re

    import torch

    from cosmax_torch.device import resolve

    switches = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    precision = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        assert resolve("cpu") == (torch.device("cpu"), torch.float32)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = switches
        torch.set_float32_matmul_precision(precision)
    root = Path(__file__).resolve().parents[1] / "cosmax_torch"
    for path in root.rglob("*.py"):
        src = path.read_text()
        assert not re.search(r"allow_tf32\s*=\s*True", src), path
        assert "set_float32_matmul_precision" not in src, path
        assert not re.search(r"allow_bf16_reduced_precision_reduction\s*=\s*True", src), path
