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
