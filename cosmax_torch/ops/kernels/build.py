"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``cosmax_torch/csrc/`` with a
plain C entry point. It is compiled with ``nvcc`` straight into a shared
library (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. Builds happen at first use, never at import: the CPU-only
test environment imports every module but has no ``nvcc``.

The library lands in ``<repo>/build/cosmax_torch_kernels/`` (listed in
``.gitignore``) under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded. Concurrent builds write to private temporary files and rename
them into place.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cosmax_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuiltKernel:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's stderr (ptxas register/shared-memory report)


_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of cosmax_torch are built from source at first use"
    )


def load_kernel(name: str) -> BuiltKernel:
    """Compile ``csrc/<name>.cu`` if needed and return its loaded library."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds, log = time.perf_counter() - t0, proc.stderr
    built = BuiltKernel(ctypes.CDLL(str(out)), out, seconds, log)
    _LOADED[name] = built
    return built
