"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``cosmax_torch/csrc/`` with a
plain C entry point. It is compiled with ``nvcc`` straight into a shared
library (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. Builds happen at first use, never at import: the CPU-only
test environment imports every module but has no ``nvcc``.

The library lands in ``<repo>/build/cosmax_torch_kernels/`` (listed in
``.gitignore``) under a name that carries a hash of the source, of every
header in ``csrc/`` (``*.cuh``, which a source includes as ``"name.cuh"``)
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. Concurrent builds write to private temporary files and rename
them into place; ``load_kernels`` starts one ``nvcc`` per source at once.
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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: its name carries a
    hash of the source, the headers of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(src, out) -> list:
    """The nvcc command that builds the source ``src`` (a path) into the
    library ``out``, with ``csrc/`` on the include path."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def load_kernel(name: str) -> BuiltKernel:
    """Compile ``csrc/<name>.cu`` if needed and return its loaded library."""
    return load_kernels([name])[0]


def load_kernels(names) -> list:
    """Compile every ``csrc/<name>.cu`` that needs it, one ``nvcc``
    process per source, all started together, and return the loaded
    libraries in the order of ``names``. ``seconds`` is each build's own
    wall time."""
    jobs = {}
    try:
        for name in names:
            if name in _LOADED or name in jobs:
                continue
            src = CSRC / f"{name}.cu"
            out = library_path(name)
            if out.exists():
                _LOADED[name] = BuiltKernel(ctypes.CDLL(str(out)), out, 0.0, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                nvcc_command(src, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            jobs[name] = (src, out, tmp, proc, time.perf_counter())
        for name, (src, out, tmp, proc, t0) in jobs.items():
            stdout, stderr = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n{stdout}\n{stderr}"
                )
            os.replace(tmp, out)
            _LOADED[name] = BuiltKernel(ctypes.CDLL(str(out)), out, seconds, stderr)
    finally:
        for src, out, tmp, proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return [_LOADED[name] for name in names]
