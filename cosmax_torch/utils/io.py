"""Atomic file writes for npz artifacts (counterpart of
``cosmax/utils/io.py``).

Checkpoints rewrite npz files that must survive a crash mid-write: the
final path is only ever touched by an ``os.replace`` of a fully written
same-directory temp file, so a kill leaves the previous good file
intact.
"""

import os
import tempfile

import numpy as np


def atomic_savez(path: str, compressed: bool = False, **arrays):
    """``np.savez[_compressed]`` through a temp file + atomic rename."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            (np.savez_compressed if compressed else np.savez)(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
