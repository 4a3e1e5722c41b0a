"""Linear algebra for Gaussian likelihoods (counterpart of
``cosmax/ops/linalg.py``).

Each covariance is factored once at build time in float64 numpy and its
Cholesky factor inverted exactly (LAPACK dtrtri), so a likelihood call is

    chi^2 = || Linv @ delta ||^2

for a [W, N] batch of walker residuals: one GEMM-shaped reduction, which
on the card is the hand-written kernel in ``ops/kernels/whitened_chi2``.
"""

import numpy as np
import scipy.linalg
import torch

from cosmax_torch.ops.kernels.whitened_chi2 import whitened_chi2


def whitening_operator(cov: np.ndarray) -> np.ndarray:
    """L^{-1} with cov = L L^T, float64 numpy (build time only); lower-
    triangular with exact zeros above the diagonal."""
    L = np.linalg.cholesky(np.asarray(cov, dtype=np.float64))
    return scipy.linalg.lapack.dtrtri(L, lower=1)[0]


def log_det_cov(cov: np.ndarray) -> float:
    """log|cov| via Cholesky (build time)."""
    L = np.linalg.cholesky(np.asarray(cov, dtype=np.float64))
    return float(2.0 * np.sum(np.log(np.diag(L))))


def chi2_from_whitener(linv: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """chi^2 = ||Linv delta||^2 for delta [W, N] -> [W]. ``linv`` is a
    lower-triangular whitening operator (see ``whitening_operator``).
    CPU tensors use the plain product; CUDA tensors the CUDA kernel."""
    return whitened_chi2(linv, delta)
