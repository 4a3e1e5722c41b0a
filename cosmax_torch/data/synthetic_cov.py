"""Deterministic, realistically-structured stand-ins for the four SN
systematic covariances stripped from the mounted reference checkout
(reference .MISSING_LARGE_BLOBS: Pantheon+ 1701^2, DES5Y 1829^2 sys,
Union2.1 580^2, Pantheon18 1048^2 — loaded by y2022pantheonSHOES/
data.py:22-29, y2024DES/data.py:18-20, y2011union2/data.py:9-19,
y2018pantheon/data.py:17).

These are NOT the published matrices — chi^2 values computed with them
are not comparable to the reference docstrings, and every dataset built
with one keeps ``synthetic_cov=True``. Their purpose is to exercise the
framework's dense- and compressed-covariance code paths at the real
problem scale with the real *structure* of an SN systematic covariance,
which is a sum of outer products of per-systematic distance-modulus
perturbations Delta mu^k (SALT2 calibration, Milky-Way dust, bias
corrections, survey zero-points...):

    C_sys = sum_k  dmu^k  (dmu^k)^T

The generator reproduces the three structural regimes of the published
matrices:

* **smooth drifts** — perturbations that vary slowly with log z
  (calibration slopes, intrinsic-scatter model, bias corrections):
  low-order Legendre modes in rank-scaled log z;
* **survey blocks** — constant zero-point offsets over contiguous
  redshift ranges (SN surveys tile the Hubble diagram in z);
* **local correlations** — a short-range exponential kernel
  (neighbouring SNe share photometric calibration), proportional to
  the statistical errors.

Everything is seeded and pure: the same (z, stat_err, seed) always
yields the same matrix, so parity tests are reproducible without
storing ~60 MB of generated data.
"""

import hashlib

import numpy as np


def _rank_scaled_log_z(z):
    """log z mapped through its empirical CDF to [-1, 1] — mode shapes
    then resolve the populated regions of the Hubble diagram instead of
    bunching at the sparse high-z tail."""
    order = np.argsort(np.argsort(np.log(np.maximum(z, 1e-6))))
    return 2.0 * order / max(len(z) - 1, 1) - 1.0


def synthetic_sys_cov(
    z,
    stat_err,
    *,
    n_smooth: int = 10,
    n_survey: int = 8,
    scale: float = 0.5,
    local_scale: float = 0.25,
    seed: int = 0,
):
    """Synthetic systematic covariance [N, N] (mag^2), float64.

    ``scale`` sets the median ratio of systematic to statistical
    standard deviation (Pantheon+ quotes sys ~ 40-60% of stat for most
    SNe); ``local_scale`` the relative size of the short-range kernel.
    """
    z = np.asarray(z, dtype=np.float64)
    stat_err = np.broadcast_to(np.asarray(stat_err, dtype=np.float64), z.shape)
    n = z.size
    rng = np.random.default_rng(seed)
    u = _rank_scaled_log_z(z)

    modes = []
    # smooth calibration/bias drifts: Legendre P_k with 1/(1+k) spectrum
    for k in range(1, n_smooth + 1):
        shape = np.polynomial.legendre.Legendre.basis(k)(u)
        amp = rng.normal() / (1.0 + k)
        modes.append(amp * shape)
    # survey zero-points: contiguous blocks in z (surveys tile z)
    edges = np.linspace(0, n, n_survey + 1).astype(int)
    order = np.argsort(z)
    for b in range(n_survey):
        vec = np.zeros(n)
        vec[order[edges[b] : edges[b + 1]]] = rng.normal()
        modes.append(vec)
    v = np.stack(modes, axis=1)  # [N, K]
    c_sys = v @ v.T

    # short-range photometric-calibration kernel, stat-proportional
    du = np.abs(u[:, None] - u[None, :])
    c_local = np.outer(stat_err, stat_err) * np.exp(-du / 0.05)
    c_sys = c_sys + (local_scale / max(scale, 1e-12)) ** 2 * c_local / np.median(
        np.diag(c_local)
    ) * np.median(np.diag(c_sys))

    # normalise: median sys sigma = scale * median stat sigma
    target = (scale * np.median(stat_err)) ** 2
    c_sys *= target / np.median(np.diag(c_sys))
    return c_sys


def seed_for(name: str) -> int:
    """Stable per-dataset seed (not Python's salted hash)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")
