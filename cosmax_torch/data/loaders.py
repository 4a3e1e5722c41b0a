"""Typed dataset bundles from the shared data store (counterpart of
``cosmax/data/loaders.py``).

The store is the JAX package's directory of plain ``.npz`` files,
``cosmax/data/store/``, read here by file path: importing ``cosmax.data``
would pull in jax. Each loader returns float64 numpy arrays plus the
covariance assembled exactly as the reference assembles it; the
whitening operator is computed lazily once per dataset.

Datasets whose systematic covariance is absent from the store fall back
to the diagonal statistical covariance (``synthetic_cov=True``). Inside
``use_synthetic_sys()`` a deterministic synthetic systematic term is
added instead, so the dense 1829^2 path runs at its real scale.
"""

import contextvars
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from cosmax_torch.ops.linalg import log_det_cov, whitening_operator

_STORE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "cosmax", "data", "store",
)

_SYNTHETIC_SYS = contextvars.ContextVar("cosmax_torch_synthetic_sys", default=False)

# BAO quantity codes (reference bao/desi.py:69-75)
QTY_DV, QTY_DM, QTY_DH = 0, 1, 2


def synthetic_sys_enabled() -> bool:
    return _SYNTHETIC_SYS.get()


@contextmanager
def use_synthetic_sys(on: bool = True):
    token = _SYNTHETIC_SYS.set(on)
    try:
        yield
    finally:
        _SYNTHETIC_SYS.reset(token)


def store_path() -> str:
    return _STORE


@lru_cache(maxsize=None)
def _bundle(name: str) -> dict:
    path = os.path.join(_STORE, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"dataset bundle {name!r} not found in {_STORE}")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@lru_cache(maxsize=None)
def _synthetic_sys_for(name: str):
    """Synthetic systematic covariance on the dataset's full table."""
    from cosmax_torch.data.synthetic_cov import seed_for, synthetic_sys_cov

    b = _bundle(name)
    if name == "pantheon_plus":
        z, err = b["z_hd"], b["m_b_corr_err_diag"]
    elif name == "des5y":
        z, err = b["z_hd"], b["mu_err"]
    elif name == "union21":
        z, err = b["z"], b["sigma_mu"]
    elif name == "pantheon18":
        z, err = b["z_cmb"], b["dmb"]
    else:
        raise KeyError(name)
    return synthetic_sys_cov(z, err, seed=seed_for(name))


@dataclass(frozen=True)
class CovDataset:
    """A Gaussian dataset: values with an N x N covariance."""

    legend: str
    values: np.ndarray
    cov: np.ndarray
    synthetic_cov: bool = False
    extras: dict = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.values.size

    @property
    def linv(self) -> np.ndarray:
        cached = self.extras.get("_linv")
        if cached is None:
            cached = whitening_operator(self.cov)
            self.extras["_linv"] = cached
        return cached

    @property
    def log_det(self) -> float:
        cached = self.extras.get("_logdet")
        if cached is None:
            cached = log_det_cov(self.cov)
            self.extras["_logdet"] = cached
        return cached

    def __getattr__(self, name):
        extras = self.__dict__.get("extras")
        if extras is not None and name in extras:
            return extras[name]
        raise AttributeError(name)


def load_bao(name: str = "desi_dr2") -> CovDataset:
    """BAO D_{V,M,H}/r_d values with integer quantity codes {0, 1, 2}."""
    b = _bundle(name)
    return CovDataset(
        legend=str(b["legend"]),
        values=b["value"],
        cov=b["cov"],
        extras=dict(z=b["z"], quantity=b["quantity"]),
    )


def load_sn(name: str = "pantheon_plus") -> CovDataset:
    """Supernova compilations with the reference's selections:

    * ``pantheon_plus``       — zHD > 0.01 cut, 1590 SNe
    * ``pantheon_plus_shoes`` — calibrators kept, 1657 SNe, with
                                ``ceph_dist`` and ``is_calibrator``
    * ``des5y``               — 1829 SNe, cov = sys + diag(MUERR^2)
    * ``des5y_bins``          — inverse-variance binning, 50 SNe a bin:
                                37 bins
    * ``union3``              — 22 bins, full covariance
    * ``union21``             — 580 SNe, z both z_cmb and z_hel
    * ``pantheon18``          — 1048 SNe, cov = sys + diag(dmb^2)
    * ``pantheon18_bins``     — 40 bins with their systematic covariance
    """
    synthetic = _SYNTHETIC_SYS.get()
    if name in ("pantheon_plus", "pantheon_plus_shoes"):
        b = _bundle("pantheon_plus")
        z = b["z_hd"]
        if name == "pantheon_plus":
            sel = np.where(z > 0.01)[0]
            legend = "Pantheon+ (2022)"
        else:
            sel = np.where((b["is_calibrator"] == 1) | (z > 0.01))[0]
            legend = "Pantheon+ and SH0ES"
        if "cov" in b:
            cov, synth = b["cov"][np.ix_(sel, sel)], False
        else:
            cov = np.diag(b["m_b_corr_err_diag"][sel] ** 2)
            if synthetic:
                cov = cov + _synthetic_sys_for("pantheon_plus")[np.ix_(sel, sel)]
            synth = True
        extras = dict(z_cmb=z[sel], z_hel=b["z_hel"][sel])
        if name == "pantheon_plus_shoes":
            extras.update(ceph_dist=b["ceph_dist"][sel], is_calibrator=b["is_calibrator"][sel])
        return CovDataset(legend, b["m_b_corr"][sel], cov, synth, extras)

    if name == "des5y":
        b = _bundle("des5y")
        if "cov_sys" in b:
            cov, synth = b["cov_sys"] + np.diag(b["mu_err"] ** 2), False
        else:
            cov = np.diag(b["mu_err"] ** 2)
            if synthetic:
                cov = cov + _synthetic_sys_for("des5y")
            synth = True
        return CovDataset(
            str(b["legend"]),
            b["mu"],
            cov,
            synth,
            dict(
                z_cmb=b["z_hd"],
                z_hel=b["z_hel"],
                effective_sample_size=int(b["effective_sample_size"]),
            ),
        )

    if name == "des5y_bins":
        return _des5y_bins()

    if name == "union3":
        b = _bundle("union3")
        return CovDataset(
            str(b["legend"]), b["mu"], b["cov"], False,
            dict(z_cmb=b["z_cmb"], z_hel=b["z_hel"]),
        )

    if name == "union21":
        b = _bundle("union21")
        if "cov" in b:
            cov, synth = b["cov"], False
        else:
            cov = np.diag(b["sigma_mu"] ** 2)
            if synthetic:
                cov = cov + _synthetic_sys_for("union21")
            synth = True
        return CovDataset(str(b["legend"]), b["mu"], cov, synth, dict(z_cmb=b["z"], z_hel=b["z"]))

    if name in ("pantheon18", "pantheon18_bins"):
        # only the bins bundle carries a systematic covariance
        b = _bundle(name)
        if "cov_sys" in b:
            cov, synth = b["cov_sys"] + np.diag(b["dmb"] ** 2), False
        else:
            cov = np.diag(b["dmb"] ** 2)
            if synthetic and name == "pantheon18":
                cov = cov + _synthetic_sys_for("pantheon18")
            synth = True
        return CovDataset(
            str(b["legend"]), b["mb"], cov, synth, dict(z_cmb=b["z_cmb"], z_hel=b["z_hel"])
        )

    raise KeyError(f"unknown SN dataset {name!r}")


def _des5y_bins(bin_size: int = 50) -> CovDataset:
    """Inverse-variance-weighted equal-count binning of DES5Y with its
    full binned covariance (reference y2024DES/data_bins.py:27-61)."""
    full = load_sn("des5y")
    n = full.n
    z, mu, cov = full.z_cmb, full.values, full.cov
    idx_split = np.array_split(np.arange(n), int(np.ceil(n / bin_size)))
    weights, z_bins, mu_bins = [], [], []
    for idx in idx_split:
        w = np.sum(np.linalg.inv(cov[np.ix_(idx, idx)]), axis=1)
        w = w / np.sum(w)
        weights.append(w)
        z_bins.append(np.mean(z[idx]))
        mu_bins.append(np.sum(w * mu[idx]))
    nb = len(idx_split)
    cov_bins = np.zeros((nb, nb))
    for i in range(nb):
        for j in range(nb):
            cov_bins[i, j] = weights[i] @ cov[np.ix_(idx_split[i], idx_split[j])] @ weights[j]
    return CovDataset(
        f"DES-SN5YR - {bin_size} bins",
        np.asarray(mu_bins),
        cov_bins,
        full.synthetic_cov,
        dict(z_cmb=np.asarray(z_bins), z_hel=np.asarray(z_bins)),
    )


def load_cc() -> CovDataset:
    """Cosmic chronometers with the Moresco systematic covariance:
    diag(sigma_H^2) plus the IMF and SPS-odd rank-one components built
    from interpolated percentage errors (reference y2005cc/data.py:14-38)."""
    b = _bundle("cc")
    z, H = b["z"], b["H"]
    imf = np.interp(z, b["comp_z"], b["comp_imf"]) / 100.0
    spsooo = np.interp(z, b["comp_z"], b["comp_spsooo"]) / 100.0
    cov = (
        np.diag(b["sigma_H"] ** 2)
        + np.outer(H * imf, H * imf)
        + np.outer(H * spsooo, H * spsooo)
    )
    return CovDataset(
        f"Cosmic Chronometers ({z.size} data points)", H, cov, False,
        dict(z=z, sigma_H=b["sigma_H"]),
    )


def load_fs8() -> CovDataset:
    """The fsigma8 compilation (66 points) with its full covariance and
    each point's fiducial Omega_m (reference y2018fs8/data.py)."""
    b = _bundle("fs8")
    return CovDataset(
        str(b["legend"]), b["fs8"], b["cov"], False,
        dict(z=b["z"], fs8_err=b["fs8_err"], omega_fid=b["omega_fid"]),
    )


def load_quasars(n_bins: int = 48, sigma_mu_type: str = "sem_errors"):
    """Lusso+2020 quasars in equally populated redshift bins (reference
    y2018quasars/data.py:20-90). Returns (legend, z, mu, sigma_mu) f64
    arrays: the per-bin means of z and mu, and the aggregated error.

    The bins are pandas.qcut's, in numpy: edges at the linearly
    interpolated quantiles of the sorted redshifts (repeated edges
    dropped), intervals (lo, hi] with the first closed. Every mode reads
    the e_DM column, as the reference code does: ``sem_errors`` is
    sqrt(sum e^2)/n, ``sem_data`` std(e)/sqrt(n), ``rms_errors``
    sqrt(sum e^2 / n)."""
    if sigma_mu_type not in ("sem_errors", "sem_data", "rms_errors"):
        raise ValueError(sigma_mu_type)
    b = _bundle("quasars")
    order = np.argsort(b["z"], kind="stable")
    z, mu, err = b["z"][order], b["dm"][order], b["e_dm"][order]
    edges = np.unique(np.quantile(z, np.linspace(0.0, 1.0, n_bins + 1)))
    n_out = edges.size - 1
    idx = np.clip(np.searchsorted(edges, z, side="left") - 1, 0, n_out - 1)
    zb, mub, sig = (np.empty(n_out) for _ in range(3))
    for k in range(n_out):
        m = idx == k
        e = err[m]
        zb[k], mub[k] = np.mean(z[m]), np.mean(mu[m])
        if sigma_mu_type == "sem_errors":
            sig[k] = np.sqrt(np.sum(e**2)) / e.size
        elif sigma_mu_type == "sem_data":
            sig[k] = np.std(e) / np.sqrt(e.size)
        else:
            sig[k] = np.sqrt(np.sum(e**2) / e.size)
    return f"Quasars - {n_out} bins", zb, mub, sig
