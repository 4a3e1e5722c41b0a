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

from cosmax_torch.ops.linalg import whitening_operator

_STORE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "cosmax", "data", "store",
)

_SYNTHETIC_SYS = contextvars.ContextVar("cosmax_torch_synthetic_sys", default=False)

# BAO quantity codes (reference bao/desi.py:69-75)
QTY_DV, QTY_DM, QTY_DH = 0, 1, 2


@contextmanager
def use_synthetic_sys(on: bool = True):
    token = _SYNTHETIC_SYS.set(on)
    try:
        yield
    finally:
        _SYNTHETIC_SYS.reset(token)


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

    * ``pantheon_plus`` — zHD > 0.01 cut, 1590 SNe
    * ``des5y``         — 1829 SNe, cov = sys + diag(MUERR^2)
    * ``union3``        — 22 bins, full covariance
    """
    synthetic = _SYNTHETIC_SYS.get()
    if name == "pantheon_plus":
        b = _bundle("pantheon_plus")
        z = b["z_hd"]
        sel = np.where(z > 0.01)[0]
        if "cov" in b:
            cov, synth = b["cov"][np.ix_(sel, sel)], False
        else:
            cov = np.diag(b["m_b_corr_err_diag"][sel] ** 2)
            if synthetic:
                cov = cov + _synthetic_sys_for("pantheon_plus")[np.ix_(sel, sel)]
            synth = True
        extras = dict(z_cmb=z[sel], z_hel=b["z_hel"][sel])
        return CovDataset("Pantheon+ (2022)", b["m_b_corr"][sel], cov, synth, extras)

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

    if name == "union3":
        b = _bundle("union3")
        return CovDataset(
            str(b["legend"]), b["mu"], b["cov"], False,
            dict(z_cmb=b["z_cmb"], z_hel=b["z_hel"]),
        )

    raise KeyError(
        f"SN dataset {name!r} is not ported yet (ported: pantheon_plus, des5y, union3)"
    )
