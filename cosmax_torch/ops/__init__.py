"""Numerical primitives: quadrature, linear algebra, the ODE steppers and
the hand-written kernels (``ops.kernels``).

The names of ``__all__`` load their module on first use, so that importing
one primitive does not import them all (``linalg`` brings scipy and the
kernels' wrappers)."""

import importlib

_HOME = {
    "gauss_legendre": "quadrature",
    "gl_integrate_01": "quadrature",
    "cumtrapz": "quadrature",
    "trapz_grid_weights": "quadrature",
    "whitening_operator": "linalg",
    "chi2_from_whitener": "linalg",
}
__all__ = list(_HOME)


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
