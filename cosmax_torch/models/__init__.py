"""Background cosmology: expansion, distances, recombination, growth; the
emulators. The submodules of ``__all__`` load on first use."""

import importlib

from cosmax_torch.models.background import MODELS, de_density, e2_of_z, hubble

_SUBMODULES = ("distances", "recombination", "growth")
__all__ = ["MODELS", "de_density", "e2_of_z", "hubble", *_SUBMODULES]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
