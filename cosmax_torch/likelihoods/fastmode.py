"""Fast-mode switch (counterpart of ``cosmax/likelihoods/fastmode.py``).

Presets default to the reference-matched parity discretisations. Inside
``use_fast_mode()`` the builders swap in the emulated production path:
the BAO ``('emu',)`` grid, the emulated SN, CC, quasar and fs8 terms. Terms built in one
fast-mode scope share one emulator bundle per (model, grid, device,
dtype), so the joint's geometry costs one barycentric contraction
(``models/linear_chi2.py``). ``get_preset(..., fast=True)`` builds the
preset inside this context.
"""

import contextvars
from contextlib import contextmanager

_FAST = contextvars.ContextVar("cosmax_torch_fast_mode", default=False)
# the GL order of the BAO term's default parity grid (``bao.build_bao_term``)
GL_ORDER = 64


def fast_mode() -> bool:
    return _FAST.get()


@contextmanager
def use_fast_mode(on: bool = True):
    token = _FAST.set(on)
    try:
        if on:
            from cosmax_torch.models.linear_chi2 import bundle_scope

            with bundle_scope():
                yield
        else:
            yield
    finally:
        _FAST.reset(token)
