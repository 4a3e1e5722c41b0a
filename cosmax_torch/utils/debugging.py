"""Debugging and observability helpers (counterpart of
``cosmax/utils/debugging.py``).

* ``enable_nan_checks()`` — autograd's anomaly mode with its NaN check,
  and the NaN -> -inf guard of the log-probs turned into an error: with
  the checks on, ``likelihoods.base.make_log_prob`` raises on a
  non-finite log-likelihood of a walker inside the box and names the
  term, and a fast fit's ``log_prob()`` raises and names the rows (the
  fused kernel sums the terms in one launch). Off, both map such rows to
  -inf as the reference does.
* ``profile_trace(dir)`` — a context manager around ``torch.profiler``
  (CPU, and CUDA where there is a card) that writes a Chrome /
  TensorBoard trace into ``dir``.
* ``timed_evals(fn, args, iters)`` — steady-state calls per second, the
  card synchronised before each clock read.
"""

import contextlib
import time

import torch

_NAN_CHECKS = False


def enable_nan_checks(on: bool = True):
    global _NAN_CHECKS
    _NAN_CHECKS = bool(on)
    torch.autograd.set_detect_anomaly(on, check_nan=True)


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS


def raise_on_bad_rows(ll: torch.Tensor, inside: torch.Tensor, where: str):
    """With the NaN checks on: raise if a walker inside the box has a
    non-finite log-likelihood ``ll`` (``where`` names its source)."""
    bad = inside & ~torch.isfinite(ll)
    if bool(bad.any()):
        rows = torch.nonzero(bad).flatten()[:8].tolist()
        raise FloatingPointError(
            f"{where} is not finite (NaN or inf) on {int(bad.sum())} walker(s) inside the "
            f"box, rows {rows}{' ...' if int(bad.sum()) > 8 else ''}"
        )


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the body; on exit write its trace into ``log_dir``
    (``*.pt.trace.json``, Chrome-trace JSON that TensorBoard reads).
    Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_evals(fn, args, iters: int = 20, warmup: int = 1):
    """Returns (calls per second over ``iters`` calls, their seconds); the
    card is synchronised after the warm-up and after the timed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    dt = time.perf_counter() - t0
    return iters / dt, dt
