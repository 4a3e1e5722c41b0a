#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cosmax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card and ``nvcc``;
without a card it raises before printing any result. Phases, each
raising on failure (non-zero exit):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the whitened-chi^2 CUDA kernel from ``cosmax_torch/csrc``;
3. the kernel against its plain PyTorch version at the flagship shape
   (65,536 walkers x N = 1829) and at ragged shapes, rtol 5e-5, with a
   NaN row kept to its own row; kernel and plain times (CUDA events,
   median of 20 runs after warm-up);
4. the ``bao.desi`` LCDM parity anchor, chi^2(h=0.690, Om=0.298) =
   10.2753 within 2e-3 in f32;
5. the flagship ``bao.desi_cmb_des5y``/wzcdm (dense synthetic 1829^2
   SN whitening) on 65,536 walkers: all finite, 64 walkers against the
   port's f64 CPU path within 1e-4 of max|logp|, kernel launched,
   evals/s and a profiler breakdown;
6. the CLI, ``cosmax_torch.fit.main``, 150 walkers x 20 steps on the
   flagship: finite chain, acceptance in (0, 1), and the kernel's launch
   count over that run.

Then one JSON line describing each kernel, and as the last line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPLACES = "cosmax/ops/pallas/chi2.py:52"
SOURCE = "cosmax_torch/csrc/whitened_chi2.cu"
RTOL_KERNEL = 5e-5  # as tests/test_pallas_ops.py for the TPU kernel
ANCHOR_CHI2, ANCHOR_ATOL = 10.2753, 2e-3
LOGP_RTOL = 1e-4  # f32 card vs f64 CPU, relative to max|logp|
BENCH_WALKERS, N_SN = 65536, 1829


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _median_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def _spd_linv(rng, n):
    import numpy as np

    from cosmax_torch.ops.linalg import whitening_operator

    a = rng.standard_normal((n, n))
    return np.ascontiguousarray(whitening_operator(a @ a.T / n + np.eye(n)))


def phase_kernel(card):
    """Phase 3: kernel vs plain at the flagship shape and ragged shapes."""
    import numpy as np
    import torch

    from cosmax_torch.ops.kernels.whitened_chi2 import whitened_chi2, whitened_chi2_reference

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    result = {}
    for w, n in [(BENCH_WALKERS, N_SN), (19, 37), (70, 13), (150, N_SN)]:
        linv = torch.as_tensor(_spd_linv(rng, n), device="cuda").float()
        delta = torch.randn((w, n), generator=gen, device="cuda")
        got = whitened_chi2(linv, delta)
        want = whitened_chi2_reference(linv, delta)
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = float((err / want.abs()).max())
        if not bool(torch.isfinite(got).all()) or rel > RTOL_KERNEL:
            raise AssertionError(f"kernel vs plain at ({w}, {n}): max rel err {rel:.3e}")
        bad = min(7, w - 1)
        delta[bad, n // 2] = float("nan")
        got_nan = whitened_chi2(linv, delta)
        finite = torch.isfinite(got_nan)
        if bool(finite[bad]) or int((~finite).sum()) != 1:
            raise AssertionError(f"NaN row {bad} did not stay in its row at ({w}, {n})")
        print(f"phase 3: kernel vs plain at (W={w}, N={n}): max rel err {rel:.3e}, "
              f"max abs err {float(err.max()):.3e}; NaN row stays in its row")
        if (w, n) == (BENCH_WALKERS, N_SN):
            delta[bad, n // 2] = 0.0
            ms = _median_ms(lambda: whitened_chi2(linv, delta))
            plain_ms = _median_ms(lambda: whitened_chi2_reference(linv, delta))
            flop = 2.0 * w * n * n
            print(f"phase 3: whitened_chi2 at (W={w}, N={n}) on {card}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, CUDA events); "
                  f"kernel {flop / 2 / ms / 1e9:.2f} TFLOP/s on the triangle "
                  f"({flop / ms / 1e9:.2f} dense-equivalent)")
            result = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms)
    return result


def phase_anchor():
    import torch

    from cosmax_torch.configs import get_preset

    fit = get_preset("bao.desi", "lcdm", device="cuda")
    theta = torch.tensor([[0.690, 0.298]], device="cuda")
    chi2 = float(fit.chi2_breakdown()(theta)["bao"][0])
    if abs(chi2 - ANCHOR_CHI2) > ANCHOR_ATOL:
        raise AssertionError(f"bao.desi chi2 {chi2} != {ANCHOR_CHI2} +- {ANCHOR_ATOL}")
    print(f"phase 4: bao.desi lcdm chi2(h=0.690, Om=0.298) = {chi2:.5f} "
          f"(anchor {ANCHOR_CHI2}, f32 on the card)")


def _profile(fn):
    """Device time by kernel over one call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernel events only: operator events carry their kernels' time too
    rows = [
        (ev.self_device_time_total / 1e3, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    return wall_ms, rows


def phase_flagship(card):
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.likelihoods.base import chunked_log_like, walker_chunk
    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    t0 = time.perf_counter()
    fit = get_preset("bao.desi_cmb_des5y", "wzcdm", synthetic_sys=True, device="cuda")
    build_s = time.perf_counter() - t0
    linv = fit.terms[2].meta["constants"]["linv"]
    if bool((linv.tril(-1) == 0).all()) or tuple(linv.shape) != (N_SN, N_SN):
        raise AssertionError("flagship SN whitening is not a dense 1829^2 factor")
    log_prob = fit.log_prob()
    rng = np.random.default_rng(0)
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    mid, span = 0.5 * (lo + hi), 0.05 * (hi - lo)
    walkers = (mid + span * rng.standard_normal((BENCH_WALKERS, fit.spec.dim))).astype(np.float32)
    theta = torch.as_tensor(walkers, device="cuda")

    before = kmod.LAUNCHES
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = kmod.LAUNCHES - before
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"{int((~torch.isfinite(lp)).sum())} non-finite log-probs")
    if launched < 2:
        raise AssertionError(f"flagship log_prob launched the kernel {launched} times")

    ref = get_preset("bao.desi_cmb_des5y", "wzcdm", synthetic_sys=True,
                     device="cpu", dtype=torch.float64)
    lp64 = ref.log_prob()(torch.as_tensor(walkers[:64].astype(np.float64))).numpy()
    lp32 = lp[:64].double().cpu().numpy()
    rel = float(np.max(np.abs(lp32 - lp64)) / np.max(np.abs(lp64)))
    if not rel <= LOGP_RTOL:
        raise AssertionError(f"f32 card vs f64 CPU logp: {rel:.3e} of max|logp|")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        lp = log_prob(theta)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = reps * BENCH_WALKERS / dt
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 5: flagship bao.desi_cmb_des5y/wzcdm (synthetic dense 1829^2 SN) "
          f"built in {build_s:.2f}s; log_prob on {BENCH_WALKERS} walkers all finite, "
          f"{launched} kernel launches per call; f32 card vs f64 CPU on 64 walkers: "
          f"{rel:.3e} of max|logp|")
    print(f"phase 5: {rate:.1f} evals/s ({1e3 * dt / reps:.3f} ms per {BENCH_WALKERS}-walker "
          f"call, mean of {reps}) on {card}; peak device memory {peak:.2f} GiB")

    # per-term device time over the same walker chunks as log_prob
    params = fit.derive(fit.spec.unpack(theta))
    parts = ", ".join(
        f"{t.name} {_median_ms(lambda t=t: chunked_log_like(t, params, BENCH_WALKERS, theta.dtype), reps=5, warmup=1):.3f} ms "
        f"({-(-BENCH_WALKERS // walker_chunk(t, theta.dtype))} chunks)"
        for t in fit.terms
    )
    print(f"phase 5: per-term log-likelihood on {BENCH_WALKERS} walkers "
          f"(median of 5, CUDA events) on {card}: {parts}")

    wall_ms, rows = _profile(lambda: log_prob(theta))
    dev_ms = sum(r[0] for r in rows)
    kernel_ms = sum(r[0] for r in rows if "whitened_chi2" in r[1])
    if dev_ms > 0:
        print(f"phase 5: profile of one call on {card}: wall {wall_ms:.3f} ms, device "
              f"busy {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), whitened_chi2 "
              f"{kernel_ms:.3f} ms ({100 * kernel_ms / dev_ms:.1f}% of device time)")
        for ms, name, count in rows[:8]:
            print(f"phase 5:   {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    else:
        print("phase 5: torch.profiler recorded no device time (not measured)")


def phase_cli(card):
    import numpy as np

    from cosmax_torch import fit as fit_cli
    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    n_steps = 20
    with tempfile.TemporaryDirectory() as out:
        argv = ["--preset", "bao.desi_cmb_des5y", "--model", "wzcdm",
                "--walkers", "150", "--steps", str(n_steps), "--seed", "0",
                "--no-plots", "--out", out]
        kmod.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = fit_cli.main(argv)
        wall = time.perf_counter() - t0
        launches = kmod.LAUNCHES
        chain = np.load(os.path.join(out, "chain.npy"))
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)
    acc = summary["acceptance_fraction"]
    if rc != 0 or not np.all(np.isfinite(chain)) or chain.shape[1:] != (150, 6):
        raise AssertionError(f"CLI run failed: rc {rc}, chain {chain.shape}")
    if not 0.0 < acc < 1.0:
        raise AssertionError(f"acceptance fraction {acc} not in (0, 1)")
    if launches < 2 * n_steps * 2:
        raise AssertionError(f"CLI run launched the kernel only {launches} times")
    print(f"phase 6: cosmax_torch.fit {' '.join(argv[:-1])} <tmp>: wall {wall:.2f}s "
          f"on {card}, acceptance {acc:.3f}, {launches} kernel launches")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    card = _card()
    print(card)
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from cosmax_torch.device import disable_tf32
    from cosmax_torch.ops.kernels.build import load_kernel

    disable_tf32()
    built = load_kernel("whitened_chi2")
    ptxas = [ln.strip() for ln in built.log.splitlines() if "Used" in ln]
    print(f"phase 2: built {SOURCE} in {built.seconds:.2f}s; {'; '.join(ptxas)}")

    timing = phase_kernel(card)
    phase_anchor()
    phase_flagship(card)
    launches = phase_cli(card)

    print(json.dumps({"kernels": [{
        "name": "whitened_chi2", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, **timing,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
