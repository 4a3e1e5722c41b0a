#!/usr/bin/env python3
"""Which w0wacdm bundles the fused kernel's packer gives the f64 sweep.

    python3 tools/sweep_f64_survey.py [--jobs N] [--out FILE] [PRESET ...]

Builds each preset (all 45 of ``cosmax_torch/_preset_index.py`` by
default) fast in w0wacdm on the CPU, packs it as for the card (float32
constants) and prints, per preset, each half's ``sweep_cancellation`` (the
largest ratio of a group's table scale to its largest |value| at the
half's reference centre), the group that sets it, and the packer's choice
(``H_SWEEP_F64``: the f64 sweep above ``SWEEP_F64_RATIO``). ``cmb.cmb`` and
``cc.cc_cmb`` are lcdm in every model: no split grid, nothing to choose.
One process a preset, ``--jobs`` at once, each with one BLAS thread: the
builds take 5-24 s each, ``joint.multiprobe`` and ``fs8.fs8`` minutes.
``--out`` also writes the rows as JSON lines. A measurement of the
packer on the host; nothing runs on a card.
"""

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def survey(name):
    """The packer's choice for ``name`` in w0wacdm, as a dict."""
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    fit = get_preset(name, "w0wacdm", fast=True, synthetic_sys=True, device="cpu",
                     dtype=torch.float32)
    if fit.model != "w0wacdm":
        return dict(preset=name, model=fit.model, split=False)
    packed = fl.pack(fit)
    emulated = [(t, *fl._emulated(t)) for t in fit.terms if fl._emulated(t) is not None]
    halves = []
    for h in range(len(packed.halves)):
        groups = {t.name: fl.sweep_cancellation([(t, kind, obj)], h) for t, kind, obj in emulated}
        worst = max(groups, key=groups.get)
        halves.append(dict(cancellation=groups[worst], group=worst, groups=groups))
    return dict(preset=name, model=fit.model, split=True,
                sweep_f64=int(packed.hdr["H_SWEEP_F64"]), halves=halves,
                seconds=time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("presets", nargs="*")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from cosmax_torch._preset_index import PRESET_NOTES
    from cosmax_torch.ops.kernels.fused_log_prob import SWEEP_F64_RATIO

    names = args.presets or sorted(PRESET_NOTES)
    # one BLAS thread a process (the spawned workers read it at start)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(args.jobs, maxtasksperchild=1) as pool:
        rows = pool.map(survey, names, chunksize=1)
    selected = []
    for row in rows:
        if not row["split"]:
            print(f"{row['preset']}: {row['model']} in every model, no split grid")
            continue
        halves = "; ".join(f"half {h}: {x['cancellation']:.4g} ({x['group']})"
                           for h, x in enumerate(row["halves"]))
        print(f"{row['preset']}/w0wacdm: {halves}; H_SWEEP_F64 = {row['sweep_f64']} "
              f"(built and packed in {row['seconds']:.1f}s)")
        if row["sweep_f64"]:
            selected.append(row["preset"])
    split = [r for r in rows if r["split"]]
    below = [max(x["cancellation"] for x in r["halves"]) for r in split if not r["sweep_f64"]]
    print(f"{len(split)} w0wacdm bundles; the f64 sweep (above {SWEEP_F64_RATIO:g}): "
          f"{', '.join(selected) or 'none'}; the largest cancellation left to 3xTF32 "
          f"{max(below, default=0.0):.4g}; {time.perf_counter() - t0:.1f}s")
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
