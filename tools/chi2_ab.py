#!/usr/bin/env python3
"""Same-call A/B timing of the whitened chi^2 kernel across source trees,
on one CUDA card.

    python3 tools/chi2_ab.py TREE [TREE ...] [--variant NAME=VALUE ...]
                             [--walkers W] [--out FILE]

Each TREE is the root of a checkout of this repo (``.`` for this one; an
older commit unpacked with ``git archive``). Its
``cosmax_torch/csrc/whitened_chi2.cu`` is built with nvcc (its ``csrc/`` on
the include path) and its C entry is launched on the same inputs: at W
walkers (65,536), realistic residuals delta_w = z_w L^T with z ~ N(0, I)
and L the Cholesky factor of each SN covariance of the parity path
(Union2.1, Pantheon 2018, Pantheon+, Pantheon+ & SH0ES with the synthetic
systematics, DES-SN5YR: N = 580, 1048, 1590, 1657, 1829). Each tree's chi^2
is held against the plain version in f64 on the card (``chip_smoke.py``'s
RTOL_CHI2_F64) and timed with CUDA events (median of 20 runs), the trees
in the order given and then in reverse, so that ``parent change change
parent`` spreads the card's drift over both. Each ``--variant
NAME=VALUE`` also builds the first tree's source with the line ``constexpr
int NAME = ...;`` set to VALUE (e.g. ``STAGES=4``) and times it with the
trees. With ``--bitwise`` every tree's chi^2 must equal the first tree's
bit for bit (a change that must not move the square entry's arithmetic).
Prints one line per N with the card's name and power limit, and writes the
rows as JSON to ``--out``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATASETS = ("union21", "pantheon18", "pantheon_plus", "pantheon_plus_shoes", "des5y")


def _build(tree, tag, variant=None):
    """The tree's chi^2 kernel (with ``variant`` = (NAME, VALUE) set in its
    source) as a loaded library."""
    from cosmax_torch.ops.kernels import build

    src = os.path.join(tree, "cosmax_torch", "csrc", "whitened_chi2.cu")
    out_dir = os.path.join(ROOT, "build", "chi2_ab")
    os.makedirs(out_dir, exist_ok=True)
    if variant is not None:
        name, value = variant
        text = open(src).read()
        pat = re.compile(rf"constexpr int {name} = [^;]+;")
        if not pat.search(text):
            raise ValueError(f"{src} has no constexpr int {name}")
        src = os.path.join(out_dir, f"whitened_chi2_{tag}.cu")
        with open(src, "w") as f:
            f.write(pat.sub(f"constexpr int {name} = {value};", text))
    so = os.path.join(out_dir, f"whitened_chi2_{tag}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           os.path.join(tree, "cosmax_torch", "csrc"), "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return ctypes.CDLL(so)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--walkers", type=int, default=65536)
    ap.add_argument("--bitwise", action="store_true",
                    help="hold every tree's chi^2 equal to the first tree's bit for bit")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chi2_ab.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from cosmax_torch.data.loaders import load_sn, use_synthetic_sys
    from cosmax_torch.ops.kernels.whitened_chi2 import whitened_chi2_reference

    if not torch.cuda.is_available():
        raise RuntimeError("tools/chi2_ab.py needs a CUDA card")
    card = cs._card()
    libs = [_build(tree, i) for i, tree in enumerate(args.trees)]
    labels = list(args.trees)
    for v in args.variant:
        name, value = v.split("=")
        libs.append(_build(args.trees[0], f"{name}{value}", (name, value)))
        labels.append(f"{args.trees[0]}:{v}")
    order = list(range(len(libs)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    rows = []
    for ds in DATASETS:
        with use_synthetic_sys(True):
            sn = load_sn(ds)
        n, w = sn.n, args.walkers
        chol = torch.as_tensor(np.linalg.cholesky(sn.cov), device="cuda")
        z = torch.randn((w, n), generator=gen, device="cuda", dtype=torch.float64)
        delta = (z @ chol.T).float()
        del z, chol
        linv = torch.as_tensor(np.ascontiguousarray(sn.linv), device="cuda").float()
        want = whitened_chi2_reference(linv.double(), delta.double())
        times = {i: [] for i in order}
        errs, outs = {}, {}
        for pass_order in (order, order[::-1]):
            for i in pass_order:
                fn = lambda: cs._chi2_variant(libs[i], linv, delta)  # noqa: E731
                got = fn()
                torch.cuda.synchronize()
                outs[i] = got
                if args.bitwise and 0 in outs and not torch.equal(got, outs[0]):
                    raise AssertionError(f"{labels[i]} at N = {n} differs from {labels[0]}'s "
                                         "chi^2 bit for bit")
                errs[i] = float(((got.double() - want).abs() / want.abs()).max())
                if not errs[i] <= cs.RTOL_CHI2_F64:
                    raise AssertionError(f"{labels[i]} at N = {n}: max rel err {errs[i]:.3e}")
                times[i].append(cs._median_ms(fn))
        row = dict(n=n, dataset=ds, walkers=w, card=card, bitwise=bool(args.bitwise),
                   trees={f"{labels[i]}#{i}": dict(ms=times[i], max_rel_err_f64=errs[i])
                          for i in order})
        rows.append(row)
        print(f"chi2_ab N={n} ({ds}, W={w}) on {card}"
              + (" (every tree bit for bit the first's)" if args.bitwise else "") + ": " + "; ".join(
            f"{labels[i]} {' / '.join(f'{t:.4f}' for t in times[i])} ms (err {errs[i]:.3e})"
            for i in order), flush=True)
        del delta, linv, want
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
