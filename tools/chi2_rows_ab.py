#!/usr/bin/env python3
"""Same-call A/B timing of the chi^2 kernel's row-block entry across source
trees, on one CUDA card.

    python3 tools/chi2_rows_ab.py TREE [TREE ...] [--rounds R] [--walkers W]
                                  [--out FILE]

Each TREE is the root of a checkout of this repo (``.`` for this one; another
version unpacked with ``git archive``). Its
``cosmax_torch/csrc/whitened_chi2_rows.cu`` is built with nvcc (its ``csrc/``
on the include path; ptxas's register line is printed) and its C entry is
launched on ``chip_smoke.py`` phase 18's inputs: W walkers (65,536) of
realistic residuals delta_w = z_w L^T, L the Cholesky factor of DES-SN5YR's
covariance with the synthetic systematics (N = 1829), on this tree's row
blocks at d = 2 and d = 4 (``row_blocks``) and on all N rows. Every tree
reads the same split slab (this tree's ``split_rows``) through a tensor map
of its own library. Each block's share is held against the plain version in
f64 (``chip_smoke.py``'s RTOL_CHI2_F64), and whether it equals the first
tree's bit for bit is printed. Then R rounds: each round times
every tree on every block (CUDA events, median of 20 launches), the trees
in the order given in even rounds and reversed in odd ones, so that the
card's drift falls on both. Prints, with the card's name and power limit,
each block's median, least and most time of each tree over the rounds and,
for each later tree, its time over the first tree's within each round
(median, least, most); writes the rows as JSON to ``--out``.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _build(tree, tag):
    """The tree's row-block kernel as a loaded library, and ptxas's report
    on its kernel."""
    import chip_smoke as cs
    from cosmax_torch.ops.kernels import build

    src = os.path.join(tree, "cosmax_torch", "csrc", "whitened_chi2_rows.cu")
    out_dir = os.path.join(ROOT, "build", "chi2_rows_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"whitened_chi2_rows_{tag}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           os.path.join(tree, "cosmax_torch", "csrc"), "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return ctypes.CDLL(so), cs._ptxas_of(proc.stderr, "whitened_chi2_rows_kernel")


def _spread(xs):
    xs = sorted(xs)
    return dict(median=xs[len(xs) // 2], least=xs[0], most=xs[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--walkers", type=int, default=65536)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chi2_rows_ab.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from cosmax_torch.data.loaders import load_sn, use_synthetic_sys
    from cosmax_torch.device import disable_tf32
    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    if not torch.cuda.is_available():
        raise RuntimeError("tools/chi2_rows_ab.py needs a CUDA card")
    disable_tf32()
    card = cs._card()
    built = [_build(tree, i) for i, tree in enumerate(args.trees)]
    for tree, (_, ptxas) in zip(args.trees, built):
        print(f"chi2_rows_ab {tree}: ptxas whitened_chi2_rows_kernel {ptxas}", flush=True)
    libs = [lib for lib, _ in built]
    with use_synthetic_sys(True):
        sn = load_sn("des5y")
    w, n = args.walkers, sn.n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    chol = torch.as_tensor(np.linalg.cholesky(sn.cov), device="cuda")
    z = torch.randn((w, n), generator=gen, device="cuda", dtype=torch.float64)
    delta = (z @ chol.T).float()
    del z, chol
    linv = torch.as_tensor(np.ascontiguousarray(sn.linv), device="cuda").float()
    spans = sorted({(r0, r1) for parts in (2, 4)
                    for r0, r1 in zip(kmod.row_blocks(n, parts), kmod.row_blocks(n, parts)[1:])})
    spans.append((0, n))
    blocks, maps, errs, same = {}, {}, {}, {}
    for r0, r1 in spans:
        block = kmod.split_rows(linv[r0:r1, :r1].contiguous())
        blocks[r0, r1] = block
        maps[r0, r1] = [kmod.encode_tensor_map(lib, block) for lib in libs]
        want = kmod.whitened_chi2_rows_reference(block.unsplit().double(), delta.double())
        first = None
        for i, lib in enumerate(libs):
            got = cs._rows_launch(lib, block, maps[r0, r1][i], delta)
            first = got if first is None else first
            same[r0, r1, i] = bool(torch.equal(got, first))
            errs[r0, r1, i] = float(((got.double() - want).abs() / want.abs()).max())
            if not errs[r0, r1, i] <= cs.RTOL_CHI2_F64:
                raise AssertionError(f"{args.trees[i]} rows [{r0}, {r1}): vs f64 plain "
                                     f"{errs[r0, r1, i]:.3e}")
    times = {(span, i): [] for span in spans for i in range(len(libs))}
    order = list(range(len(libs)))
    for rnd in range(args.rounds):
        for i in (order if rnd % 2 == 0 else order[::-1]):
            for span in spans:
                times[span, i].append(cs._median_ms(
                    lambda: cs._rows_launch(libs[i], blocks[span], maps[span][i], delta)))
    rows = []
    for span in spans:
        row = dict(rows=list(span), walkers=w, n=n, card=card, rounds=args.rounds, trees={})
        for i, tree in enumerate(args.trees):
            ratio = [t / t0 for t, t0 in zip(times[span, i], times[span, 0])]
            row["trees"][f"{tree}#{i}"] = dict(ms=times[span, i], **_spread(times[span, i]),
                                               over_first=_spread(ratio),
                                               max_rel_err_f64=errs[(*span, i)],
                                               bits_of_first=same[(*span, i)])
        rows.append(row)
        print(f"chi2_rows_ab rows [{span[0]}, {span[1]}) (W={w}, N={n}) on {card}, "
              f"{args.rounds} rounds: " + "; ".join(
                  f"{tree} {v['median']:.4f} ms [{v['least']:.4f}, {v['most']:.4f}], "
                  f"over the first {v['over_first']['median']:.4f} "
                  f"[{v['over_first']['least']:.4f}, {v['over_first']['most']:.4f}], "
                  f"vs f64 {v['max_rel_err_f64']:.3e}, the first's bits {v['bits_of_first']}"
                  for tree, v in zip(args.trees, row["trees"].values())), flush=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
