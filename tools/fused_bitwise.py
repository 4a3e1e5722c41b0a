#!/usr/bin/env python3
"""The fused log-prob kernel of this tree against another tree's, bit for
bit, on the same packed buffers, on one CUDA card.

    python3 tools/fused_bitwise.py TREE [--walkers W]

TREE is the root of another checkout (an older commit unpacked with
``git archive``) whose kernel reads this tree's buffer layout: the header
slots it knows at the same places (this tree may add slots after them),
every offset read from the header. Its ``cosmax_torch/csrc/
fused_log_prob.cu`` is built with nvcc; this tree's presets are built
fast with the dense synthetic SN covariance and packed by this tree's
packer; both kernels are launched through their C entries on the same
buffers and walkers (W near the box centre as ``chip_smoke.py``'s bench
draw, and W uniform over the prior box) and their outputs compared with
``torch.equal``. A bundle that takes this tree's f64 sweep
(``H_SWEEP_F64``) is skipped: the other tree has no such instance. Exits
non-zero if any output differs.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# (preset, model): the Tucker instance's branches and the split instance's
CASES = (("bao.desi_cmb_des5y", "wzcdm"), ("bao.desi_cmb_des5y", "w0wacdm"),
         ("joint.multiprobe", "wzcdm"), ("bao.desi_bbn", "wzcdm"), ("bao.desi_bbn", "w0wacdm"),
         ("bao.desi_omh2_theta_star", "w0wacdm"), ("sn.pantheon_shoes", "w0wacdm"),
         ("qsr.des5y", "wzcdm"), ("qsr.des5y", "w0wacdm"), ("qsr.pantheon", "wcdm"),
         ("sn.union3_cmb", "w0wacdm"), ("cmb.cmb", "lcdm"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--walkers", type=int, default=65536)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import build
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    if not torch.cuda.is_available():
        raise RuntimeError("tools/fused_bitwise.py needs a CUDA card")
    src = os.path.join(args.tree, "cosmax_torch", "csrc", "fused_log_prob.cu")
    out_dir = os.path.join(ROOT, "build", "fused_bitwise")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "fused_log_prob_other.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           os.path.join(args.tree, "cosmax_torch", "csrc"), "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    other = ctypes.CDLL(so)
    print(cs._card(), flush=True)
    differ = []
    for name, model in CASES:
        fit = get_preset(name, model, fast=True, synthetic_sys=True, device="cuda")
        packed = fl.pack(fit)
        if packed.hdr["H_SWEEP_F64"]:
            print(f"{name}/{model}: the f64 sweep, skipped", flush=True)
            continue
        parts = []
        for draw, walkers in (("bench", cs._flagship_walkers(fit, args.walkers, seed=7)),
                              ("uniform", cs._box_walkers(fit, args.walkers, seed=8))):
            theta = torch.as_tensor(walkers, device="cuda")
            mine = fl.fused_log_prob(packed, theta)
            theirs = cs._launch_variant(fl, other, packed, theta)
            torch.cuda.synchronize()
            same = torch.equal(mine, theirs)
            parts.append(f"{draw} {'bit for bit' if same else 'DIFFERENT'}")
            if not same:
                differ.append(f"{name}/{model} {draw}")
        print(f"{name}/{model} (instance {fl.instance(packed)}) at W={args.walkers}: "
              f"{', '.join(parts)}", flush=True)
    print(f"fused_bitwise: {len(CASES)} presets against {args.tree}: "
          f"{'every output bit for bit' if not differ else 'differ: ' + ', '.join(differ)}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
