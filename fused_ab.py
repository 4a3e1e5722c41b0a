#!/usr/bin/env python3
"""Same-call A/B timing of the fused log-prob kernel across source trees
and variants, on one CUDA card.

    python3 fused_ab.py TREE [TREE ...] [--variant QC=4 ...] [--out FILE]

Each TREE is the root of a checkout of this repo (``.`` for this one; an
older commit unpacked with ``git archive``). The trees run one after
another, each in its own process, in the order given, so that
``parent change change parent`` spreads the card's drift over both.
Each process imports that tree's ``cosmax_torch``, builds the fast
flagship (``bao.desi_cmb_des5y``/wzcdm) and, where the tree has them, the
fast ``joint.multiprobe``/wzcdm, the fast w0wacdm flagship and the fast
w0wacdm multiprobe (all with the dense synthetic SN covariance; a cold
w0wacdm multiprobe build takes minutes of the host), packs them with the
tree's own packer and times its own kernel: CUDA events, median of 20
samples of 20 calls, at 65,536 and 262,144 flagship walkers, 131,072
multiprobe walkers, 65,536 and 262,144 w0wacdm walkers and 131,072
w0wacdm multiprobe walkers, walkers drawn near the box centre as
``chip_smoke.py``'s bench draw, and 65,536 w0wacdm walkers and 131,072
w0wacdm multiprobe walkers uniform over the prior box (both halves of the
split grid); and, where the tree has them, ``bao.desi_bbn`` (r_d from
z_drag, the BBN prior) and ``bao.desi_omh2_theta_star`` (theta*, the Om
h^2 prior) at 262,144 wzcdm and 65,536 w0wacdm walkers of the bench draw,
``sn.des5y`` and ``qsr.des5y`` (a lift of 50 values) at 262,144 wzcdm,
``sn.pantheon_shoes`` and ``qsr.des5y`` at 65,536 w0wacdm, and ``cmb.cmb``
(no emulated term) at 262,144 lcdm walkers.
Each ``--variant NAME=VALUE`` also
builds that tree's source with the line ``constexpr int NAME = ...;``
set to VALUE (where the tree's source has that constant), and times it
in the same process, interleaved with the tree's own kernel (forward,
then reverse order). Every timed kernel is
first held against the tree's plain version (1e-4 of max|logp|), but for
the timing probes (``--variant PROBE=n``, the kernel with a part left out:
see ``PROBE`` in the source), which compute another function.

``--sass DIR`` also writes ``cuobjdump -sass`` of each built library,
gzipped, to DIR and prints, for the Tucker instance
(``fused_log_prob_kernel``), its instruction count by class and the size of
each loop body (each backward branch), so that a part's instructions a
walker are a body's size times its trip count.

Prints one JSON line per tree and kernel, and writes them all to
``--out`` (default ``build/fused_ab.json``).
"""

import argparse
import ctypes
import gzip
import json
import os
import re
import subprocess
import sys
import time

# (preset, model, walkers, draw): "bench" near the box centre, "uniform" over the box
SIZES = (("bao.desi_cmb_des5y", "wzcdm", 65536, "bench"),
         ("bao.desi_cmb_des5y", "wzcdm", 262144, "bench"),
         ("joint.multiprobe", "wzcdm", 131072, "bench"),
         ("bao.desi_cmb_des5y", "w0wacdm", 65536, "bench"),
         ("bao.desi_cmb_des5y", "w0wacdm", 262144, "bench"),
         ("bao.desi_cmb_des5y", "w0wacdm", 65536, "uniform"),
         ("joint.multiprobe", "w0wacdm", 131072, "bench"),
         ("joint.multiprobe", "w0wacdm", 131072, "uniform"),
         ("bao.desi_bbn", "wzcdm", 262144, "bench"),
         ("bao.desi_omh2_theta_star", "wzcdm", 262144, "bench"),
         ("bao.desi_bbn", "w0wacdm", 65536, "bench"),
         ("bao.desi_omh2_theta_star", "w0wacdm", 65536, "bench"),
         ("sn.des5y", "wzcdm", 262144, "bench"),
         ("sn.pantheon_shoes", "w0wacdm", 65536, "bench"),
         ("qsr.des5y", "wzcdm", 262144, "bench"),
         ("qsr.des5y", "w0wacdm", 65536, "bench"),
         ("cmb.cmb", "lcdm", 262144, "bench"))


def _median_ms(fn, reps=20, inner=20):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    times.sort()
    return times[len(times) // 2]


def _build_variant(tree, name, value):
    """Compile the tree's fused kernel source with one constant changed;
    returns (ctypes library, ptxas lines), or None where the tree's
    source has no such constant."""
    from cosmax_torch.ops.kernels import build

    src = open(os.path.join(tree, "cosmax_torch", "csrc", "fused_log_prob.cu")).read()
    pat = re.compile(rf"constexpr int {name} = [^;]+;")
    if not pat.search(src):
        return None
    out_dir = os.path.join(tree, "build", "fused_ab")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"fused_{name}{value}.cu")
    with open(cu, "w") as f:
        f.write(pat.sub(f"constexpr int {name} = {value};", src))
    so = cu[:-3] + ".so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           os.path.join(tree, "cosmax_torch", "csrc"), "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stderr}")
    return ctypes.CDLL(so), _ptxas(proc.stderr), so


# SASS opcodes by class, for the instruction counts of --sass
_CLASSES = (("mma", ("HMMA",)), ("f32", ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FCHK")),
            ("mufu", ("MUFU",)), ("shared", ("LDS", "STS")),
            ("global", ("LDG", "STG", "LDL", "STL")),
            ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC", "BAR")))


def _opclass(op):
    for name, ops in _CLASSES:
        if op.split(".")[0] in ops:
            return name
    return "int/other"


def _sass_loops(text, marker="fused_log_prob_kernel"):
    """{function: dict(count, classes, loops)} of the functions whose name
    holds ``marker`` (the Tucker instance, not the split one): the
    instruction count by class, and per backward branch the body it closes
    (first and last address, size, classes)."""
    import collections
    import re

    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        if marker not in name or "split" in name:
            continue
        instrs, labels = [], {}
        for ln in block.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", ln)
            if m:
                labels[m.group(1)] = len(instrs)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
            if m:
                body = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
                instrs.append((int(m.group(1), 16), body.split()[0] if body else "?", body))
        addr_index = {a: i for i, (a, _, _) in enumerate(instrs)}

        def classes(rows):
            return dict(collections.Counter(_opclass(op) for _, op, _ in rows))

        loops = []
        for i, (a, op, body) in enumerate(instrs):
            if not op.startswith("BRA"):
                continue
            m = re.search(r"`?\(?(\.L_x_\d+)\)?", body) or re.search(r"0x([0-9a-f]+)", body)
            if m is None:
                continue
            t = labels.get(m.group(1)) if m.group(1).startswith(".L") else addr_index.get(
                int(m.group(1), 16))
            if t is not None and t <= i:
                loops.append(dict(first=hex(instrs[t][0]), last=hex(a), size=i - t + 1,
                                  classes=classes(instrs[t:i + 1])))
        out[name] = dict(count=len(instrs), classes=classes(instrs), loops=loops)
    return out


def _sass(lib_path, out_dir, tag):
    """cuobjdump -sass of ``lib_path``, gzipped into ``out_dir``, and its
    Tucker loops (``_sass_loops``)."""
    from cosmax_torch.ops.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with gzip.open(os.path.join(out_dir, f"sass_{tag}.txt.gz"), "wt") as f:
        f.write(text)
    return _sass_loops(text)


def _ptxas(log):
    return "; ".join(ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln)


def run_tree(tree, variants, sass_dir=None):
    """One process: the tree's own kernel and its variants, timed."""
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    from cosmax_torch.configs import get_preset
    from cosmax_torch.device import disable_tf32
    from cosmax_torch.ops.kernels import fused_log_prob as fl
    from cosmax_torch.ops.kernels.build import load_kernel

    disable_tf32()
    own = load_kernel("fused_log_prob")
    kernels = {"own": (own.lib, _ptxas(own.log), own.path)}
    for v in variants:
        built = _build_variant(tree, *v.split("="))
        if built is not None:
            kernels[v] = built

    def call(lib, packed, theta, out):
        fn = fl._entry(lib)
        stream = torch.cuda.current_stream().cuda_stream
        if len(fn.argtypes) == 7:  # a tree from before the split grid
            err = fn(packed.buf.data_ptr(), packed.buf.numel(), theta.data_ptr(),
                     out.data_ptr(), theta.shape[0], packed.dim, stream)
        else:
            split = int(packed.hdr["H_SPLIT"])
            if hasattr(fl, "_stride"):
                stride = fl._stride(packed)
            else:  # a tree of the per-thread sweep: the largest padded bond
                stride = int(packed.hdr["H_BOND"]) if split else fl.MAX_RANK
            err = fn(packed.buf.data_ptr(), packed.buf.numel(),
                     packed.dev.data_ptr() if split else None, split, stride,
                     theta.data_ptr(), out.data_ptr(), theta.shape[0], packed.dim, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")

    fits = {}
    for preset, model, _, _ in SIZES:
        if (preset, model) not in fits:
            try:
                fits[preset, model] = get_preset(preset, model, fast=True, synthetic_sys=True,
                                                 device="cuda")
            except (KeyError, ValueError, NotImplementedError):
                fits[preset, model] = None  # the tree does not have this preset
    results = {k: {} for k in kernels}
    for preset, model, w, draw in SIZES:
        fit = fits[preset, model]
        if fit is None:
            continue
        packed = fl.pack(fit)
        rng = np.random.default_rng(0)
        lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
        if draw == "bench":
            walkers = 0.5 * (lo + hi) + 0.05 * (hi - lo) * rng.standard_normal((w, fit.spec.dim))
        else:
            walkers = lo + (hi - lo) * rng.uniform(0.0, 1.0, (w, fit.spec.dim))
        theta = torch.as_tensor(walkers.astype(np.float32), device="cuda")
        want = fl.fused_log_prob_reference(packed, theta)
        fin = torch.isfinite(want)
        scale = float(want[fin].abs().max())
        out = torch.empty(w, device="cuda")
        for key, (lib, _, _) in kernels.items():
            call(lib, packed, theta, out)
            if key.startswith("PROBE="):  # a probe computes another function
                continue
            if not torch.equal(torch.isfinite(out), fin):
                raise AssertionError(f"{tree} {key} {preset}/{model} W={w}: -inf rows differ")
            err = float((out[fin] - want[fin]).abs().max())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{tree} {key} {preset}/{model} W={w}: {err / scale:.3e}")
        order = list(kernels) + list(kernels)[::-1]
        for key in order:
            lib = kernels[key][0]
            ms = _median_ms(lambda: call(lib, packed, theta, out))
            label = preset if model == "wzcdm" else f"{preset}/{model}"
            label += "" if draw == "bench" else f" {draw}"
            results[key].setdefault(f"{label}@{w}", []).append(ms)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    for key, (_, ptxas, path) in kernels.items():
        line = dict(tree=tree, kernel=key, card=card.strip().splitlines()[0], ptxas=ptxas,
                    ms=results[key])
        if sass_dir:
            tag = f"{os.path.basename(os.path.normpath(tree))}_{key}".replace("=", "")
            line["sass"] = _sass(path, sass_dir, tag)
        print(json.dumps(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", default=os.path.join("build", "fused_ab.json"))
    ap.add_argument("--sass", default=None, metavar="DIR",
                    help="write each library's SASS to DIR and print the Tucker loops")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_tree(os.path.abspath(args.trees[0]), args.variant,
                 args.sass and os.path.abspath(args.sass))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("fused_ab.py needs a CUDA card")
    lines = []
    for tree in args.trees:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             *[f"--variant={v}" for v in args.variant],
             *([f"--sass={args.sass}"] if args.sass else [])],
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.abspath(tree)),
        )
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise RuntimeError(f"tree {tree} failed (exit {proc.returncode})")
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                print(ln, flush=True)
                lines.append(json.loads(ln))
        print(f"# {tree}: {time.perf_counter() - t0:.1f}s", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
