#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cosmax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card and ``nvcc``;
without a card it raises before printing any result. Phases, each
raising on failure (non-zero exit):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the three CUDA sources from ``cosmax_torch/csrc`` (with the
   shared header ``tf32.cuh``): the chi^2 kernel, its row-block kernel and
   the fused kernel; twelve variants of the fused one's source for phases
   7, 9, 12, 14 and 16, two of the chi^2 kernel's for phases 3 and 15 and
   three of the row-block kernel's for phase 18 (one nvcc each, all in
   parallel) and print each ptxas report (the fused kernel's three
   instances: Tucker, split, split with the f64 sweep);
3. the chi^2 kernel (3xTF32 on the tensor cores) against its plain PyTorch
   version at the flagship shape (65,536 walkers x N = 1829) and at ragged
   shapes, rtol 5e-5, with a NaN row kept to its own row; on realistic
   residuals of DES-SN5YR's covariance (delta_w = z_w L^T) at (65,536,
   1829) against the plain version in f64 on the card, rtol
   RTOL_CHI2_F64 = 1e-6, where two planted faults (one TF32 pass; one
   accumulator over the whole K) must fail; kernel and plain (cuBLAS)
   times (CUDA events, median of 20 runs after warm-up) beside the bounds
   by operations (FFMA at the f32 peak, 3xTF32 at the TF32 peak) and by
   bytes (each input once; delta as often as the row tiles read it);
4. the ``bao.desi`` LCDM parity anchor, chi^2(h=0.690, Om=0.298) =
   10.2753 within 2e-3 in f32;
5. the flagship ``bao.desi_cmb_des5y``/wzcdm (dense synthetic 1829^2
   SN whitening) on 65,536 walkers: all finite, 64 walkers against the
   port's f64 CPU path within 1e-4 of max|logp|, kernel launched,
   evals/s and a profiler breakdown;
6. the CLI, ``cosmax_torch.fit.main``, 150 walkers x 20 steps on the
   flagship: finite chain, acceptance in (0, 1), and the kernel's launch
   count over that run;
7. the fast flagship (``fast=True``, the same dense synthetic SN
   covariance), the fused kernel's Tucker instance (its core contraction a
   block product on the tensor cores in 3xTF32): its ptxas line, shared
   memory a block and blocks an SM; the kernel against its plain version
   at 65,536, 262,144, 65,573 (a ragged last block), 70 and 1 walkers
   within 1e-4 of max|logp| (seeded out-of-box and NaN rows -inf in both),
   each term alone within 1e-4 of its own max|logp|, where two planted
   faults in the contraction's 3xTF32 (one TF32 pass, a_lo b_hi dropped)
   must fail; the other flagship-family presets in lcdm, wcdm and wzcdm
   (with their shared memory and blocks an SM), 64 walkers against the
   port's f64 CPU fast path, kernel and plain times (CUDA events, median
   of 20) with the bound (the contraction's products at the TF32 peak,
   the all-f32 bound beside it), a profile of one call, and the kernel
   launched by ``fit.log_prob()``;
8. the CLI with ``--fast``, 150 walkers x 20 steps: finite chain,
   acceptance in (0, 1), at least two fused launches per step;
9. the fast multiprobe joint (``joint.multiprobe``/wzcdm, ``fast=True``,
   the dense synthetic SN covariance): its build, ranks and constants;
   the fused kernel against its plain version at 131,072, 65,573, 70 and
   1 walkers within 1e-4 of max|logp| (a seeded out-of-box ``s`` and a NaN
   row -inf in both), each of its terms alone at 131,072 walkers within
   1e-4 of that term's own max|logp| (and a quasar lift with its B_t
   zeroed, and the two planted 3xTF32 faults of phase 7, must fail that
   check), on all 12 configurations of ``joint.multiprobe``,
   ``fs8.fs8``, ``cc.cc_union3`` and ``cc.cc_des5y`` at 4,096 walkers,
   64 walkers against the port's f64 CPU fast path (and the gap to its
   parity path), kernel and plain times at 131,072 walkers with the
   bound, and ``fit.log_prob()`` end to end with its launch count;
10. the parity multiprobe joint on the card (the growth ODE's RK4 loop,
   the CC and fs8 chi^2 through the chi^2 kernel): 4,096 walkers all
   finite, 64 walkers against the f64 CPU parity path, the time per call;
11. the CLI with ``--fast`` on the multiprobe joint, 256 walkers x 20
   steps: a finite (256, 11) chain, acceptance in (0, 1), at least two
   fused launches per step;
12. the fast w0wacdm flagship (``bao.desi_cmb_des5y``/w0wacdm,
   ``fast=True``, the dense synthetic SN covariance), the fused kernel's
   split-grid branch (its tensor-train sweep as block products on the
   tensor cores in 3xTF32): the build time, each half's tensor-train
   ranks, the shared and device bytes of its constants and a block's
   shared memory, ptxas; the kernel against its plain version within 1e-4
   of max|logp| at 65,536 and 262,144 walkers of the bench draw, 65,536
   uniform over the box, 65,573 of the bench draw (a ragged last block),
   65,536 whose halves alternate walker by walker,
   65,536 all in half 1, a seam batch with |w0 + wa| < 1e-4 on both
   sides, 70 and 1 walkers (seeded out-of-box and NaN rows -inf in both),
   65,536 bench-style walkers about a centre in half 1, blocks of 112 +
   16 and 96 + 32 walkers a half, and the rows the grouping by half
   padded on the uniform draw; each term alone within 1e-4 of its own
   max|logp| (the CMB also on walkers with w0 + wa > 1.5); the terms the
   sweep feeds each alone on the bench draws of both halves, where two
   planted faults in the sweep's 3xTF32 (one TF32 pass, a_lo b_hi
   dropped) must fail; the kernel built with NCOL = 16 (the column passes
   of bonds wider than NCOL) against its plain version; a planted swap of
   the halves' select that must fail; 64 walkers over both halves
   against the port's f64 CPU fast path; ``bao.desi`` in w0wacdm at
   4,096 walkers (bench and uniform draws); kernel and plain times with
   the bound (the sweep's products at the TF32 tensor-core peak, the rest
   at the f32 peak; the bound with every operation at the f32 peak beside it);
   ``fit.log_prob()`` end to end with its launch count; and the
   CLI with ``--fast --model w0wacdm --synthetic-sys`` (the build of this
   phase), 150 walkers x 20 steps, a finite (150, 7) chain;
13. the fast w0wacdm multiprobe joint (``joint.multiprobe``/w0wacdm,
   ``fast=True``, the dense synthetic SN covariance), every form kind of
   the split instance (linear BAO, SN and CC, the quasar lift, the fs8
   amplitude pair) with the CMB: the build's seconds (per half and
   curve, the growth ODE's tables among them), each half's ranks and
   bonds, R_all, a block's shared memory (the packer's count against the
   runtime's) and blocks an SM, ptxas; the kernel against its plain
   version within 1e-4 of max|logp| at 131,072 walkers of the bench draw,
   131,072 uniform over the box, 131,072 bench-style about a centre in
   half 1, 65,536 and 65,573 (ragged) of the bench draw, 70 and 1; each
   term alone within 1e-4 of its own max|logp| on the bench draws of both
   halves (where the planted faults in the sweep's 3xTF32 must fail) and
   on the uniform draw; 64
   walkers (32 a half) against the port's f64 CPU fast path; kernel and
   plain times with the bound at 131,072 bench and uniform and 65,536
   bench; ``fit.log_prob()`` end to end with its launch count;
   ``cc.cc`` (the Om h^2 prior) in the four models at 4,096 walkers,
   bench and uniform draws, whole and each term alone; and the CLI with
   ``--fast --model w0wacdm --synthetic-sys`` on the multiprobe (the
   build of this phase), 256 walkers x 20 steps, a finite (256, 12) chain;
14. the BAO family (the 17 ``bao.*`` presets beyond ``bao.desi`` and the
   BAO + CMB + SN joints) and the fused kernel's #1e branches (K1 the
   scalar priors, Om h^2 or BBN omega_b; K2 the walker's r_d, from
   r_s(z_drag) by GL-128 or a drag fitting formula; K3 the 100 theta*
   prior in the CMB block; K4 the H0-free fit; K5 w0 = log(exp_w0)): each
   preset fast in wzcdm at 4,096 walkers, the kernel against its plain
   version within 1e-4 of max|logp| (seeded out-of-box and NaN rows -inf
   in both), 64 walkers against the port's f64 CPU fast path, and its
   parity path on the card at 1,024 walkers against the f64 CPU parity
   path; in lcdm, wcdm and w0wacdm each preset's parity path on the card
   against the f64 CPU one at 256 walkers, and in lcdm and wcdm its fast
   path against the plain version at 4,096 (w0wacdm: the branch presets
   below); each branch on a preset that needs it in the four models (K3
   also with Hu & Sugiyama's z*), whole and each term alone within 1e-4
   of its own max|logp| (in w0wacdm also uniform over the box); three
   planted faults (the z_drag quadrature cut to 64 of its 128 nodes,
   theta*'s z* formula swapped, the BBN sigma taken as the Om h^2
   prior's) that their term's check alone must catch in both instances;
   ``bao.desi_bbn`` and ``bao.desi_omh2_theta_star`` timed at 262,144
   wzcdm and 65,536 w0wacdm walkers (kernel and plain, the bound, the
   kernel with its branch left out, shared memory a block and blocks an
   SM, ``fit.log_prob()`` end to end with its launch count); the phase's seconds; and the CLI with ``--fast`` on
   ``bao.desi_bbn``, 150 walkers x 20 steps, a finite (150, 4) chain;
15. the SN family (the ten ``sn.*`` presets) and the rest of ``cc.*``
   (``cc.cc_pantheon``, ``cc.cc_plain``, ``cc.cc_cmb``), every preset with
   the dense synthetic SN factors: the parity path of each in wzcdm
   (``cc.cc_cmb`` is lcdm) at 1,024 walkers, all finite, 64 of them
   against the f64 CPU parity path within 1e-4 of max|logp|, the chi^2
   kernel's launches counted; the chi^2 kernel against its plain version
   at (65,536, N) on the factors of Union2.1, Pantheon 2018, Pantheon+
   and Pantheon+ & SH0ES (N = 580, 1048, 1590, 1657), rtol 5e-5, and on
   realistic residuals of each covariance against the f64 plain version
   as in phase 3 (the planted faults at N = 580), with kernel and plain
   (cuBLAS) times and the bounds; the fast path of each
   in wzcdm at 4,096 walkers, the fused kernel against its plain version
   whole and each term alone within 1e-4 of max|logp| (seeded out-of-box
   and NaN rows -inf in both), 64 walkers against the f64 CPU fast path;
   the presets of new structure (``sn.pantheon_shoes``, ``sn.des5y_cmb``,
   ``sn.union21``, ``sn.des5y``, ``cc.cc_plain``) the same way in lcdm,
   wcdm and w0wacdm (w0wacdm also uniform over the box) and on the
   parity path at 256 walkers; ``sn.des5y`` and ``sn.des5y_cmb`` at
   262,144 wzcdm and ``sn.pantheon_shoes`` at 65,536 w0wacdm walkers
   timed (kernel, plain, bound, shared memory a block, blocks an SM,
   ``fit.log_prob()`` end to end with its launch count); the phase's
   seconds; and the CLI with ``--fast --synthetic-sys`` on
   ``sn.pantheon_shoes``, 500 walkers x 20 steps, a finite (500, 4)
   chain, and on the parity path on ``cc.cc_pantheon`` (SN and CC through
   the chi^2 kernel), 150 walkers x 20 steps, a finite (150, 5) chain;
16. the last six presets (the five ``qsr.*`` and ``cmb.cmb``) and the
   fused kernel's branches they take (a lift of more than MAX_K values,
   ``qsr.des5y``'s 50 quasar bins, in chunks; a fit with no emulated term,
   ``cmb.cmb``; a Tucker outer axis of rank above 16, ``qsr.pantheon``'s
   w0 axis in wcdm): the parity path of each in wzcdm (``cmb.cmb`` lcdm)
   at 1,024 walkers, all finite, 64 against the f64 CPU parity path; the
   fast path of each in lcdm, wcdm, wzcdm and w0wacdm (``cmb.cmb`` in
   lcdm; ``qsr.pantheon`` and ``qsr.union3`` not in w0wacdm) at 4,096
   walkers (w0wacdm also uniform over the box), the fused
   kernel against its plain version whole and each term alone (the
   50-value lift alone among them) within 1e-4 of max|logp|, 64 walkers
   against the f64 CPU fast path; near the published point of
   ``qsr.desi`` and ``qsr.des5y_desi`` in w0wacdm, whose bundles the packer
   gives the split kernel's f64 sweep (``H_SWEEP_F64``; no other bundle of
   the run takes it), the kernel's float32 log-prob within 1e-4 of
   max|logp| of the f64 CPU fast path, whole and the BAO alone, where the
   kernel with the f64 sweep forced off (a planted variant: the 3xTF32
   sweep) must fail, with the plain version's error, the BAO table's scale
   and the kernel's time at 65,536 walkers with each sweep (and the bound,
   the sweep's products at the f64 tensor cores' peak); three planted faults (the
   lift's second chunk left out, one of the CMB's three residuals
   dropped, an outer axis past rank 16 projected as rank 16) that must
   fail; ``qsr.des5y`` at 262,144 wzcdm and 65,536 w0wacdm and
   ``cmb.cmb`` at 262,144 lcdm and ``qsr.pantheon`` (its outer axis of
   rank 20) at 262,144 wcdm walkers timed (kernel, plain, bound,
   shared memory a block, blocks an SM, ``fit.log_prob()`` end to end
   with its launch count; ``qsr.des5y`` also without the lift's second
   chunk); the CLI with ``--fast`` on ``qsr.des5y``, 150 walkers x 20
   steps, a finite (150, 5) chain; and ``sn.union3_cmb`` in w0wacdm (its
   half 1 left Tucker by the compressor, packed as a tensor train) at
   4,096 walkers (bench and uniform draws) against the plain version and
   the f64 CPU fast path, with its build seconds.

17. gradients and the gradient samplers: (a) the chi^2 kernel's autograd
   Function on realistic residuals (delta = z L^T, DES-SN5YR's and
   Union2.1's L, 4,096 walkers) against the f64 plain version's autograd,
   |dg| / |g| per walker within 1e-4, where the planted fault (the
   backward's second product taken with Linv^T) must fail, and a finite
   Hessian-vector product through the Function; (b) ``value_and_grad`` of
   the parity flagship, the fast flagship in wzcdm and w0wacdm,
   ``joint.multiprobe``/wzcdm fast and ``qsr.desi``/w0wacdm fast in
   float32 on the card against f64 autograd on the CPU at 4,096 bench
   walkers, whole and each term alone, max |dg| within 1e-3 of max |g| per
   parameter, where the CMB term detached must fail; (c) ``--sampler hmc``
   through the CLI, 512 chains, on ``bao.desi`` lcdm (parity) and the
   fast flagship in lcdm: medians within 0.1 sigma (``bao.desi``: the
   published rows; the flagship: the f64 Laplace fit of the same
   likelihood, since its published rows were run with DES-SN5YR's
   systematic covariance, which the data store lacks; the published
   distance printed), split R-hat < 1.01, divergences and warmup retries
   printed, and a kernel launch in every gradient evaluation (the fused
   kernel once, the chi^2 kernel once per whitened term) (the parity
   flagship's HMC runs in phase 18's dry run); (d)
   ``--fast`` ensemble and HMC runs in two checkpointed CLI calls equal to
   the straight run bit for bit; (e) ``python -m cosmax_torch.compare
   --preset bao.desi`` (chi^2_min 10.27 / 9.04 / 8.43 / 5.62 within 0.01)
   and with ``--sampled-evidence --replicates 2 --models lcdm,wzcdm`` (the
   ln Z difference within 3x its +- plus 0.05 of Laplace's); (f) times:
   ``value_and_grad`` split into the fused kernel and the per-term
   autograd (4,096 and 65,536 fast flagship walkers), the parity
   flagship's at 4,096 with the chi^2 forward kernel and the backward's
   matmuls, gradient evaluations per second of each HMC run, each part's
   seconds and the phase's.
18. the multi-GPU path: (a) the chi^2 kernel's row-block kernel (the
   rows [r0, r1) of L^-1 from the slab L^-1[r0:r1, :r1], split once into
   TF32 halves; ``csrc/whitened_chi2_rows.cu``, wgmma on TMA tiles) at
   (65,536, 1829) on realistic residuals of DES-SN5YR's covariance, for d
   = 2 and d = 4 blocks by equal work (boundaries N sqrt(k/d) rounded to
   8 rows): each block against its plain version (rtol 5e-5), its f64
   plain version (RTOL_CHI2_F64) and on a ragged batch, one launch a call
   (the launch counts), a repeat launch equal bit for bit, the blocks' sum
   against the square kernel (1e-6 a walker), three planted faults that
   must fail (a block's diagonal skip from its local row 0; the trailing
   tile's rows past its last multiple of 8 dropped; the lo terms dropped,
   one TF32 pass), each block's time (its split kept, and split at every
   call) beside the square kernel's, its 3xTF32 bound and cuBLAS's, the
   slowest block's share of the square time, and the row-block kernel at
   (0, N) beside the square kernel, for the record; (b) the port of ``dryrun_multichip``
   (``cosmax_torch.dryrun``) under NCCL at world size 1 in this process:
   the parity flagship's sharded log-prob (the SN rows through the
   row-block entry) at 65,536 walkers against ``fit.log_prob()`` within
   1e-6 of max|logp|, the fast flagship (wzcdm, w0wacdm) at 262,144 and
   the fast multiprobe (lcdm) at 131,072 bit for bit (and a block of
   walkers from walker 37, against the whole call's, bit for bit), a
   sharded ensemble step, an 8-step chain resumed from a checkpoint, 4 HMC
   steps (the sharded potential) and their checkpoint resume, a step of
   each fast fit, the stepping-stone ladder, every kernel launched; (c)
   the same on a gloo pair, both ranks on cuda:0, mesh w = 1 x d = 2 (each
   rank launches the row-block kernel on its own rows and the fused kernel
   on its walkers), spawned with a ``file://`` rendezvous: its results
   against world size 1 (the parity log-prob and the chains' log-probs
   within 1e-6 of max|logp|, the chain's walkers and the fast calls bit
   for bit).
19. the outer layers (``phase_outer``): (a) the GP reconstruction of
   H(z) (``cosmax_torch.gp.reconstruct_hz``, 5,000 Adam steps in float32)
   against the published lengthscale 2.366 +- 0.05, noise_scale 0.489 +-
   0.03, H0 67.5 +- 2 (2 < sigma < 8), q(0) < 0 < q(z_max), and against the
   port's f64 CPU run at the same steps (H mean and sigma on the grid
   within 1e-3 relative), with its seconds and Adam steps a second; (b) the
   quintessence field ``reconstruct(0.307, -0.833)`` against the f64 CPU
   within 1e-4 of each array's max|value|; (c) the emcee facade
   (``cosmax_torch.compat``) over the fast flagship's ``fit.log_prob()``,
   64 walkers x 200 steps: a finite chain, acceptance in (0, 1), at least
   two fused launches a step, the same seed twice bit for bit, an
   ``NpzBackend`` run stopped after 100 steps and resumed equal to the
   straight run bit for bit; (d) ``fit.main --out`` on the fast flagship
   (64 x 20, --no-plots: the summary's derived and residual blocks, fused
   launches) and on ``sn.pantheon`` parity (150 x 20: the HTML Hubble
   diagram with --no-plots, chi^2 kernel launches; again with the figures
   where matplotlib is installed, whose presence is printed); (e)
   ``tools/torch_profile_terms.py`` on the fast flagship at 65,536 walkers
   and the parity flagship at 4,096 (each term's ms, both kernels'
   launches); (f) ``timed_evals`` of ``fit.log_prob()`` against CUDA events
   over the same calls (within 10%) and a ``profile_trace`` file.
20. the last tools (``phase_tools``, cut to the phase's time): (a)
   ``tools/torch_evidence_convergence.py`` on the fast flagship in lcdm (2
   replicate ladders, base budget 6 + 6, one doubling, golden x2): each
   stage's ln Z +- error, the worst rung's split R-hat, seconds and fused
   launches, a finite ln Z and at least one fused launch a stage; (b)
   ``tools/torch_warmup_sweep.py``, one seed at 128 chains and 30 warmup
   steps on the same fit: rejuvenated, retries, divergent, gradient
   evaluations a second, at least one fused launch a gradient evaluation;
   (c) ``tools/torch_precheck_rows.py`` on ``bao.desi``, ``cc.cc`` and
   ``bao.desi_union3_omh2`` (its dM profiled out) in lcdm, rows that the
   JAX precheck passes: chi^2 at the published medians (f64 on the host)
   finite and within the tool's flag (0.6) of the published chi^2; (d)
   ``cc.cc_pantheon`` in w0wacdm, fast, at 4,096 walkers (bench and uniform
   draws, seeded out-of-box and NaN rows): the kernel against its plain
   version within 1e-4 of max|logp|, whole and each term alone, and 64
   walkers (half 1's among them) against the f64 CPU fast path within
   1e-4.

Phase 12 was cut for phase 20's time: ``bao.desi_cmb_union3`` and
``bao.desi_cmb_pantheon`` in w0wacdm left it (builds of ~19 s each; their
forms, an SN form with dM or with M and H0 beside the BAO and the CMB,
are the w0wacdm flagship's and ``sn.pantheon_shoes``'s), and its CLI run
takes ``--synthetic-sys``, the build the phase made (~17 s).
Phases 13, 16 and 17 were cut for phase 18's time: ``fs8.fs8``,
``cc.cc_union3`` and ``cc.cc_des5y`` in w0wacdm left phase 13 (fs8.fs8's
~190 s growth-ODE build; their kernel branches are the w0wacdm
multiprobe's), ``qsr.pantheon`` and ``qsr.union3`` in w0wacdm left phase
16 (their one-chunk lift in the split instance is held by ``qsr.des5y``),
the 64-chain parity flagship HMC left phase 17 (phase 18's dry run runs
that potential). Each phase's seconds are printed at the end.

Phase 3 also holds the chi^2 kernel against its plain version at
(4,096, 33) and (4,096, 66), the CC and fs8 parity shapes.

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
ROWS_SOURCE = "cosmax_torch/csrc/whitened_chi2_rows.cu"
FUSED_REPLACES = "cosmax/ops/pallas/megakernel.py:99"
FUSED_SOURCE = "cosmax_torch/csrc/fused_log_prob.cu"
RTOL_KERNEL = 5e-5  # as tests/test_pallas_ops.py for the TPU kernel
# the chi^2 kernel on realistic residuals, delta_w = z_w L^T with z ~ N(0, I)
# and L the Cholesky factor of an SN covariance, against the plain version
# in f64 on the card, per walker: the cancellation inside Linv delta that
# correlated residuals bring, where a CPU emulation of the arithmetic puts
# 3xTF32 at ~4e-8, f32 at ~1.3e-7 and one pass of TF32 at >= 8e-5
# (tests/test_torch_chi2_emulation.py)
RTOL_CHI2_F64 = 1e-6
ANCHOR_CHI2, ANCHOR_ATOL = 10.2753, 2e-3
LOGP_RTOL = 1e-4  # f32 card vs f64 CPU, relative to max|logp|
# fused kernel vs its plain version, both f32 on the card: different
# summation orders, relative to max|logp|
FUSED_RTOL = 1e-4
BENCH_WALKERS, N_SN = 65536, 1829
BIG_WALKERS = 262144  # the flagship size of bench.py
MP_WALKERS = 131072  # the multiprobe size of bench.py
MP_PARITY_WALKERS = 4096
NEW_FAST = ("joint.multiprobe", "fs8.fs8", "cc.cc_union3", "cc.cc_des5y")
W0WA_OTHERS = ("bao.desi",)
# the card's peaks for the bound: H100 SXM f32 non-tensor FLOP/s, dense
# TF32 tensor-core FLOP/s and HBM3 bytes/s; and the f64 tensor cores'
PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 67e12, 495e12, 3.35e12
PEAK_F64_TC_FLOPS = 67e12
# variants of the fused kernel's source, built beside it (phase 2) for
# phases 7, 9, 12 and 14, each as (text, replacement) edits: two planted faults that its
# checks must catch (one TF32 pass, or one of the two small terms of
# 3xTF32 dropped), and a narrow column pass that makes the flagship's
# bonds (at most 56 columns) take the kernel's path for bonds wider than
# NCOL: several column passes, v_out at the far end of the sweep's rows
LO_MMA = ("mma_tf32(part[t][j], alo[t], bhi0, bhi1);", "mma_tf32(part[t][j], ahi[t], blo0, blo1);")
PLANTED = {"one TF32 pass": tuple((m, "(void)0;") for m in LO_MMA),
           "a_lo b_hi dropped": ((LO_MMA[0], "(void)0;"),)}
# the same two faults in the Tucker instance's contraction (phases 7 and 9)
TUCKER_LO_MMA = ("mma_tf32(d[t][jj], alo[s][t], bhi0, bhi1);",
                 "mma_tf32(d[t][jj], ahi[s][t], blo0, blo1);")
TUCKER_PLANTED = {"Tucker one TF32 pass": tuple((m, "(void)0;") for m in TUCKER_LO_MMA),
                  "Tucker a_lo b_hi dropped": ((TUCKER_LO_MMA[0], "(void)0;"),)}
NARROW_NCOL = 16
# the split kernel's f64 sweep (H_SWEEP_F64) forced off: the bundles that
# the packer gives it run the 3xTF32 sweep instead (phase 16 must catch it)
F64_SWEEP_OFF = "the f64 sweep forced off"
F64_SWEEP_OFF_EDITS = (("  return launch(split, consts,", "  return launch(split == 2 ? 1 : split, consts,"),)
# planted faults of the chi^2 kernel (whitened_chi2.cu), built in phase 2:
# each must fail the realistic-residual check (RTOL_CHI2_F64) at N = 580 and
# N = 1829
CHI2_PLANTED = {
    "chi^2 one TF32 pass": (
        ("mma_tf32(part[i][n], alo[i], bhi[n][0], bhi[n][1]);", "(void)0;"),
        ("mma_tf32(part[i][n], ahi[i], blo[n][0], blo[n][1]);", "(void)0;")),
    "chi^2 one accumulator over the whole K": (
        ("fold(acc, part);", "if (last) fold(acc, part);"),),
}
CHI2_PLANTED_AT = (580, 1829)
# phase 18: the chi^2 kernel's row-block kernel, its blocks by equal work
# over d ranks, and planted faults of its source (built in phase 2) that
# the f64 check of d = 2's second block must catch: the diagonal skip
# counted from the block's local row 0; the trailing tile's rows past its
# last multiple of 8 dropped (the tensor map's rows rounded down, so that
# the TMA reads them as zeros); the lo terms dropped, which leaves one TF32
# pass
ROWS_PARTS = (2, 4)
CHI2_ROWS_PLANTED = {
    "a block's diagonal skip from its local row 0": (
        ("  const long long g1 = sh.row0 + min(", "  const long long g1 = min("),),
    "the trailing tile's rows past a multiple of 8 dropped": (
        ("static_cast<cuuint64_t>(rows), 2};", "static_cast<cuuint64_t>(rows / 8 * 8), 2};"),),
    "the lo terms dropped (one TF32 pass)": (
        ("wgmma_n128(part, alo[kk], bhi + 2 * kk, kk > 0);", "(void)0;"),
        ("wgmma_n128(part, ahi[kk], blo + 2 * kk, 1);", "(void)0;"),
        ("wgmma_n128(part, ahi[kk], bhi + 2 * kk, 1);",
         "wgmma_n128(part, ahi[kk], bhi + 2 * kk, kk > 0);")),
}
# the dry run (cosmax_torch/dryrun.py; its chains take max(4 x world size,
# 8) walkers, 8 at world sizes 1 and 2, so both runs take the same chains):
# its held evaluations at BENCH_WALKERS (parity), 2x (multiprobe) and 4x
# (the fast flagships), and the pair's time limit
DRYRUN_PAIR_TIMEOUT = 400
RAGGED = BENCH_WALKERS + 37  # a last block of 37 walkers
# phase 19: the GP's Adam steps (the reference's 5,000), its float32 card run
# against the port's f64 CPU run (H mean and sigma, relative, each grid
# point), the field against f64 (of each array's max|value|), the facade,
# and the back-to-back calls of the profiler trace
GP_STEPS, GP_RTOL, FIELD_RTOL = 5000, 1e-3, 1e-4
FACADE_WALKERS, FACADE_STEPS = 64, 200
TRACE_CALLS = 20
# phase 14: the BAO family, and the fused kernel's #1e branches, each on one
# preset that needs it, in the four models: (label, preset, its options)
BAO_FAMILY = ("bao.sdss", "bao.desi_omh2", "bao.desi_bbn", "bao.desi_bbn_theta_star",
              "bao.desi_omh2_theta_star", "bao.desi_cc", "bao.desi_cmb", "bao.desi_pantheon",
              "bao.desi_union3", "bao.desi_des5y", "bao.desi_pantheon_cc", "bao.desi_union3_cc",
              "bao.desi_des5y_cc", "bao.desi_union3_bbn", "bao.desi_des5y_bbn",
              "bao.desi_union3_omh2", "bao.desi_des5y_omh2")
BRANCHES = (("K1 BBN prior, K2 r_s(z_drag)", "bao.desi_bbn", {}),
            ("K2 r_drag (DESI, n_eff 3.04)", "bao.desi_des5y_bbn", {}),
            ("K3 theta*", "bao.desi_omh2_theta_star", {}),
            ("K3 theta* (z* of Hu & Sugiyama)", "bao.desi_omh2_theta_star", {"z_star": "hu"}),
            ("K4 H0-free", "bao.desi_des5y", {}),
            ("K5 exp(w0)", "bao.desi_pantheon", {}))
MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")
# phase 16's presets whose w0wacdm fast path left the phase for phase 18's
# time (a build of ~20 s each): their split-instance path, a
# one-chunk quasar lift beside an SN form, is held by qsr.des5y in w0wacdm
# (a two-chunk lift, timed) and by qsr.desi / qsr.des5y_desi (the f64 sweep)
QSR_NO_W0WA = ("qsr.pantheon", "qsr.union3")
FAMILY_WALKERS, FAMILY_PARITY_WALKERS = 4096, 1024
# phase 15: the SN family and the rest of cc.*, the presets among them of a
# structure no earlier preset had (held in the four models), and the timing
# rows (preset, model, walkers)
SN_FAMILY = ("sn.pantheon", "sn.pantheon_shoes", "sn.union3", "sn.des5y", "sn.union21",
             "sn.pantheon18", "sn.des5y_bins", "sn.pantheon_cmb", "sn.union3_cmb",
             "sn.des5y_cmb", "cc.cc_pantheon", "cc.cc_plain", "cc.cc_cmb")
SN_NEW_STRUCTURE = ("sn.pantheon_shoes", "sn.des5y_cmb", "sn.union21", "sn.des5y", "cc.cc_plain")
SN_TIMING = (("sn.des5y", "wzcdm", BIG_WALKERS), ("sn.des5y_cmb", "wzcdm", BIG_WALKERS),
             ("sn.pantheon_shoes", "w0wacdm", BENCH_WALKERS))
# phase 16: the last six presets (cmb.cmb is lcdm in every model); the
# presets of phases 14-15 whose w0wacdm fast path runs on the card nowhere
# else and takes a path of its own: sn.union3_cmb, whose half 1 the
# compressor leaves Tucker (packed as a tensor train); and the timing rows
# (preset, model, walkers)
QSR_FAMILY = ("qsr.pantheon", "qsr.union3", "qsr.desi", "qsr.des5y_desi", "qsr.des5y", "cmb.cmb")
# the published lcdm medians (BASELINE.md) of the two presets whose w0wacdm
# fast path is ill-conditioned in float32 (ROADMAP queue 3), w0 = -1, wa = 0
QSR_PUBLISHED = {"qsr.desi": dict(dM_qsr=-0.197, s=0.408, rd=144.857, Om=0.299),
                 "qsr.des5y_desi": dict(dM_qsr=-0.181, s=0.402, dM=-0.003, rd=143.48,
                                        Om=0.312)}
QSR_TIMING = (("qsr.des5y", "wzcdm", BIG_WALKERS), ("qsr.des5y", "w0wacdm", BENCH_WALKERS),
              ("cmb.cmb", "lcdm", BIG_WALKERS), ("qsr.pantheon", "wcdm", BIG_WALKERS))
# planted faults of phase 16's three branches (variants built in phase 2):
# (edits, preset, its models, the ``_term_alone`` key of the term whose
# check alone must fail: "lift" for the quasar form, None for the CMB,
# "whole" for the whole fit)
QSR_PLANTED = {
    "the lift's second chunk left out": (
        (("for (int k0 = 0; k0 < K; k0 += MAX_K) {",
          "for (int k0 = 0; k0 < min(K, MAX_K); k0 += MAX_K) {"),),
        "qsr.des5y", ("wzcdm", "w0wacdm"), "lift"),
    "one of the CMB's three residuals dropped": (
        (("for (int i = 0; i < 3; ++i) {", "for (int i = 0; i < 2; ++i) {"),),
        "cmb.cmb", ("lcdm",), None),
    # qsr.pantheon's w0 axis in wcdm, rank 19-20: the outer axis
    "an outer axis past rank 16 projected as rank 16": (
        (("project_axis<MAX_RANK_OUTER>(x, nodes, bw, u, n, rows, wp_out);",
          "project_axis<16>(x, nodes, bw, u, n, rows, wp_out);"),),
        "qsr.pantheon", ("wcdm",), "whole"),
}
# planted faults of the #1e branches (variants of the source built in phase
# 2): (edits, preset, the ``_term_alone`` key of the term whose check alone
# must fail: its form's index, None for the theta* block, "prior")
BAO_PLANTED = {
    "z_drag quadrature cut to 64 of its 128 nodes": (
        (("const int n = static_cast<int>(s[H_RD_N]);", "const int n = 64;"),),
        "bao.desi_bbn", 0),
    "theta*'s z* formula swapped (Aizpuru <-> Hu)": (
        (("if (static_cast<int>(c[C_ZSTAR]) == 1) {", "if (static_cast<int>(c[C_ZSTAR]) != 1) {"),),
        "bao.desi_omh2_theta_star", None),
    # the two scalar priors share the sigma slot: the fault takes the BBN
    # sigma as the Om h^2 prior's (Planck 0.0011)
    "BBN sigma taken as the Om h^2 prior's": (
        (("const float d = (s[H_PRIOR_MEAN] - x) / s[H_PRIOR_SIGMA];",
          "const float d = (s[H_PRIOR_MEAN] - x) / (prior == PRIOR_OMH2 ? s[H_PRIOR_SIGMA] "
          ": 0.0011f);"),),
        "bao.desi_bbn", "prior"),
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _median_ms(fn, reps=20, warmup=3, inner=1):
    """Median over ``reps`` samples of the time of one call, each sample
    taken by CUDA events around ``inner`` back-to-back calls (so that a
    short kernel is timed with the host enqueueing ahead of the card)."""
    import torch

    for _ in range(warmup):
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


def _reset_counts():
    """Zero the launch count of every kernel wrapper."""
    from cosmax_torch.ops.kernels import fused_log_prob, whitened_chi2

    fused_log_prob.LAUNCHES = whitened_chi2.LAUNCHES = whitened_chi2.ROWS_LAUNCHES = 0


def _spd_linv(rng, n):
    import numpy as np

    from cosmax_torch.ops.linalg import whitening_operator

    a = rng.standard_normal((n, n))
    return np.ascontiguousarray(whitening_operator(a @ a.T / n + np.eye(n)))


# the bundles this run packs that take the split kernel's f64 sweep
# (H_SWEEP_F64): QSR_PUBLISHED in w0wacdm, and no other
SWEEP_F64 = set()


def _pack(fl, fit):
    """``fl.pack(fit)``, holding the packer's choice of the f64 sweep to
    QSR_PUBLISHED's presets in w0wacdm."""
    packed = fl.pack(fit)
    want = fit.name in QSR_PUBLISHED and fit.model == "w0wacdm"
    if bool(packed.hdr["H_SWEEP_F64"]) != want:
        raise AssertionError(f"{fit.name}/{fit.model}: H_SWEEP_F64 = {packed.hdr['H_SWEEP_F64']}"
                             f" (sweep_cancellation {_cancellation(fl, fit):.4g})")
    if want:
        SWEEP_F64.add(f"{fit.name}/{fit.model}")
    return packed


def _cancellation(fl, fit):
    """The packer's ``sweep_cancellation`` of a split fit, the worse half."""
    emulated = [(t, *fl._emulated(t)) for t in fit.terms if fl._emulated(t) is not None]
    return max(fl.sweep_cancellation(emulated, h) for h in range(2))


def _chi2_variant(lib, linv, delta):
    """chi^2 from a variant library of the chi^2 kernel, launched straight
    through its C entry (the wrapper's launch count stays as it is)."""
    import torch

    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    out = torch.empty(delta.shape[0], dtype=torch.float32, device=delta.device)
    err = kmod._entry(lib)(linv.data_ptr(), delta.data_ptr(), out.data_ptr(), delta.shape[0],
                           delta.shape[1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chi^2 kernel variant launch failed: cudaError {err}")
    return out


def _chi2_passes(n, rows=128):
    """The passes over delta that the chi^2 kernel's design reads: each row
    tile of ``rows`` rows of Linv reads k < min(its end, N)."""
    return sum(min(r0 + rows, n) for r0 in range(0, n, rows)) / n


def _chi2_realistic(card, label, cov, linv_np, variants, gen):
    """The chi^2 kernel on realistic residuals at (65,536, N): delta_w = z_w
    L^T, z ~ N(0, I), L the Cholesky factor of ``cov`` (the SN covariance
    whose whitening is ``linv_np``), against the plain version in f64 on the
    card, RTOL_CHI2_F64 per walker; at N in CHI2_PLANTED_AT each planted
    fault must fail that check. Kernel and plain (cuBLAS, f32) times and the
    bounds: by operations (the triangle's W N (N + 1) flop in FFMA at the
    f32 peak, and as three TF32 products at the tensor-core peak), and by
    bytes (each input once; and delta read as often as the design's row
    tiles read it)."""
    import numpy as np
    import torch

    from cosmax_torch.ops.kernels.whitened_chi2 import whitened_chi2, whitened_chi2_reference

    w, n = BENCH_WALKERS, cov.shape[0]
    chol = torch.as_tensor(np.linalg.cholesky(cov), device="cuda")
    z = torch.randn((w, n), generator=gen, device="cuda", dtype=torch.float64)
    delta = (z @ chol.T).float()
    del z, chol
    linv = torch.as_tensor(linv_np, device="cuda").float()
    want = whitened_chi2_reference(linv.double(), delta.double())

    def rel_err(got):
        torch.cuda.synchronize()
        return float(((got.double() - want).abs() / want.abs()).max())

    got = whitened_chi2(linv, delta)
    rel = rel_err(got)
    if not bool(torch.isfinite(got).all()) or rel > RTOL_CHI2_F64:
        raise AssertionError(f"{label}: chi^2 kernel vs f64 plain on realistic residuals at "
                             f"({w}, {n}): max rel err {rel:.3e}")
    caught = {}
    if n in CHI2_PLANTED_AT:
        for name in CHI2_PLANTED:
            caught[name] = rel_err(_chi2_variant(variants[name][0], linv, delta))
            if caught[name] <= RTOL_CHI2_F64:
                raise AssertionError(f"{label}: the realistic-residual check missed the planted "
                                     f"fault {name!r} at N = {n}: {caught[name]:.3e}")
    ms = _median_ms(lambda: whitened_chi2(linv, delta))
    plain_ms = _median_ms(lambda: whitened_chi2_reference(linv, delta))
    flop = w * n * (n + 1)  # useful work on the triangle: N (N + 1) / 2 MACs a walker
    ffma_ms, tc_ms = 1e3 * flop / PEAK_F32_FLOPS, 1e3 * 3 * flop / PEAK_TF32_FLOPS
    once_ms = 1e3 * 4.0 * (w * n + n * n + w) / PEAK_BYTES
    passes = _chi2_passes(n)
    passes_ms = 1e3 * 4.0 * (w * n * passes + n * n + w) / PEAK_BYTES
    bound_ms = max(tc_ms, once_ms)
    faults = "".join(f"; planted {k!r} caught at {v:.3e}" for k, v in caught.items())
    print(f"{label}: whitened_chi2 on realistic residuals at (W={w}, N={n}): max rel err "
          f"{rel:.3e} against the f64 plain version (limit {RTOL_CHI2_F64:g}){faults}; on {card}: "
          f"kernel {ms:.4f} ms, plain (cuBLAS, f32) {plain_ms:.4f} ms (median of 20, CUDA "
          f"events); bounds by operations {tc_ms:.4f} ms in 3xTF32 at the TF32 peak, "
          f"{ffma_ms:.4f} ms in FFMA at the f32 peak; by bytes {once_ms:.4f} ms (each input "
          f"once), {passes_ms:.4f} ms (delta {passes:.2f} times, as the row tiles read it); "
          f"{ms / bound_ms:.2f}x the bound")
    return dict(max_rel_err_f64=rel, planted=caught, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations", bound_ms_ffma=ffma_ms,
                bound_ms_bytes=once_ms, bound_ms_bytes_passes=passes_ms, delta_passes=passes,
                library_ms=plain_ms)


def phase_kernel(card, variants):
    """Phase 3: kernel vs plain at the flagship shape and ragged shapes, and
    on realistic residuals at (65,536, 1829) against the f64 plain version,
    with its times and bounds."""
    import numpy as np
    import torch

    from cosmax_torch.data.loaders import load_sn, use_synthetic_sys
    from cosmax_torch.ops.kernels.whitened_chi2 import whitened_chi2, whitened_chi2_reference

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    result = {}
    for w, n in [(BENCH_WALKERS, N_SN), (19, 37), (70, 13), (150, N_SN), (4096, 33), (4096, 66)]:
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
            result = dict(max_abs_err=float(err.max()))
        del linv, delta, got, want
    # realistic residuals on DES-SN5YR's covariance (the flagship's
    # whitening), timed there; the plain version is itself one cuBLAS
    # product with its square-and-sum: it is the library time too
    with use_synthetic_sys(True):
        sn = load_sn("des5y")
    result.update(_chi2_realistic(card, "phase 3", sn.cov, np.ascontiguousarray(sn.linv),
                                  variants, gen))
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


def _profile(fn, calls=1):
    """Device time by kernel over ``calls`` back-to-back calls, from
    torch.profiler, and the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
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


def _flagship_walkers(fit, n, seed=0):
    """Walkers near the box centre, as bench.py draws them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    mid, span = 0.5 * (lo + hi), 0.05 * (hi - lo)
    return (mid + span * rng.standard_normal((n, fit.spec.dim))).astype(np.float32)


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
    walkers = _flagship_walkers(fit, BENCH_WALKERS)
    theta = torch.as_tensor(walkers, device="cuda")

    _reset_counts()
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = kmod.LAUNCHES
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
    return ref


def _tucker_bound_ms(fl, packed, w):
    """The least time for ``w`` walkers of a native-grid fit: the
    contraction's products at the TF32 tensor-core peak and the rest at the
    f32 peak, against theta, logp and the constants read once; and beside
    it the bound with every operation at the f32 peak."""
    ops, prod, nbytes = fl.work_per_walker(packed)
    bytes_s = (w * nbytes + 4 * packed.buf.numel()) / PEAK_BYTES
    bound_ms = 1e3 * max(w * (prod / PEAK_TF32_FLOPS + ops / PEAK_F32_FLOPS), bytes_s)
    ffma_ms = 1e3 * max(w * (prod + ops) / PEAK_F32_FLOPS, bytes_s)
    return bound_ms, ffma_ms, ops, prod, nbytes


def _layout(fl, packed):
    """The Tucker instance's shared memory and occupancy for ``packed``."""
    h = packed.hdr
    smem, blocks = fl.occupancy(packed)
    return (f"core [{h['H_KO']} x {h['H_KI']}][{h['H_LDB']}], {smem} bytes of shared memory a "
            f"block, {blocks} blocks an SM")


def _term_label(fl, packed, names, i):
    """The name of term ``i`` of ``_term_alone``: an emulated term's, the
    CMB block's (a compression, or the theta* prior) or the prior's."""
    if isinstance(i, int):
        return names[i]
    if i is None:
        return "theta*" if fl.OBSERVABLES[packed.cmb["C_OBS"]] == "theta_100" else "cmb"
    return "omh2" if fl.PRIORS[packed.hdr["H_PRIOR"]] == "omh2" else "bbn"


def _each_term(fl, packed, theta, names, label):
    """Each term of ``packed`` alone (its forms, the CMB, the prior), the
    kernel against the plain version within FUSED_RTOL of the term's own
    max|logp|: the printed parts and the worst ratio."""
    terms = [*range(len(packed.forms))]
    terms += [None] if packed.cmb else []
    terms += ["prior"] if packed.hdr["H_PRIOR"] else []
    parts, worst = [], 0.0
    for i in terms:
        err, scale, _ = _fused_vs_plain(fl, _term_alone(fl, packed, i), theta)
        name = _term_label(fl, packed, names, i)
        if not err <= FUSED_RTOL * scale:
            raise AssertionError(f"{label}: fused kernel vs plain, {name} alone: {err / scale:.3e}")
        parts.append(f"{name} {err / scale:.3e} (of {scale:.4g})")
        worst = max(worst, err / scale)
    return parts, worst


def _terms_alone(fl, packed, theta, names, label, variants):
    """Each term alone (``_each_term``), and each planted fault of
    TUCKER_PLANTED caught by the emulated terms alone: the printed parts."""
    parts, _ = _each_term(fl, packed, theta, names, label)
    for fault in TUCKER_PLANTED:
        rel, i = max(_sweep_terms(fl, packed, theta, variants[fault][0]))
        if rel <= FUSED_RTOL:
            raise AssertionError(f"{label}: the terms alone missed the planted fault {fault!r}: "
                                 f"{rel:.3e}")
        parts.append(f"planted {fault!r} caught at {rel:.3e} ({names[i]})")
    return parts


def _ragged_rows(fl, packed, theta):
    """Max abs err of the kernel against its plain version over the rows of
    the ragged last block."""
    import torch

    tail = theta.shape[0] % 128
    got = fl.fused_log_prob(packed, theta)[-tail:]
    want = fl.fused_log_prob_reference(packed, theta)[-tail:]
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError("the ragged last block's -inf rows differ")
    return tail, float((got[fin] - want[fin]).abs().max())


def phase_fast(card, parity_ref, ptxas_tucker, variants):
    """Phase 7: the fused log-prob kernel on the fast flagship. ``variants``:
    the variant libraries of ``_finish_variants``."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    t0 = time.perf_counter()
    fit = get_preset("bao.desi_cmb_des5y", "wzcdm", fast=True, synthetic_sys=True, device="cuda")
    log_prob = fit.log_prob()
    build_s = time.perf_counter() - t0
    packed = _pack(fl, fit)  # the buffer log_prob packed, for the plain version
    h = packed.hdr
    print(f"phase 7: fast flagship bao.desi_cmb_des5y/wzcdm (synthetic dense 1829^2 SN) built "
          f"and packed in {build_s:.2f}s: Tucker ranks ({h['H_R1']}, {h['H_R2']}), "
          f"R_all {h['H_RALL']}, {h['H_NFORMS']} forms, {h['H_SIZE']} constants; "
          f"{_layout(fl, packed)}; {ptxas_tucker}")

    # the kernel against its plain version; seeded bad rows are -inf in both
    for w in (BENCH_WALKERS, BIG_WALKERS, RAGGED, 70, 1):
        walkers = _flagship_walkers(fit, w, seed=w)
        if w >= 4:
            walkers[1, 2] = 0.95  # Om beyond its bound (0.1, 0.6)
            walkers[2, 0] = np.nan
        err, scale, fin = _fused_vs_plain(fl, packed, torch.as_tensor(walkers, device="cuda"))
        if w >= 4 and (bool(fin[1]) or bool(fin[2]) or int((~fin).sum()) != 2):
            raise AssertionError(f"bad rows not exactly the -inf rows at W={w}")
        if not err <= FUSED_RTOL * scale:
            raise AssertionError(f"fused kernel vs plain at W={w}: {err:.3e} > 1e-4 of {scale:.3e}")
        ragged = ""
        if w == RAGGED:
            tail, tail_err = _ragged_rows(fl, packed, torch.as_tensor(walkers, device="cuda"))
            ragged = f"; the ragged last block's {tail} rows {tail_err / scale:.3e}"
        print(f"phase 7: fused kernel vs plain at W={w}: max abs err {err:.3e} "
              f"({err / scale:.3e} of max|logp|); -inf rows agree{ragged}")
        if w == BENCH_WALKERS:
            max_abs_err = err

    # each term alone, and the planted faults of the contraction's 3xTF32
    names = [t.name for t in fit.terms if "compression" not in t.meta]
    theta = torch.as_tensor(_flagship_walkers(fit, BENCH_WALKERS, seed=3), device="cuda")
    parts = _terms_alone(fl, packed, theta, names, "phase 7", variants)
    print(f"phase 7: each term alone at W={BENCH_WALKERS} (of its own max|logp|, limit "
          f"{FUSED_RTOL:g}): {'; '.join(parts)}")

    # every other branch of the kernel: each ported fast preset and model
    for name in ("bao.desi", "bao.desi_cmb_des5y", "bao.desi_cmb_union3", "bao.desi_cmb_pantheon"):
        worst, layouts = 0.0, []
        for model in ("lcdm", "wcdm", "wzcdm"):
            other = get_preset(name, model, fast=True, device="cuda")
            p = _pack(fl, other)
            theta = torch.as_tensor(_flagship_walkers(other, 4096, seed=7), device="cuda")
            err, scale, _ = _fused_vs_plain(fl, p, theta)
            if not err <= FUSED_RTOL * scale:
                raise AssertionError(f"fused kernel vs plain on {name}/{model}: {err / scale:.3e}")
            worst = max(worst, err / scale)
            layouts.append(f"{model}: {_layout(fl, p)}")
        print(f"phase 7: fused kernel vs plain on {name} (lcdm, wcdm, wzcdm) at W=4096: "
              f"worst {worst:.3e} of max|logp|; {'; '.join(layouts)}")

    # 64 walkers against the port's f64 CPU fast path and parity path
    walkers = _flagship_walkers(fit, 64)
    lp32 = log_prob(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
    ref = get_preset("bao.desi_cmb_des5y", "wzcdm", fast=True, synthetic_sys=True,
                     device="cpu", dtype=torch.float64)
    th64 = torch.as_tensor(walkers.astype(np.float64))
    lp_fast = ref.log_prob()(th64).numpy()
    lp_par = parity_ref.log_prob()(th64).numpy()
    gap_fast = float(np.max(np.abs(lp32 - lp_fast)) / np.max(np.abs(lp_fast)))
    gap_par = float(np.max(np.abs(lp32 - lp_par)) / np.max(np.abs(lp_par)))
    if not gap_fast <= LOGP_RTOL:
        raise AssertionError(f"fused kernel vs f64 CPU fast path: {gap_fast:.3e} of max|logp|")
    print(f"phase 7: fused kernel (f32 card) vs f64 CPU on 64 walkers: fast path "
          f"{gap_fast:.3e} of max|logp|, parity path {gap_par:.3e} of max|logp| "
          f"(the emulator's truncation and quadrature differences)")

    # the main path: fit.log_prob() on the card, counted
    theta = torch.as_tensor(_flagship_walkers(fit, BENCH_WALKERS), device="cuda")
    _reset_counts()
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = fl.LAUNCHES
    if launched < 1 or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"fast log_prob: {launched} fused launches, "
                             f"{int((~torch.isfinite(lp)).sum())} non-finite values")
    print(f"phase 7: fit.log_prob() on {BENCH_WALKERS} walkers all finite, "
          f"{launched} fused kernel launch per call")
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        lp = log_prob(theta)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    print(f"phase 7: fast flagship log_prob end to end: {BENCH_WALKERS / dt:.1f} evals/s "
          f"({1e3 * dt:.4f} ms per {BENCH_WALKERS}-walker call, host clock, mean of {reps}) "
          f"on {card}")

    timing = {}
    for w in (BENCH_WALKERS, BIG_WALKERS):
        theta = torch.as_tensor(_flagship_walkers(fit, w), device="cuda")
        ms = _median_ms(lambda: fl.fused_log_prob(packed, theta), inner=20)
        plain_ms = _median_ms(lambda: fl.fused_log_prob_reference(packed, theta), inner=20)
        bound_ms, ffma_ms, ops, prod, nbytes = _tucker_bound_ms(fl, packed, w)
        print(f"phase 7: fused_log_prob at W={w} on {card}: kernel {ms:.4f} ms "
              f"({w / ms * 1e3:.1f} evals/s), plain {plain_ms:.4f} ms "
              f"({w / plain_ms * 1e3:.1f} evals/s) (median of 20 samples of 20 calls, "
              f"CUDA events); bound {bound_ms:.4f} ms ({prod} product ops a walker at the TF32 "
              f"peak, {ops} other ops at the f32 peak, {nbytes} bytes), {ffma_ms:.4f} ms with "
              f"every op at the f32 peak")
        timing[w] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_ms_ffma=ffma_ms)

    theta = torch.as_tensor(_flagship_walkers(fit, BENCH_WALKERS), device="cuda")
    calls = 20
    wall_ms, rows = _profile(lambda: log_prob(theta), calls=calls)
    dev_ms = sum(r[0] for r in rows)
    if dev_ms > 0:
        kernel = [r for r in rows if "fused_log_prob" in r[1]]
        kernel_ms, n_rec = sum(r[0] for r in kernel), sum(r[2] for r in kernel)
        print(f"phase 7: profile of {calls} back-to-back fast calls on {card}: wall "
              f"{wall_ms / calls:.4f} ms per call, device busy {100 * dev_ms / wall_ms:.1f}% "
              f"of the window, fused_log_prob {kernel_ms / max(n_rec, 1):.4f} ms per launch "
              f"over the {n_rec} launches recorded ({100 * kernel_ms / dev_ms:.1f}% of "
              f"device time)")
        for ms, name, count in rows[:4]:
            print(f"phase 7:   {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    else:
        print("phase 7: torch.profiler recorded no device time (not measured)")
    return dict(max_abs_err=max_abs_err, **timing[BENCH_WALKERS], bound_by="operations",
                library_ms=None, ms_262144=timing[BIG_WALKERS]["ms"],
                bound_ms_262144=timing[BIG_WALKERS]["bound_ms"])


def phase_cli(card, label, preset="bao.desi_cmb_des5y", walkers=150, dim=6, fast=False,
              model="wzcdm", synthetic_sys=False):
    """Phase 6 (parity), 8, 11, 12, 13, 14 (--fast) and 15 (both): the CLI,
    20 steps; the parity path's presets have two terms through the chi^2
    kernel.
    ``synthetic_sys`` passes --synthetic-sys, so that the preset's build is
    the one an earlier phase made (phase 13: minutes of the host)."""
    import numpy as np

    from cosmax_torch import fit as fit_cli
    from cosmax_torch.ops.kernels import fused_log_prob, whitened_chi2

    kmod = fused_log_prob if fast else whitened_chi2
    n_steps = 20
    with tempfile.TemporaryDirectory() as out:
        argv = ["--preset", preset, "--model", model,
                "--walkers", str(walkers), "--steps", str(n_steps), "--seed", "0",
                "--no-plots", *(["--fast"] if fast else []),
                *(["--synthetic-sys"] if synthetic_sys else []), "--out", out]
        _reset_counts()
        t0 = time.perf_counter()
        rc = fit_cli.main(argv)
        wall = time.perf_counter() - t0
        launches = kmod.LAUNCHES
        chain = np.load(os.path.join(out, "chain.npy"))
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)
    acc = summary["acceptance_fraction"]
    if rc != 0 or not np.all(np.isfinite(chain)) or chain.shape[1:] != (walkers, dim):
        raise AssertionError(f"CLI run failed: rc {rc}, chain {chain.shape}")
    if not 0.0 < acc < 1.0:
        raise AssertionError(f"acceptance fraction {acc} not in (0, 1)")
    if launches < 2 * n_steps * (1 if fast else 2):
        raise AssertionError(f"CLI run launched the kernel only {launches} times")
    print(f"{label}: cosmax_torch.fit {' '.join(argv[:-1])} <tmp>: wall {wall:.2f}s "
          f"on {card}, acceptance {acc:.3f}, {launches} {kmod.__name__.split('.')[-1]} launches "
          f"({launches / n_steps:.1f} per step)")
    return launches


def _launch_variant(fl, lib, packed, theta):
    """logp from a variant library of the fused kernel, launched straight
    through its C entry (not the wrapper, so the launch counts of the main
    path stay as they are)."""
    import torch

    split = int(packed.hdr["H_SPLIT"])
    out = torch.empty(theta.shape[0], dtype=torch.float32, device=theta.device)
    err = fl._entry(lib)(packed.buf.data_ptr(), packed.buf.numel(),
                         packed.dev.data_ptr() if split else None, fl.instance(packed),
                         fl._stride(packed),
                         theta.data_ptr(), out.data_ptr(), theta.shape[0], packed.dim,
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused kernel variant launch failed: cudaError {err}")
    return out


def _fused_vs_plain(fl, packed, theta, lib=None):
    """(max abs err, max|logp|) of the fused kernel (or of the variant
    library ``lib``) against its plain version on the same walkers;
    raises unless their -inf rows agree."""
    import torch

    got = fl.fused_log_prob(packed, theta) if lib is None else _launch_variant(
        fl, lib, packed, theta)
    want = fl.fused_log_prob_reference(packed, theta)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or bool((got[~fin] != -torch.inf).any()):
        raise AssertionError("fused kernel and plain version disagree on -inf rows")
    return float((got[fin] - want[fin]).abs().max()), float(want[fin].abs().max()), fin


def _term_alone(fl, packed, i):
    """The packed buffer cut to one term: form ``i`` alone, the CMB alone
    for ``i`` = None, or the Om h^2 prior alone for ``i`` = "prior". The
    header's form count and the form table's offset (each half's, on the
    split grid), the CMB flag and the prior flag are rewritten, so the
    kernel and the plain version read only that term."""
    import dataclasses

    buf, hdr = packed.buf.clone(), dict(packed.hdr)
    alone = isinstance(i, int)
    if not alone:
        hdr.update(H_NFORMS=0, H_HAS_CMB=hdr["H_HAS_CMB"] if i is None else 0,
                   H_PRIOR=hdr["H_PRIOR"] if i == "prior" else 0)
        cmb = packed.cmb if i is None else {}
    else:
        hdr.update(H_NFORMS=1, H_HAS_CMB=0, H_PRIOR=0,
                   H_OFF_FORMS=hdr["H_OFF_FORMS"] + i * fl.FORM_STRIDE)
        cmb = {}
    for k in ("H_NFORMS", "H_HAS_CMB", "H_OFF_FORMS", "H_PRIOR"):
        buf[fl.HEADER[k]] = hdr[k]
    halves = []
    for h, lay in enumerate(packed.halves):
        lay = dict(lay, forms=(lay["forms"][i],) if alone else ())
        if alone:
            lay["T_OFF_FORMS"] += i * fl.FORM_STRIDE
            buf[hdr["H_OFF_HALVES"] + h * fl.HALF_STRIDE + fl.HALF["T_OFF_FORMS"]] = \
                lay["T_OFF_FORMS"]
        halves.append(lay)
    forms = halves[0]["forms"] if halves else ((packed.forms[i],) if alone else ())
    return dataclasses.replace(packed, buf=buf, hdr=hdr, forms=forms, cmb=cmb,
                               halves=tuple(halves))


def phase_multiprobe_fast(card, variants):
    """Phase 9: the fused kernel on the fast multiprobe joint."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    t0 = time.perf_counter()
    fit = get_preset("joint.multiprobe", "wzcdm", fast=True, synthetic_sys=True, device="cuda")
    log_prob = fit.log_prob()
    build_s = time.perf_counter() - t0
    packed = _pack(fl, fit)
    h = packed.hdr
    kinds = ", ".join(f"{t.name}:{fl.KINDS[f['F_KIND']]}" for t, f in
                      zip([t for t in fit.terms if "compression" not in t.meta], packed.forms))
    print(f"phase 9: fast joint.multiprobe/wzcdm (synthetic dense 1829^2 SN) built and packed "
          f"in {build_s:.2f}s: Tucker ranks ({h['H_R1']}, {h['H_R2']}), R_all {h['H_RALL']} "
          f"({h['H_NQ']} quads), {h['H_NFORMS']} forms ({kinds}), {h['H_SIZE']} constants; "
          f"{_layout(fl, packed)}")

    i_s = fit.spec.names.index("s")
    for w in (MP_WALKERS, RAGGED, 70, 1):
        walkers = _flagship_walkers(fit, w, seed=w)
        if w >= 4:
            walkers[1, i_s] = 1.7  # the quasar scatter beyond its bound (0, 1.5)
            walkers[2, 0] = np.nan
        err, scale, fin = _fused_vs_plain(fl, packed, torch.as_tensor(walkers, device="cuda"))
        if w >= 4 and (bool(fin[1]) or bool(fin[2]) or int((~fin).sum()) != 2):
            raise AssertionError(f"bad rows not exactly the -inf rows at W={w}")
        if not err <= FUSED_RTOL * scale:
            raise AssertionError(f"fused kernel vs plain at W={w}: {err:.3e} > 1e-4 of {scale:.3e}")
        ragged = ""
        if w == RAGGED:
            tail, tail_err = _ragged_rows(fl, packed, torch.as_tensor(walkers, device="cuda"))
            ragged = f"; the ragged last block's {tail} rows {tail_err / scale:.3e}"
        print(f"phase 9: fused kernel vs plain at W={w}: max abs err {err:.3e} "
              f"({err / scale:.3e} of max|logp|); -inf rows agree{ragged}")
        if w == MP_WALKERS:
            max_abs_err = err
            theta_big = torch.as_tensor(walkers, device="cuda")

    # each term alone, within 1e-4 of its own max|logp|: the whole sum's
    # limit (~8 at 131,072 walkers) would not see a wrong quasar lift,
    # whose terms are a few units. A lift with its B_t zeroed must fail.
    names = [t.name for t in fit.terms if "compression" not in t.meta]
    parts = []
    for i in [*range(len(packed.forms)), None]:
        alone = _term_alone(fl, packed, i)
        err, scale, _ = _fused_vs_plain(fl, alone, theta_big)
        label = "cmb" if i is None else names[i]
        if not err <= FUSED_RTOL * scale:
            raise AssertionError(f"fused kernel vs plain, {label} alone: {err / scale:.3e}")
        parts.append(f"{label} {err / scale:.3e} (of {scale:.4g})")
        if i is not None and fl.KINDS[packed.forms[i]["F_KIND"]] == "lift":
            f, k = packed.forms[i], packed.forms[i]["F_K"]
            start = f["F_ROWS"] + 2 * k
            alone.buf[start:start + 2 * f["F_NQ"] * k] = 0.0
            got = fl.fused_log_prob(alone, theta_big)
            want = fl.fused_log_prob_reference(_term_alone(fl, packed, i), theta_big)
            fin = torch.isfinite(want)
            planted = float((got[fin] - want[fin]).abs().max()) / scale
            if planted <= FUSED_RTOL:
                raise AssertionError(f"the term-alone check missed a zeroed lift: {planted:.3e}")
            parts[-1] += f", zeroed B_t caught at {planted:.3e}"
    for fault in TUCKER_PLANTED:
        rel, i = max(_sweep_terms(fl, packed, theta_big, variants[fault][0]))
        if rel <= FUSED_RTOL:
            raise AssertionError(f"phase 9: the terms alone missed the planted fault {fault!r}: "
                                 f"{rel:.3e}")
        parts.append(f"planted {fault!r} caught at {rel:.3e} ({names[i]})")
    print(f"phase 9: fused kernel vs plain, each term alone at W={MP_WALKERS} (of its own "
          f"max|logp|): {'; '.join(parts)}")

    for name in NEW_FAST:
        worst, layouts = 0.0, []
        for model in ("lcdm", "wcdm", "wzcdm"):
            other = get_preset(name, model, fast=True, device="cuda")
            p = _pack(fl, other)
            theta = torch.as_tensor(_flagship_walkers(other, 4096, seed=7), device="cuda")
            err, scale, _ = _fused_vs_plain(fl, p, theta)
            if not err <= FUSED_RTOL * scale:
                raise AssertionError(f"fused kernel vs plain on {name}/{model}: {err / scale:.3e}")
            worst = max(worst, err / scale)
            layouts.append(f"{model}: {_layout(fl, p)}")
        print(f"phase 9: fused kernel vs plain on {name} (lcdm, wcdm, wzcdm) at W=4096: "
              f"worst {worst:.3e} of max|logp|; {'; '.join(layouts)}")

    walkers = _flagship_walkers(fit, 64)
    lp32 = log_prob(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
    th64 = torch.as_tensor(walkers.astype(np.float64))
    ref_fast = get_preset("joint.multiprobe", "wzcdm", fast=True, synthetic_sys=True,
                          device="cpu", dtype=torch.float64)
    ref_par = get_preset("joint.multiprobe", "wzcdm", synthetic_sys=True,
                         device="cpu", dtype=torch.float64)
    lp_fast = ref_fast.log_prob()(th64).numpy()
    lp_par = ref_par.log_prob()(th64).numpy()
    gap_fast = float(np.max(np.abs(lp32 - lp_fast)) / np.max(np.abs(lp_fast)))
    gap_par = float(np.max(np.abs(lp32 - lp_par)) / np.max(np.abs(lp_par)))
    if not gap_fast <= LOGP_RTOL:
        raise AssertionError(f"fused kernel vs f64 CPU fast path: {gap_fast:.3e} of max|logp|")
    print(f"phase 9: fused kernel (f32 card) vs f64 CPU on 64 walkers: fast path "
          f"{gap_fast:.3e} of max|logp|, parity path {gap_par:.3e} of max|logp|")

    theta = torch.as_tensor(_flagship_walkers(fit, MP_WALKERS), device="cuda")
    ms = _median_ms(lambda: fl.fused_log_prob(packed, theta), inner=20)
    plain_ms = _median_ms(lambda: fl.fused_log_prob_reference(packed, theta), inner=20)
    bound_ms, ffma_ms, ops, prod, nbytes = _tucker_bound_ms(fl, packed, MP_WALKERS)
    print(f"phase 9: fused_log_prob multiprobe at W={MP_WALKERS} on {card}: kernel {ms:.4f} ms "
          f"({MP_WALKERS / ms * 1e3:.1f} evals/s), plain {plain_ms:.4f} ms (median of 20 "
          f"samples of 20 calls, CUDA events); bound {bound_ms:.4f} ms ({prod} product ops a "
          f"walker at the TF32 peak, {ops} other ops at the f32 peak, {nbytes} bytes), "
          f"{ffma_ms:.4f} ms with every op at the f32 peak")

    _reset_counts()
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = fl.LAUNCHES
    if launched < 1 or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"fast multiprobe log_prob: {launched} fused launches, "
                             f"{int((~torch.isfinite(lp)).sum())} non-finite values")
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        lp = log_prob(theta)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    print(f"phase 9: fit.log_prob() on {MP_WALKERS} walkers all finite, {launched} fused "
          f"kernel launch per call; end to end {MP_WALKERS / dt:.1f} evals/s "
          f"({1e3 * dt:.4f} ms per call, host clock, mean of {reps}) on {card}")
    return ref_par, dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_ms_ffma=ffma_ms, log_prob_launches=launched)


def phase_multiprobe_parity(card, ref_par):
    """Phase 10: the parity multiprobe joint on the card."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    t0 = time.perf_counter()
    fit = get_preset("joint.multiprobe", "wzcdm", synthetic_sys=True, device="cuda")
    log_prob = fit.log_prob()
    build_s = time.perf_counter() - t0
    theta = torch.as_tensor(_flagship_walkers(fit, MP_PARITY_WALKERS), device="cuda")
    _reset_counts()
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = kmod.LAUNCHES
    t0 = time.perf_counter()
    log_prob(theta)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"{int((~torch.isfinite(lp)).sum())} non-finite parity log-probs")
    if launched < 4:  # BAO, SN, CC and fs8 each whiten through the kernel
        raise AssertionError(f"parity multiprobe launched whitened_chi2 {launched} times")

    walkers = _flagship_walkers(fit, 64)
    lp32 = log_prob(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
    lp64 = ref_par.log_prob()(torch.as_tensor(walkers.astype(np.float64))).numpy()
    rel = float(np.max(np.abs(lp32 - lp64)) / np.max(np.abs(lp64)))
    if not rel <= LOGP_RTOL:
        raise AssertionError(f"parity multiprobe f32 card vs f64 CPU: {rel:.3e} of max|logp|")
    print(f"phase 10: parity joint.multiprobe/wzcdm (synthetic dense 1829^2 SN) built in "
          f"{build_s:.2f}s; log_prob on {MP_PARITY_WALKERS} walkers all finite; {call_s:.3f}s a "
          f"call (host clock, the second call, RK4 loop included) on {card}, {launched} whitened_chi2 "
          f"launches per call; f32 card vs f64 CPU on 64 walkers: {rel:.3e} of max|logp|")
    return launched


def _ptxas_of(log, marker):
    """ptxas's register and spill lines for the kernel functions whose
    mangled name holds ``marker`` (the split grid's instance of the fused
    kernel is ``fused_log_prob_split_kernel``)."""
    lines, ours = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            ours = marker in ln
        elif ours and ("Used" in ln or "spill" in ln):
            lines.append(ln.strip())
    return "; ".join(lines)


def _start_variants():
    """Write each variant of the fused kernel's source (PLANTED,
    TUCKER_PLANTED, NCOL set to NARROW_NCOL, BAO_PLANTED, QSR_PLANTED, the f64
    sweep forced off), of the chi^2 kernel's (CHI2_PLANTED) and of its
    row-block kernel's (CHI2_ROWS_PLANTED) under
    ``build/chip_smoke_variants/`` and start one nvcc for each. Returns
    {name: (process, library path)}."""
    from cosmax_torch.ops.kernels import build
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    ncol = f"constexpr int NCOL = {fl.NCOL};"
    fused = dict(PLANTED, **TUCKER_PLANTED, **{f"NCOL={NARROW_NCOL}": (
        (ncol, f"constexpr int NCOL = {NARROW_NCOL};"),)},
        **{name: edits for name, (edits, _, _) in BAO_PLANTED.items()},
        **{name: edits for name, (edits, _, _, _) in QSR_PLANTED.items()},
        **{F64_SWEEP_OFF: F64_SWEEP_OFF_EDITS})
    variants = [(name, FUSED_SOURCE, edits) for name, edits in fused.items()]
    variants += [(name, SOURCE, edits) for name, edits in CHI2_PLANTED.items()]
    variants += [(name, ROWS_SOURCE, edits) for name, edits in CHI2_ROWS_PLANTED.items()]
    out_dir = build.BUILD_DIR.parent / "chip_smoke_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for i, (name, source, edits) in enumerate(variants):
            text = (build.CSRC / os.path.basename(source)).read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise AssertionError(f"variant {name}: {old!r} is not once in {source}")
                text = text.replace(old, new)
            cu = out_dir / f"{os.path.basename(source)[:-3]}_variant{i}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            jobs[name] = (subprocess.Popen(build.nvcc_command(cu, so), stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True), so)
    except BaseException:
        _stop(jobs)
        raise
    return jobs


def _stop(jobs):
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finish_variants(jobs):
    """{name: (library, ptxas line of the split kernel)} once every
    variant's nvcc has ended; raises if one failed."""
    import ctypes

    libs = {}
    try:
        for name, (proc, so) in jobs.items():
            _, log = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
            libs[name] = (ctypes.CDLL(str(so)), _ptxas_of(log, "split_kernel"))
    finally:
        _stop(jobs)
    return libs


def _box_walkers(fit, n, seed, seam=False):
    """Walkers uniform over the prior box; ``seam`` puts each on the
    split grid's seam, w0 + wa within 1e-4 of 0 on either side."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    walkers = lo + (hi - lo) * rng.uniform(0.0, 1.0, (n, fit.spec.dim))
    if seam:
        i_w0, i_wa = fit.spec.names.index("w0"), fit.spec.names.index("wa")
        walkers[:, i_wa] = -walkers[:, i_w0] + rng.uniform(-1e-4, 1e-4, n)
    return walkers.astype(np.float32)


def _one_half(fit, n, seed, alternate):
    """Walkers uniform over the box, all in half 1 (s = w0 + wa > 0), or
    with halves alternating walker by walker (even rows half 0)."""
    import numpy as np

    box = _box_walkers(fit, 8 * n, seed)
    s = box[:, fit.spec.names.index("w0")] + box[:, fit.spec.names.index("wa")]
    upper = box[s > 0][:n]
    if not alternate:
        return np.ascontiguousarray(upper)
    out = np.empty_like(box[:n])
    out[0::2], out[1::2] = box[s <= 0][:(n + 1) // 2], upper[:n // 2]
    return out


def _half1_walkers(fit, n, seed):
    """Walkers drawn as the bench draw, but about a centre in half 1 (w0 =
    -1, wa = 1.3: s = w0 + wa = 0.3), those inside the box with s > 0 in
    f32 kept. Half 1's walkers hold |logp| ~ 1e7 from the CMB, so the
    terms the sweep feeds are held each alone, at their own scale."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    mid, span = 0.5 * (lo + hi), 0.05 * (hi - lo)
    i_w0, i_wa = fit.spec.names.index("w0"), fit.spec.names.index("wa")
    mid[i_w0], mid[i_wa] = -1.0, 1.3
    draw = (mid + span * rng.standard_normal((2 * n, fit.spec.dim))).astype(np.float32)
    keep = (draw[:, i_w0] + draw[:, i_wa] > 0) & np.all((lo < draw) & (draw < hi), axis=1)
    return np.ascontiguousarray(draw[keep][:n])


def published_walkers(fit, n=None, seed=48):
    """``n`` (FAMILY_WALKERS) float32 walkers within 1% of the box about
    the preset's published point (QSR_PUBLISHED, w0 = -1, wa = 0). Takes
    any fit whose ``spec`` has ``names`` and ``bounds``: the port's, or
    the JAX package's in ``reference_f32_error.py``."""
    import numpy as np

    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    centre = dict(QSR_PUBLISHED[fit.name], w0=-1.0, wa=0.0)
    mid = np.array([centre[nm] for nm in fit.spec.names])
    draw = np.random.default_rng(seed).standard_normal((n or FAMILY_WALKERS, len(lo)))
    return (mid + 0.01 * (hi - lo) * draw).astype(np.float32)


def _mixed_blocks(lower, upper, c1, block=128):
    """Blocks of ``block`` walkers, each its last ``c1`` rows from
    ``upper`` (half 1) and the rest from ``lower`` (half 0)."""
    import numpy as np

    out = lower.copy().reshape(-1, block, lower.shape[1])
    out[:, block - c1:] = upper[:out.shape[0] * c1].reshape(out.shape[0], c1, -1)
    return np.ascontiguousarray(out.reshape(lower.shape))


def _sweep_terms(fl, packed, theta, lib=None):
    """Each emulated term alone (the terms the contraction or the
    tensor-train sweep feeds),
    the kernel or the variant library ``lib`` against the plain version:
    [(err / the term's own max|logp|, term index)]."""
    out = []
    for i in range(len(packed.forms)):
        err, scale, _ = _fused_vs_plain(fl, _term_alone(fl, packed, i), theta, lib)
        out.append((err / scale, i))
    return out


def _halves_of(fit, theta):
    """Walkers of each half: (s <= 0, s > 0) counts, s = w0 + wa in f32."""
    s = theta[:, fit.spec.names.index("w0")] + theta[:, fit.spec.names.index("wa")]
    lower = int((s <= 0).sum())
    return lower, theta.shape[0] - lower


def _group_padding(fit, theta, block=128):
    """Rows the kernel's grouping by half adds, per half: each block of
    ``block`` walkers runs each half's sweep over its walkers of that half
    padded to 16 rows. Returns ((padded, computed rows) of half 0, of
    half 1)."""
    import numpy as np

    s = (theta[:, fit.spec.names.index("w0")] + theta[:, fit.spec.names.index("wa")]).cpu()
    upper = np.asarray(~(s <= 0))  # a NaN s takes half 1
    upper = np.concatenate([upper, np.zeros(-len(upper) % block, bool)]).reshape(-1, block)
    valid = np.ones(upper.size, bool)
    valid[theta.shape[0]:] = False
    valid = valid.reshape(-1, block)
    out = []
    for rows in (~upper & valid, upper & valid):
        n = rows.sum(axis=1)
        padded = -(-n // 16) * 16
        out.append((int((padded - n).sum()), int(padded.sum())))
    return tuple(out)


def _split_bound_ms(fl, fit, packed, theta):
    """The least time for this batch: each walker's minimal work in its
    own half, the sweep's products at the TF32 tensor-core peak (at the f64
    tensor cores' for the f64 sweep) and the rest at the f32 peak, against
    both constant buffers read once; and beside it the bound with every
    operation at the f32 peak."""
    lower, upper = _halves_of(fit, theta)
    ops0, prod0, nbytes = fl.work_per_walker(packed, 0)
    ops1, prod1, _ = fl.work_per_walker(packed, 1)
    w = theta.shape[0]
    const_bytes = 4 * (packed.buf.numel() + packed.dev.numel())
    bytes_s = (w * nbytes + const_bytes) / PEAK_BYTES
    ops = lower * ops0 + upper * ops1
    prod = lower * prod0 + upper * prod1
    peak = PEAK_F64_TC_FLOPS if packed.hdr["H_SWEEP_F64"] else PEAK_TF32_FLOPS
    bound_ms = 1e3 * max(prod / peak + ops / PEAK_F32_FLOPS, bytes_s)
    ffma_ms = 1e3 * max((prod + ops) / PEAK_F32_FLOPS, bytes_s)
    return bound_ms, ffma_ms, ((ops0, prod0), (ops1, prod1))


def _tt_ranks(packed):
    """Each half's tensor-train axis order, bonds and coefficient columns."""
    return "; ".join(
        f"half {i}: perm {tuple(lay[f'T_PERM{j}'] for j in range(3))}, bonds "
        f"({lay['T_R1']}, {lay['T_R2']}, {lay['T_R3']}), R_all {lay['T_RALL']} ({lay['T_NQ']} quads)"
        for i, lay in enumerate(packed.halves))


def phase_w0wa_fast(card, ptxas_split, variants):
    """Phase 12: the fused kernel's split-grid branch on the fast w0wacdm
    flagship. ``variants``: the variant libraries of ``_finish_variants``."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    t0 = time.perf_counter()
    fit = get_preset("bao.desi_cmb_des5y", "w0wacdm", fast=True, synthetic_sys=True,
                     device="cuda")
    log_prob = fit.log_prob()
    build_s = time.perf_counter() - t0
    packed = _pack(fl, fit)
    h = packed.hdr
    ranks = _tt_ranks(packed)
    print(f"phase 12: fast w0wacdm flagship bao.desi_cmb_des5y/w0wacdm (synthetic dense 1829^2 "
          f"SN) built and packed in {build_s:.2f}s: {ranks}; {4 * h['H_SIZE']} bytes of shared "
          f"constants, {4 * packed.dev.numel()} bytes of TT cores and tails in device memory, "
          f"{fl.split_smem_bytes(h)} bytes of shared memory a block (constants, the sweep's "
          f"{fl._stride(packed)} rows of {fl.VLD} floats, a ring of {fl.STAGES} core slices); "
          f"{ptxas_split}")

    i_w0, i_wa = fit.spec.names.index("w0"), fit.spec.names.index("wa")
    batches = {
        "bench 65536": _flagship_walkers(fit, BENCH_WALKERS, seed=12),
        "bench 262144": _flagship_walkers(fit, BIG_WALKERS, seed=13),
        "uniform 65536": _box_walkers(fit, BENCH_WALKERS, seed=14),
        f"bench {RAGGED}": _flagship_walkers(fit, RAGGED, seed=25),
        "alternating 65536": _one_half(fit, BENCH_WALKERS, seed=22, alternate=True),
        "half-1 65536": _one_half(fit, BENCH_WALKERS, seed=23, alternate=False),
        "half-1 bench 65536": _half1_walkers(fit, BENCH_WALKERS, seed=24),
        "seam 65536": _box_walkers(fit, BENCH_WALKERS, seed=15, seam=True),
        "uniform 70": _box_walkers(fit, 70, seed=16),
        "bench 1": _flagship_walkers(fit, 1, seed=17),
    }
    # blocks holding 16 or 32 half-1 walkers each (7 + 1 and 6 + 2 m-tiles)
    for c1 in (16, 32):
        batches[f"mixed {128 - c1}+{c1} 65536"] = _mixed_blocks(
            batches["bench 65536"], batches["half-1 bench 65536"], c1)
    result = {}
    for label, walkers in batches.items():
        w = walkers.shape[0]
        if w >= 4:
            walkers[1, 2] = 0.95  # Om beyond its bound (0.1, 0.6)
            walkers[2, 0] = np.nan
        theta = torch.as_tensor(walkers, device="cuda")
        err, scale, fin = _fused_vs_plain(fl, packed, theta)
        if w >= 4 and (bool(fin[1]) or bool(fin[2]) or int((~fin).sum()) != 2):
            raise AssertionError(f"bad rows not exactly the -inf rows at {label}")
        if not err <= FUSED_RTOL * scale:
            raise AssertionError(f"w0wacdm fused kernel vs plain at {label}: {err:.3e} > 1e-4 "
                                 f"of {scale:.3e}")
        lower, upper = _halves_of(fit, theta)
        print(f"phase 12: fused kernel vs plain, {label} ({lower} walkers in half 0, {upper} in "
              f"half 1): max abs err {err:.3e} ({err / scale:.3e} of max|logp|); -inf rows agree")
        if label == "bench 65536":
            result["max_abs_err"] = err
        if label == "alternating 65536" and lower != upper:
            raise AssertionError(f"the alternating batch has {lower} + {upper} walkers in halves")
        if label.startswith("half-1") and lower != 0:
            raise AssertionError(f"the {label} batch has {lower} walkers in half 0")
    (pad0, rows0), (pad1, rows1) = _group_padding(
        fit, torch.as_tensor(batches["uniform 65536"], device="cuda"))
    print(f"phase 12: grouping by half on the uniform 65536 draw padded {pad0} rows of the "
          f"{rows0} computed in half 0 ({100 * pad0 / max(rows0, 1):.2f}%) and {pad1} of {rows1} "
          f"in half 1 ({100 * pad1 / max(rows1, 1):.2f}%)")

    # each term alone against its own max|logp|, on the uniform batch (both
    # halves); the CMB also on walkers with s = w0 + wa > 1.5, where the CPL
    # density reaches ~1e27 at z*
    uniform = torch.as_tensor(batches["uniform 65536"], device="cuda")
    names = [t.name for t in fit.terms if "compression" not in t.meta]
    parts = []
    for i in [*range(len(packed.forms)), None]:
        alone = _term_alone(fl, packed, i)
        err, scale, _ = _fused_vs_plain(fl, alone, uniform)
        label = "cmb" if i is None else names[i]
        if not err <= FUSED_RTOL * scale:
            raise AssertionError(f"w0wacdm fused kernel vs plain, {label} alone: {err / scale:.3e}")
        parts.append(f"{label} {err / scale:.3e} (of {scale:.4g})")
    high = _box_walkers(fit, BENCH_WALKERS, seed=18)
    high[:, i_w0] = np.random.default_rng(19).uniform(-0.45, -0.01, BENCH_WALKERS)
    high[:, i_wa] = 1.55 - high[:, i_w0] + (0.44 + high[:, i_w0]) * np.random.default_rng(
        20).uniform(0.0, 1.0, BENCH_WALKERS)
    high_t = torch.as_tensor(high.astype(np.float32), device="cuda")
    s_high = (high_t[:, i_w0] + high_t[:, i_wa])
    if not bool((s_high > 1.5).all()):
        raise AssertionError("the high-s batch left s > 1.5")
    err, scale, _ = _fused_vs_plain(fl, _term_alone(fl, packed, None), high_t)
    if not err <= FUSED_RTOL * scale:
        raise AssertionError(f"w0wacdm CMB alone at s > 1.5: {err / scale:.3e}")
    parts.append(f"cmb at s in ({float(s_high.min()):.3f}, {float(s_high.max()):.3f}) "
                 f"{err / scale:.3e} (of {scale:.4g})")
    print(f"phase 12: fused kernel vs plain, each term alone at W={BENCH_WALKERS} uniform (of "
          f"its own max|logp|): {'; '.join(parts)}")

    # the terms the sweep feeds, each alone at its own scale, on a bench
    # draw in each half: the whole logp of half 1 is the CMB's ~1e7, under
    # whose 1e-4 any sweep error would pass. Two planted faults in the
    # sweep's 3xTF32 must fail this check on each of the two draws.
    draws = {k: torch.as_tensor(batches[k], device="cuda")
             for k in ("bench 65536", "half-1 bench 65536")}
    parts = []
    for label, theta in draws.items():
        worst = _sweep_terms(fl, packed, theta)
        for rel, i in worst:
            if not rel <= FUSED_RTOL:
                raise AssertionError(f"w0wacdm {names[i]} alone at {label}: {rel:.3e}")
        parts.append(f"{label} " + ", ".join(f"{names[i]} {rel:.3e}" for rel, i in worst))
    print(f"phase 12: fused kernel vs plain, the sweep's terms alone (of their own max|logp|): "
          f"{'; '.join(parts)}")
    for name in PLANTED:
        lib = variants[name][0]
        parts = []
        for label, theta in draws.items():
            rel, i = max(_sweep_terms(fl, packed, theta, lib))
            if rel <= FUSED_RTOL:
                raise AssertionError(f"the sweep's terms alone missed the planted fault {name!r} "
                                     f"at {label}: {rel:.3e}")
            parts.append(f"{label} at {rel:.3e} ({names[i]})")
        print(f"phase 12: planted fault {name!r} in the sweep caught: {'; '.join(parts)} "
              f"(limit {FUSED_RTOL:g})")

    # the column passes of a bond wider than NCOL, on the flagship: the
    # kernel built with NCOL = NARROW_NCOL, the buffer packed for it
    lib, ptxas = variants[f"NCOL={NARROW_NCOL}"]
    ncol = fl.NCOL
    fl.NCOL = NARROW_NCOL
    try:
        narrow = _pack(fl, fit)
    finally:
        fl.NCOL = ncol
    passes = "; ".join(
        f"half {k}: " + ", ".join(str(-(-fl._pad8(lay[f"T_R{j}"]) // NARROW_NCOL)) for j in (2, 3))
        for k, lay in enumerate(narrow.halves))
    parts = []
    for label in ("bench 65536", "uniform 65536", "half-1 bench 65536"):
        theta = torch.as_tensor(batches[label], device="cuda")
        err, scale, _ = _fused_vs_plain(fl, narrow, theta, lib)
        worst = max(_sweep_terms(fl, narrow, theta, lib)) if label != "uniform 65536" else None
        if not err <= FUSED_RTOL * scale or (worst and not worst[0] <= FUSED_RTOL):
            raise AssertionError(f"NCOL={NARROW_NCOL} variant vs plain at {label}: "
                                 f"{err / scale:.3e}, terms alone {worst}")
        parts.append(f"{label} {err / scale:.3e}" + (
            f" (terms alone <= {worst[0]:.3e})" if worst else ""))
    print(f"phase 12: the kernel with NCOL = {NARROW_NCOL} (column passes of steps 2 and 3: "
          f"{passes}; {narrow.hdr['H_VROWS']} rows of sweep vectors, against "
          f"{h['H_VROWS']}) vs plain, of max|logp|: {'; '.join(parts)}; {ptxas}")

    # the planted fault: the halves' select swapped in a copy of the buffer
    swapped = packed.buf.clone()
    base, stride = int(h["H_OFF_HALVES"]), fl.HALF_STRIDE
    swapped[base:base + stride] = packed.buf[base + stride:base + 2 * stride]
    swapped[base + stride:base + 2 * stride] = packed.buf[base:base + stride]
    import dataclasses

    got = fl.fused_log_prob(dataclasses.replace(packed, buf=swapped), uniform)
    want = fl.fused_log_prob_reference(packed, uniform)
    fin = torch.isfinite(want) & torch.isfinite(got)
    planted = float((got[fin] - want[fin]).abs().max()) / float(want[fin].abs().max())
    if planted <= FUSED_RTOL:
        raise AssertionError(f"the check missed the swapped halves: {planted:.3e}")
    print(f"phase 12: planted swap of the halves' select caught at {planted:.3e} of max|logp| "
          f"(limit {FUSED_RTOL:g})")

    # 64 walkers over both halves against the f64 CPU fast path
    mixed = np.concatenate([_flagship_walkers(fit, 32, seed=21), batches["uniform 65536"][3:]])
    s_mixed = mixed[:, i_w0] + mixed[:, i_wa]
    mixed = np.concatenate([mixed[:32], mixed[32:][s_mixed[32:] > 0][:32]])
    lp32 = log_prob(torch.as_tensor(mixed, device="cuda")).double().cpu().numpy()
    t0 = time.perf_counter()
    ref = get_preset("bao.desi_cmb_des5y", "w0wacdm", fast=True, synthetic_sys=True,
                     device="cpu", dtype=torch.float64)
    lp64 = ref.log_prob()(torch.as_tensor(mixed.astype(np.float64))).numpy()
    gap = float(np.max(np.abs(lp32 - lp64)) / np.max(np.abs(lp64)))
    if not gap <= LOGP_RTOL:
        raise AssertionError(f"w0wacdm fused kernel vs f64 CPU fast path: {gap:.3e} of max|logp|")
    print(f"phase 12: fused kernel (f32 card) vs f64 CPU fast path on 64 walkers (32 in each "
          f"half): {gap:.3e} of max|logp| (the f64 build {time.perf_counter() - t0:.2f}s)")

    for name in W0WA_OTHERS:
        t0 = time.perf_counter()
        other = get_preset(name, "w0wacdm", fast=True, device="cuda")
        p = _pack(fl, other)
        other_s = time.perf_counter() - t0
        worst = []
        for draw in (_flagship_walkers(other, 4096, seed=7), _box_walkers(other, 4096, seed=8)):
            err, scale, _ = _fused_vs_plain(fl, p, torch.as_tensor(draw, device="cuda"))
            if not err <= FUSED_RTOL * scale:
                raise AssertionError(f"fused kernel vs plain on {name}/w0wacdm: {err / scale:.3e}")
            worst.append(err / scale)
        print(f"phase 12: {name}/w0wacdm built and packed in {other_s:.2f}s; fused kernel vs "
              f"plain at W=4096: bench {worst[0]:.3e}, uniform {worst[1]:.3e} of max|logp|")

    timing = {}
    for label in ("bench 65536", "bench 262144", "uniform 65536", "alternating 65536",
                  "half-1 65536", "half-1 bench 65536", "mixed 112+16 65536",
                  "mixed 96+32 65536"):
        theta = torch.as_tensor(np.nan_to_num(batches[label], nan=0.3), device="cuda")
        w = theta.shape[0]
        ms = _median_ms(lambda: fl.fused_log_prob(packed, theta), inner=5)
        plain_ms = _median_ms(lambda: fl.fused_log_prob_reference(packed, theta), reps=5,
                              inner=1)
        bound_ms, ffma_ms, ops = _split_bound_ms(fl, fit, packed, theta)
        lower, upper = _halves_of(fit, theta)
        print(f"phase 12: fused_log_prob w0wacdm {label} ({lower} + {upper} walkers in halves "
              f"0 + 1) on {card}: kernel {ms:.4f} ms ({w / ms * 1e3:.1f} evals/s), plain "
              f"{plain_ms:.4f} ms (CUDA events, medians); bound {bound_ms:.4f} ms (halves 0 "
              f"and 1: {ops[0][1]} and {ops[1][1]} product ops a walker at the TF32 peak, "
              f"{ops[0][0]} and {ops[1][0]} other ops at the f32 peak), {ffma_ms:.4f} ms with "
              f"every op at the f32 peak")
        timing[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_ms_ffma=ffma_ms)

    theta = torch.as_tensor(_flagship_walkers(fit, BENCH_WALKERS), device="cuda")
    _reset_counts()
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = fl.LAUNCHES
    if launched != 1 or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"fast w0wacdm log_prob: {launched} fused launches, "
                             f"{int((~torch.isfinite(lp)).sum())} non-finite values")
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        lp = log_prob(theta)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    print(f"phase 12: fit.log_prob() on {BENCH_WALKERS} walkers all finite, {launched} fused "
          f"kernel launch per call; end to end {BENCH_WALKERS / dt:.1f} evals/s "
          f"({1e3 * dt:.4f} ms per call, host clock, mean of {reps}) on {card}")
    bench = timing["bench 65536"]
    return dict(max_abs_err=result["max_abs_err"], **bench, bound_by="operations",
                log_prob_launches=launched, walkers=BENCH_WALKERS,
                ms_262144=timing["bench 262144"]["ms"],
                bound_ms_262144=timing["bench 262144"]["bound_ms"],
                ms_uniform=timing["uniform 65536"]["ms"],
                bound_ms_uniform=timing["uniform 65536"]["bound_ms"],
                ms_alternating=timing["alternating 65536"]["ms"],
                ms_half1=timing["half-1 65536"]["ms"],
                ms_half1_bench=timing["half-1 bench 65536"]["ms"],
                ms_mixed_112_16=timing["mixed 112+16 65536"]["ms"],
                ms_mixed_96_32=timing["mixed 96+32 65536"]["ms"])


def phase_w0wa_multiprobe(card, ptxas_split, variants):
    """Phase 13: the fused kernel's split-grid branch on the fast w0wacdm
    multiprobe joint, every form kind in both halves (the linear BAO, SN
    and CC, the quasar lift, the fs8 amplitude pair), with the CMB; the
    other w0wacdm presets of the multiprobe family; ``cc.cc`` (the Om h^2
    prior) in the four models. ``variants``: those of ``_finish_variants``."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    t0 = time.perf_counter()
    fit = get_preset("joint.multiprobe", "w0wacdm", fast=True, synthetic_sys=True,
                     device="cuda")
    log_prob = fit.log_prob()
    build_s = time.perf_counter() - t0
    packed = _pack(fl, fit)
    h = packed.hdr
    _, halves = fit.terms[0].meta["linear_chi2"].bundle.finalized()
    seconds = [half["seconds"] for half in halves]
    growth_s = sum(sec for part in seconds for what, sec in part.items()
                   if what.startswith("fs8[1]"))
    curves = "; ".join(f"half {k}: " + ", ".join(f"{what} {sec:.2f}s" for what, sec in
                                                 part.items()) for k, part in enumerate(seconds))
    smem, blocks = fl.occupancy(packed)
    ranks = _tt_ranks(packed)
    print(f"phase 13: fast w0wacdm multiprobe joint.multiprobe/w0wacdm (synthetic dense 1829^2 "
          f"SN) built and packed in {build_s:.2f}s on the host, the growth ODE's tables (fs8[1]) "
          f"{growth_s:.2f}s of it; per half and curve (base and radiation tables; fs8[0] the AP "
          f"curve, fs8[1] the growth curve): {curves}")
    print(f"phase 13: {ranks}; H_VROWS {h['H_VROWS']}; {4 * h['H_SIZE']} bytes of shared "
          f"constants, {4 * packed.dev.numel()} bytes of TT cores and tails in device memory; "
          f"{fl.split_smem_bytes(h)} bytes of shared memory a block by the packer ({smem} dynamic "
          f"by the runtime, {fl.GROUP_BYTES} static; limit {fl.MAX_SMEM}), {blocks} blocks an SM; "
          f"{ptxas_split}")
    # the packer counts the block's static half counts too
    if smem + fl.GROUP_BYTES != fl.split_smem_bytes(h):
        raise AssertionError(f"the packer's {fl.split_smem_bytes(h)} bytes of shared memory a "
                             f"block against the launch's {smem} and {fl.GROUP_BYTES} static")

    bench, uniform, half1 = (f"{d} {MP_WALKERS}" for d in ("bench", "uniform", "half-1 bench"))
    batches = {
        bench: _flagship_walkers(fit, MP_WALKERS, seed=31),
        uniform: _box_walkers(fit, MP_WALKERS, seed=32),
        half1: _half1_walkers(fit, MP_WALKERS, seed=33),
        f"bench {BENCH_WALKERS}": _flagship_walkers(fit, BENCH_WALKERS, seed=34),
        f"bench {RAGGED}": _flagship_walkers(fit, RAGGED, seed=35),
        "uniform 70": _box_walkers(fit, 70, seed=36),
        "bench 1": _flagship_walkers(fit, 1, seed=37),
    }
    result = {}
    for label, walkers in batches.items():
        w = walkers.shape[0]
        walkers = walkers.copy()
        if w >= 4:
            walkers[1, 2] = 0.95  # Om beyond its bound (0.1, 0.6)
            walkers[2, 0] = np.nan
        theta = torch.as_tensor(walkers, device="cuda")
        err, scale, fin = _fused_vs_plain(fl, packed, theta)
        if w >= 4 and (bool(fin[1]) or bool(fin[2]) or int((~fin).sum()) != 2):
            raise AssertionError(f"bad rows not exactly the -inf rows at {label}")
        if not err <= FUSED_RTOL * scale:
            raise AssertionError(f"w0wacdm multiprobe fused kernel vs plain at {label}: "
                                 f"{err:.3e} > 1e-4 of {scale:.3e}")
        lower, upper = _halves_of(fit, theta)
        ragged = ""
        if w == RAGGED:
            tail, tail_err = _ragged_rows(fl, packed, theta)
            ragged = f"; the ragged last block's {tail} rows {tail_err / scale:.3e}"
        print(f"phase 13: fused kernel vs plain, {label} ({lower} walkers in half 0, {upper} in "
              f"half 1): max abs err {err:.3e} ({err / scale:.3e} of max|logp|); -inf rows "
              f"agree{ragged}")
        if label == bench:
            result["max_abs_err"] = err
        if label == half1 and lower != 0:
            raise AssertionError(f"the {label} batch has {lower} walkers in half 0")

    # each term alone at its own max|logp|, on a bench draw in each half
    # (half 0 about the box centre, half 1 about w0 = -1, wa = 1.3) and on
    # the uniform draw, then the planted faults in the sweep's 3xTF32
    # (PLANTED) on the terms the sweep feeds: each must fail that check on
    # both bench draws
    names = [t.name for t in fit.terms if "compression" not in t.meta]
    draws = {k: torch.as_tensor(batches[k], device="cuda") for k in (bench, half1)}
    for label, theta in {**draws, uniform: torch.as_tensor(batches[uniform],
                                                           device="cuda")}.items():
        parts, _ = _each_term(fl, packed, theta, names, f"phase 13 {label}")
        print(f"phase 13: fused kernel vs plain, each term alone at {label} (of its own "
              f"max|logp|, limit {FUSED_RTOL:g}): {'; '.join(parts)}")
    for fault in PLANTED:
        parts = []
        for label, theta in draws.items():
            errs = _sweep_terms(fl, packed, theta, variants[fault][0])
            rel, i = max(errs)
            if rel <= FUSED_RTOL:
                raise AssertionError(f"phase 13: the sweep's terms alone missed the planted "
                                     f"fault {fault!r} at {label}: {rel:.3e}")
            parts.append(f"{label}: " + ", ".join(f"{names[j]} {e:.3e}" for e, j in errs))
        print(f"phase 13: planted fault {fault!r} in the sweep caught (each term alone, limit "
              f"{FUSED_RTOL:g}): {'; '.join(parts)}")

    # 64 walkers, 32 in each half, against the f64 CPU fast path
    i_w0, i_wa = fit.spec.names.index("w0"), fit.spec.names.index("wa")
    mixed = np.concatenate([_flagship_walkers(fit, 32, seed=38), batches[uniform][3:]])
    s_mixed = mixed[:, i_w0] + mixed[:, i_wa]
    mixed = np.concatenate([mixed[:32], mixed[32:][s_mixed[32:] > 0][:32]])
    lp32 = log_prob(torch.as_tensor(mixed, device="cuda")).double().cpu().numpy()
    ref = get_preset("joint.multiprobe", "w0wacdm", fast=True, synthetic_sys=True,
                     device="cpu", dtype=torch.float64)
    lp64 = ref.log_prob()(torch.as_tensor(mixed.astype(np.float64))).numpy()
    gap = float(np.max(np.abs(lp32 - lp64)) / np.max(np.abs(lp64)))
    if not gap <= LOGP_RTOL:
        raise AssertionError(f"w0wacdm multiprobe fused kernel vs f64 CPU fast path: "
                             f"{gap:.3e} of max|logp|")
    print(f"phase 13: fused kernel (f32 card) vs f64 CPU fast path on 64 walkers (32 in each "
          f"half): {gap:.3e} of max|logp| (limit {LOGP_RTOL:g})")

    timing = {}
    for label in (bench, uniform, f"bench {BENCH_WALKERS}"):
        theta = torch.as_tensor(batches[label], device="cuda")
        w = theta.shape[0]
        ms = _median_ms(lambda: fl.fused_log_prob(packed, theta), inner=5)
        plain_ms = _median_ms(lambda: fl.fused_log_prob_reference(packed, theta), reps=5)
        bound_ms, ffma_ms, ops = _split_bound_ms(fl, fit, packed, theta)
        lower, upper = _halves_of(fit, theta)
        print(f"phase 13: fused_log_prob w0wacdm multiprobe {label} ({lower} + {upper} walkers "
              f"in halves 0 + 1) on {card}: kernel {ms:.4f} ms ({w / ms * 1e3:.1f} evals/s), "
              f"plain {plain_ms:.4f} ms (CUDA events, medians); bound {bound_ms:.4f} ms (halves "
              f"0 and 1: {ops[0][1]} and {ops[1][1]} product ops a walker at the TF32 peak, "
              f"{ops[0][0]} and {ops[1][0]} other ops at the f32 peak), {ffma_ms:.4f} ms with "
              f"every op at the f32 peak")
        timing[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_ms_ffma=ffma_ms)

    # the main path: fit.log_prob() on the card, counted
    theta = torch.as_tensor(batches[bench], device="cuda")
    _reset_counts()
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = fl.LAUNCHES
    if launched != 1 or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"fast w0wacdm multiprobe log_prob: {launched} fused launches, "
                             f"{int((~torch.isfinite(lp)).sum())} non-finite values")
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        lp = log_prob(theta)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    print(f"phase 13: fit.log_prob() on {MP_WALKERS} walkers all finite, {launched} fused "
          f"kernel launch per call; end to end {MP_WALKERS / dt:.1f} evals/s "
          f"({1e3 * dt:.4f} ms per call, host clock, mean of {reps}) on {card}")

    # cc.cc (the Om h^2 prior) in every model: whole and each term alone.
    # fs8.fs8, cc.cc_union3 and cc.cc_des5y in w0wacdm left here for phase
    # 18's time: fs8.fs8's growth-ODE tables took ~190 s of the
    # host a run, the two others' builds ~15-20 s each, and every kernel
    # branch they take (the amp-pair form, linear CC and SN forms, the split
    # sweep) is the w0wacdm multiprobe's, held above, whole and each term
    # alone; the three stay in phase 9 (lcdm, wcdm, wzcdm)
    for name, models in [("cc.cc", MODELS)]:
        for model in models:
            t0 = time.perf_counter()
            other = get_preset(name, model, fast=True, device="cuda")
            p = _pack(fl, other)
            other_s = time.perf_counter() - t0
            names = [t.name for t in other.terms if fl._emulated(t) is not None]
            parts = []
            for label, draw in (("bench", _flagship_walkers(other, 4096, seed=7)),
                                ("uniform", _box_walkers(other, 4096, seed=8))):
                theta = torch.as_tensor(draw, device="cuda")
                err, scale, _ = _fused_vs_plain(fl, p, theta)
                if not err <= FUSED_RTOL * scale:
                    raise AssertionError(f"fused kernel vs plain on {name}/{model}: "
                                         f"{err / scale:.3e}")
                alone, worst = _each_term(fl, p, theta, names, f"phase 13 {name}/{model}")
                parts.append(f"{label} {err / scale:.3e}, each term alone: {', '.join(alone)}")
                if name == "cc.cc":
                    result.setdefault("cc_cc", {})[f"{model} {label}"] = dict(
                        whole=err / scale, worst_term_alone=worst)
            print(f"phase 13: {name}/{model} built and packed in {other_s:.2f}s; fused kernel "
                  f"vs plain at W=4096 (of max|logp|): {'; '.join(parts)}")

    timed = timing[bench]
    return dict(max_abs_err=result["max_abs_err"], **timed, bound_by="operations",
                walkers=MP_WALKERS, log_prob_launches=launched, evals_per_s=MP_WALKERS / dt,
                build_s=build_s, growth_build_s=growth_s, smem_bytes=smem, blocks_per_sm=blocks,
                r_all=[lay["T_RALL"] for lay in packed.halves],
                bonds=[[lay[f"T_R{j}"] for j in (1, 2, 3)] for lay in packed.halves],
                ms_uniform=timing[uniform]["ms"], bound_ms_uniform=timing[uniform]["bound_ms"],
                ms_65536=timing[f"bench {BENCH_WALKERS}"]["ms"],
                bound_ms_65536=timing[f"bench {BENCH_WALKERS}"]["bound_ms"],
                f32_vs_f64=gap), result["cc_cc"]


def _bad_rows(fit, walkers):
    """``walkers`` with a seeded out-of-box row 1 (the first parameter
    beyond its upper bound) and a NaN row 2, both -inf in kernel and plain."""
    import numpy as np

    lo, hi = fit.spec.bounds[:, 0], fit.spec.bounds[:, 1]
    walkers[1, 0] = hi[0] + 0.1 * (hi[0] - lo[0])
    walkers[2, 1] = np.nan
    return walkers


def _check_fused(fl, packed, walkers, label):
    """The kernel against its plain version within FUSED_RTOL of
    max|logp| (the seeded rows 1 and 2 -inf in both): the ratio."""
    import torch

    err, scale, fin = _fused_vs_plain(fl, packed, torch.as_tensor(walkers, device="cuda"))
    if bool(fin[1]) or bool(fin[2]) or int((~fin).sum()) != 2:
        raise AssertionError(f"{label}: the bad rows are not exactly the -inf rows")
    if not err <= FUSED_RTOL * scale:
        raise AssertionError(f"{label}: fused kernel vs plain {err / scale:.3e} of max|logp|")
    return err / scale


def _gap(lp32, lp64):
    import numpy as np

    return float(np.max(np.abs(lp32 - lp64)) / np.max(np.abs(lp64)))


def phase_bao_family(card, variants):
    """Phase 14: the 17 BAO presets of ROADMAP item 10b (and bao.sdss) on
    both paths, and the fused kernel's #1e branches (K1 scalar priors, K2
    the walker's r_d, K3 theta*, K4 H0-free fits, K5 exp(w0)) in both of
    its instances."""
    import dataclasses

    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    t_phase = time.perf_counter()
    fits = {}

    def fast_fit(name, model, **opts):
        key = (name, model, tuple(sorted(opts.items())))
        if key not in fits:
            t0 = time.perf_counter()
            fit = get_preset(name, model, fast=True, device="cuda", **opts)
            fits[key] = (fit, _pack(fl, fit), time.perf_counter() - t0)
        return fits[key]

    # each preset in wzcdm: the kernel against its plain version, f32 card
    # against the f64 CPU fast path, the parity path on the card against
    # the f64 CPU parity path
    worst = dict(fused=0.0, fast=0.0, parity=0.0)
    for name in BAO_FAMILY:
        fit, packed, build_s = fast_fit(name, "wzcdm")
        rel = _check_fused(fl, packed, _bad_rows(fit, _flagship_walkers(fit, FAMILY_WALKERS, 14)),
                           f"phase 14 {name}")
        walkers = _flagship_walkers(fit, 64, seed=15)
        lp32 = fit.log_prob()(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
        ref = get_preset(name, "wzcdm", fast=True, device="cpu", dtype=torch.float64)
        gap_fast = _gap(lp32, ref.log_prob()(torch.as_tensor(walkers.astype(np.float64))).numpy())
        par = get_preset(name, "wzcdm", device="cuda")
        par64 = get_preset(name, "wzcdm", device="cpu", dtype=torch.float64)
        walkers = _flagship_walkers(fit, FAMILY_PARITY_WALKERS, seed=16)
        lp32 = par.log_prob()(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
        lp64 = par64.log_prob()(torch.as_tensor(walkers.astype(np.float64))).numpy()
        if not np.all(np.isfinite(lp32)):
            raise AssertionError(f"phase 14 {name}: non-finite parity log-probs on the card")
        gap_par = _gap(lp32, lp64)
        if not (gap_fast <= LOGP_RTOL and gap_par <= LOGP_RTOL):
            raise AssertionError(f"phase 14 {name}: f32 card vs f64 CPU: fast {gap_fast:.3e}, "
                                 f"parity {gap_par:.3e} of max|logp|")
        for k, v in (("fused", rel), ("fast", gap_fast), ("parity", gap_par)):
            worst[k] = max(worst[k], v)
        h = packed.hdr
        block = _term_label(fl, packed, (), None) if packed.cmb else "no cmb"
        print(f"phase 14: {name}/wzcdm built and packed in {build_s:.2f}s (r_d "
              f"{fl.RD_KINDS[h['H_RD_KIND']]}, prior {fl.PRIORS[h['H_PRIOR']]}, {block}); "
              f"fused kernel vs plain at W={FAMILY_WALKERS} {rel:.3e}, f32 card vs f64 CPU "
              f"fast path on 64 walkers {gap_fast:.3e}, parity path on the card vs f64 CPU at "
              f"W={FAMILY_PARITY_WALKERS} {gap_par:.3e} (of max|logp|)")

    # each preset in the other models: the parity path on the card against
    # the f64 CPU one, the fast path in lcdm and wcdm against its plain
    # version (w0wacdm: the branch presets below)
    for name in BAO_FAMILY:
        parts = []
        for model in ("lcdm", "wcdm", "w0wacdm"):
            par = get_preset(name, model, device="cuda")
            par64 = get_preset(name, model, device="cpu", dtype=torch.float64)
            walkers = _flagship_walkers(par, FAMILY_PARITY_WALKERS // 4, seed=20)
            lp32 = par.log_prob()(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
            gap_par = _gap(lp32, par64.log_prob()(torch.as_tensor(walkers.astype(np.float64)))
                           .numpy())
            if not (np.all(np.isfinite(lp32)) and gap_par <= LOGP_RTOL):
                raise AssertionError(f"phase 14 {name}/{model} parity: f32 card vs f64 CPU "
                                     f"{gap_par:.3e} of max|logp|")
            worst["parity"] = max(worst["parity"], gap_par)
            parts.append(f"{model} parity {gap_par:.3e}")
            if model != "w0wacdm":
                fit, packed, _ = fast_fit(name, model)
                rel = _check_fused(fl, packed, _bad_rows(
                    fit, _flagship_walkers(fit, FAMILY_WALKERS, 21)), f"phase 14 {name}/{model}")
                worst["fused"] = max(worst["fused"], rel)
                parts.append(f"fast {rel:.3e}")
        print(f"phase 14: {name} in the other models (of max|logp|): parity on the card vs f64 "
              f"CPU at W={FAMILY_PARITY_WALKERS // 4}, fused kernel vs plain at "
              f"W={FAMILY_WALKERS}: {', '.join(parts)}")

    # each branch in the four models: whole and each term alone, on the
    # bench draw (and in w0wacdm uniform over the box, both halves)
    branch_worst = {}
    for label, name, opts in BRANCHES:
        for model in MODELS:
            fit, packed, build_s = fast_fit(name, model, **opts)
            names = [t.name for t in fit.terms if fl._emulated(t) is not None]
            draws = [("bench", _flagship_walkers(fit, FAMILY_WALKERS, seed=17))]
            if model == "w0wacdm":
                draws.append(("uniform", _box_walkers(fit, FAMILY_WALKERS, seed=18)))
            parts = []
            for dlabel, walkers in draws:
                walkers = _bad_rows(fit, walkers)
                rel = _check_fused(fl, packed, walkers, f"phase 14 {name}/{model} {dlabel}")
                theta = torch.as_tensor(walkers, device="cuda")
                alone, w = _each_term(fl, packed, theta, names, f"phase 14 {name}/{model}")
                branch_worst[f"{label} {model} {dlabel}"] = max(rel, w)
                parts.append(f"{dlabel} {rel:.3e}, each term alone: {', '.join(alone)}")
            print(f"phase 14: {label}: {name}{opts or ''}/{model} built and packed in "
                  f"{build_s:.2f}s; fused kernel vs plain (of max|logp|): {'; '.join(parts)}")

    # the planted faults: each must fail its term's check alone, in both
    # instances (wzcdm: Tucker, w0wacdm: split)
    caught = {}
    for fault, (_, name, key) in BAO_PLANTED.items():
        for model in ("wzcdm", "w0wacdm"):
            fit, packed, _ = fast_fit(name, model)
            theta = torch.as_tensor(_flagship_walkers(fit, FAMILY_WALKERS, seed=19), device="cuda")
            alone = _term_alone(fl, packed, key)
            err, scale, _ = _fused_vs_plain(fl, alone, theta)
            if not err <= FUSED_RTOL * scale:
                raise AssertionError(f"phase 14 {name}/{model}: the term alone failed before "
                                     f"the fault: {err / scale:.3e}")
            err, scale, _ = _fused_vs_plain(fl, alone, theta, variants[fault][0])
            if err <= FUSED_RTOL * scale:
                raise AssertionError(f"phase 14 {name}/{model}: the term alone missed the "
                                     f"planted fault {fault!r}: {err / scale:.3e}")
            caught[f"{fault} {model}"] = err / scale
    print(f"phase 14: planted faults caught by their term alone (limit {FUSED_RTOL:g} of its "
          f"own max|logp|): " + "; ".join(f"{k} {v:.3e}" for k, v in caught.items()))

    # the two timing rows: the kernel, its plain version and the bound;
    # a block's shared memory and blocks an SM; fit.log_prob() end to end
    # the branch's share: the same buffer with the branch left out (r_d
    # fixed instead of r_s(z_drag); the theta* block off), timed as a probe
    # (another function, not held against the plain version)
    left_out = {"bao.desi_bbn": ("the z_drag quadrature",
                                 dict(H_RD_KIND=fl.RD_KINDS.index("fixed"), H_RD=147.09)),
                "bao.desi_omh2_theta_star": ("theta*", dict(H_HAS_CMB=0))}
    timing = {}
    for name in ("bao.desi_bbn", "bao.desi_omh2_theta_star"):
        for model, w in (("wzcdm", BIG_WALKERS), ("w0wacdm", BENCH_WALKERS)):
            fit, packed, _ = fast_fit(name, model)
            part, slots = left_out[name]
            probe = dataclasses.replace(packed, buf=packed.buf.clone())
            for k, v in slots.items():
                probe.buf[fl.HEADER[k]] = v
            timing[f"{name}/{model}"] = _fast_timing(
                fl, card, f"phase 14: fused_log_prob {name}/{model}", fit, packed, w,
                (part, lambda theta, probe=probe: fl.fused_log_prob(probe, theta)))
    seconds = time.perf_counter() - t_phase
    print(f"phase 14: {seconds:.1f}s on {card}")
    return dict(worst, branches=branch_worst, planted=caught, timing=timing, seconds=seconds)


def _chi2_at(card, sn, variants, gen):
    """Phase 15: the chi^2 kernel against its plain version at (65,536, n)
    on an SN dataset's whitening factor, rtol RTOL_KERNEL per walker, and on
    realistic residuals of its covariance against the f64 plain version,
    with kernel and plain times and the bounds (``_chi2_realistic``). The
    plain version is one cuBLAS product with its square-and-sum: it is the
    library time too."""
    import numpy as np
    import torch

    from cosmax_torch.ops.kernels.whitened_chi2 import whitened_chi2, whitened_chi2_reference

    w, n = BENCH_WALKERS, sn.n
    linv_np = np.ascontiguousarray(sn.linv)
    linv = torch.as_tensor(linv_np, device="cuda").float()
    delta = torch.randn((w, n), generator=gen, device="cuda")
    got = whitened_chi2(linv, delta)
    want = whitened_chi2_reference(linv, delta)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = float((err / want.abs()).max())
    if not bool(torch.isfinite(got).all()) or rel > RTOL_KERNEL:
        raise AssertionError(f"phase 15: chi^2 kernel vs plain at ({w}, {n}): max rel err "
                             f"{rel:.3e}")
    print(f"phase 15: whitened_chi2 vs plain at (W={w}, N={n}): max rel err {rel:.3e}, max abs "
          f"err {float(err.max()):.3e}")
    del linv, delta, got, want
    return dict(max_rel_err=rel, max_abs_err=float(err.max()),
                **_chi2_realistic(card, "phase 15", sn.cov, linv_np, variants, gen))


def phase_sn_family(card, variants):
    """Phase 15: the SN family (the ten sn.* presets) and the rest of cc.*
    (cc.cc_pantheon, cc.cc_plain, cc.cc_cmb) on both paths, with the dense
    synthetic SN factors, and the chi^2 kernel at the family's sizes."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.data.loaders import load_sn, use_synthetic_sys
    from cosmax_torch.ops.kernels import fused_log_prob as fl
    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    t_phase = time.perf_counter()
    fits = {}

    def fast_fit(name, model):
        if (name, model) not in fits:
            t0 = time.perf_counter()
            fit = get_preset(name, model, fast=True, synthetic_sys=True, device="cuda")
            fits[name, model] = (fit, _pack(fl, fit), time.perf_counter() - t0)
        return fits[name, model]

    # the parity path in wzcdm (cc.cc_cmb is lcdm): all finite, 64 walkers
    # against the f64 CPU parity path, the chi^2 kernel's launches counted
    worst = dict(fused=0.0, fast=0.0, parity=0.0, alone=0.0)
    parity_launches = {}
    for name in SN_FAMILY:
        par = get_preset(name, "wzcdm", synthetic_sys=True, device="cuda")
        walkers = _flagship_walkers(par, FAMILY_PARITY_WALKERS, seed=30)
        log_prob = par.log_prob()
        _reset_counts()
        lp = log_prob(torch.as_tensor(walkers, device="cuda"))
        torch.cuda.synchronize()
        parity_launches[name] = kmod.LAUNCHES
        lp32 = lp.double().cpu().numpy()
        par64 = get_preset(name, "wzcdm", synthetic_sys=True, device="cpu", dtype=torch.float64)
        gap = _gap(lp32[:64], par64.log_prob()(torch.as_tensor(walkers[:64].astype(np.float64)))
                   .numpy())
        if not (np.all(np.isfinite(lp32)) and gap <= LOGP_RTOL and kmod.LAUNCHES >= 1):
            raise AssertionError(f"phase 15 {name} parity: {int((~np.isfinite(lp32)).sum())} "
                                 f"non-finite, f32 card vs f64 CPU {gap:.3e}, "
                                 f"{kmod.LAUNCHES} chi^2 kernel launches")
        worst["parity"] = max(worst["parity"], gap)
        print(f"phase 15: {name}/{par.model} parity on the card at W={FAMILY_PARITY_WALKERS}: "
              f"all finite, {parity_launches[name]} whitened_chi2 launches a call; f32 card vs "
              f"f64 CPU on 64 walkers {gap:.3e} of max|logp|")

    # the chi^2 kernel at the family's sizes, on each dataset's factor
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    chi2 = {}
    with use_synthetic_sys(True):
        for ds in ("union21", "pantheon18", "pantheon_plus", "pantheon_plus_shoes"):
            sn = load_sn(ds)
            chi2[sn.n] = dict(_chi2_at(card, sn, variants, gen), dataset=ds)

    # the fast path in wzcdm: whole and each term alone against the plain
    # version, f32 card against the f64 CPU fast path
    def check(name, model, draws):
        fit, packed, build_s = fast_fit(name, model)
        names = [t.name for t in fit.terms if fl._emulated(t) is not None]
        parts = []
        for dlabel, walkers in draws(fit):
            walkers = _bad_rows(fit, walkers)
            rel = _check_fused(fl, packed, walkers, f"phase 15 {name}/{model} {dlabel}")
            alone, w = _each_term(fl, packed, torch.as_tensor(walkers, device="cuda"), names,
                                  f"phase 15 {name}/{model} {dlabel}")
            worst["fused"], worst["alone"] = max(worst["fused"], rel), max(worst["alone"], w)
            parts.append(f"{dlabel} {rel:.3e}, each term alone: {', '.join(alone)}")
        return fit, packed, build_s, parts

    bench = lambda fit: [("bench", _flagship_walkers(fit, FAMILY_WALKERS, seed=31))]
    for name in SN_FAMILY:
        fit, packed, build_s, parts = check(name, "wzcdm", bench)
        walkers = _flagship_walkers(fit, 64, seed=32)
        lp32 = fit.log_prob()(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
        ref = get_preset(name, "wzcdm", fast=True, synthetic_sys=True, device="cpu",
                         dtype=torch.float64)
        gap = _gap(lp32, ref.log_prob()(torch.as_tensor(walkers.astype(np.float64))).numpy())
        if not gap <= LOGP_RTOL:
            raise AssertionError(f"phase 15 {name}: f32 card vs f64 CPU fast {gap:.3e}")
        worst["fast"] = max(worst["fast"], gap)
        h = packed.hdr
        print(f"phase 15: {name}/{fit.model} fast, built and packed in {build_s:.2f}s (Tucker "
              f"ranks ({h['H_R1']}, {h['H_R2']}), R_all {h['H_RALL']}, {_layout(fl, packed)}); "
              f"fused kernel vs plain at W={FAMILY_WALKERS} (of max|logp|): {'; '.join(parts)}; "
              f"f32 card vs f64 CPU fast path on 64 walkers {gap:.3e}")

    # the presets of new structure in the other models: the fast path
    # (w0wacdm also uniform over the box, both halves), and the parity
    # path on the card against the f64 CPU one
    def draws(fit):
        out = [("bench", _flagship_walkers(fit, FAMILY_WALKERS, seed=33))]
        if fit.model == "w0wacdm":
            out.append(("uniform", _box_walkers(fit, FAMILY_WALKERS, seed=34)))
        return out

    for name in SN_NEW_STRUCTURE:
        for model in ("lcdm", "wcdm", "w0wacdm"):
            fit, packed, build_s, parts = check(name, model, draws)
            par = get_preset(name, model, synthetic_sys=True, device="cuda")
            par64 = get_preset(name, model, synthetic_sys=True, device="cpu", dtype=torch.float64)
            walkers = _flagship_walkers(par, FAMILY_PARITY_WALKERS // 4, seed=35)
            lp32 = par.log_prob()(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
            gap = _gap(lp32, par64.log_prob()(torch.as_tensor(walkers.astype(np.float64)))
                       .numpy())
            if not (np.all(np.isfinite(lp32)) and gap <= LOGP_RTOL):
                raise AssertionError(f"phase 15 {name}/{model} parity: f32 card vs f64 CPU "
                                     f"{gap:.3e}")
            worst["parity"] = max(worst["parity"], gap)
            print(f"phase 15: {name}/{model} fast, built and packed in {build_s:.2f}s; fused "
                  f"kernel vs plain (of max|logp|): {'; '.join(parts)}; parity on the card vs "
                  f"f64 CPU at W={FAMILY_PARITY_WALKERS // 4} {gap:.3e}")

    # the timing rows: the kernel, its plain version, the bound, a block's
    # shared memory and blocks an SM, fit.log_prob() end to end
    timing = {}
    for name, model, w in SN_TIMING:
        fit, packed, _ = fast_fit(name, model)
        timing[f"{name}/{model}"] = _fast_timing(
            fl, card, f"phase 15: fused_log_prob {name}/{model}", fit, packed, w)
    seconds = time.perf_counter() - t_phase
    print(f"phase 15: worst of max|logp|: fused kernel vs plain {worst['fused']:.3e}, each term "
          f"alone {worst['alone']:.3e}, f32 card vs f64 CPU fast {worst['fast']:.3e}, parity "
          f"{worst['parity']:.3e}; {seconds:.1f}s on {card}")
    return dict(worst, chi2=chi2, parity_launches=parity_launches, timing=timing,
                seconds=seconds)


def _gap_to_f64(fit, seed):
    """f32 card against the f64 CPU fast path on 64 bench walkers (in
    w0wacdm up to 32 of them from half 1), of max|logp|."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset

    walkers = _flagship_walkers(fit, 64, seed=seed)
    if fit.model == "w0wacdm":
        upper = _half1_walkers(fit, 32, seed)
        walkers = np.concatenate([walkers[:64 - len(upper)], upper])
    lp32 = fit.log_prob()(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
    ref = get_preset(fit.name, fit.model, fast=True, synthetic_sys=True, device="cpu",
                     dtype=torch.float64)
    return _gap(lp32, ref.log_prob()(torch.as_tensor(walkers.astype(np.float64))).numpy())


def _fast_timing(fl, card, label, fit, packed, w, probe=None):
    """The kernel, its plain version and the bound at ``w`` bench walkers;
    a block's shared memory and blocks an SM; fit.log_prob() end to end
    with its launch count; and ``probe`` (the part left out and a function
    of the walkers that launches the kernel without it, not held against
    the plain version) timed on the same walkers."""
    import torch

    theta = torch.as_tensor(_flagship_walkers(fit, w), device="cuda")
    ms = _median_ms(lambda: fl.fused_log_prob(packed, theta), inner=20)
    plain_ms = _median_ms(lambda: fl.fused_log_prob_reference(packed, theta), inner=20)
    if packed.hdr["H_SPLIT"]:
        bound_ms, ffma_ms, ((ops, prod), _) = _split_bound_ms(fl, fit, packed, theta)
    else:
        bound_ms, ffma_ms, ops, prod, _ = _tucker_bound_ms(fl, packed, w)
    smem, blocks = fl.occupancy(packed)
    log_prob = fit.log_prob()
    _reset_counts()
    lp = log_prob(theta)
    torch.cuda.synchronize()
    launched = fl.LAUNCHES
    if launched < 1 or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"{label} log_prob: {launched} fused launches, "
                             f"{int((~torch.isfinite(lp)).sum())} non-finite")
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        log_prob(theta)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    row = dict(walkers=w, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_ms_ffma=ffma_ms,
               smem_bytes=smem, blocks_per_sm=blocks, log_prob_launches=launched,
               evals_per_s=w / dt)
    left_out = ""
    if probe is not None:
        part, without = probe
        row["ms_without"] = _median_ms(lambda: without(theta), inner=20)
        left_out = (f"; without {part} {row['ms_without']:.4f} ms "
                    f"({100 * (1 - row['ms_without'] / ms):.1f}% of the kernel)")
    print(f"{label} at W={w} on {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median "
          f"of 20 samples of 20 calls, CUDA events); bound {bound_ms:.4f} ms ({prod} product "
          f"ops a walker at the TF32 peak, {ops} other ops at the f32 peak, "
          f"{fl.work_per_walker(packed)[2]} bytes; {ms / bound_ms:.1f}x), {ffma_ms:.4f} ms "
          f"with every op at the f32 peak; {smem} bytes of shared memory a block, {blocks} "
          f"blocks an SM; fit.log_prob() {launched} fused launch a call, {w / dt:.1f} evals/s "
          f"end to end ({1e3 * dt:.4f} ms a call, host clock, mean of {reps}){left_out}")
    return row


def _published_point(card, fast_fit, variants):
    """Phase 16: near the published point of QSR_PUBLISHED's presets in
    w0wacdm (``fast_fit(name, model)`` -> (fit, packed, seconds))."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    # the float32 conditioning of the two widest split-grid bundles: their
    # BAO table's scale is set by the Om -> 0 corner of the box, so the
    # packer gives them the f64 sweep (H_SWEEP_F64). Held near the published
    # point: the kernel's float32 log-prob within LOGP_RTOL of max|logp| of
    # the f64 CPU fast path, whole and the BAO alone; the kernel with the
    # f64 sweep forced off (the 3xTF32 sweep on the same buffer) must fail
    # that check. Beside it the plain version's error, the BAO form's table
    # scale (F_SCALE: the max of its group's table over the padded grid) in
    # wzcdm and in each w0wacdm half, and the kernel's time at BENCH_WALKERS
    # w0wacdm walkers with each sweep
    def bao_scales(name, model):
        fit, packed, _ = fast_fit(name, model)
        i = [t.name for t in fit.terms if fl._emulated(t) is not None].index("bao")
        offs = [lay["T_OFF_FORMS"] for lay in packed.halves] or [packed.hdr["H_OFF_FORMS"]]
        return [float(packed.buf[o + i * fl.FORM_STRIDE + fl.FORM["F_SCALE"]]) for o in offs]

    conditioning, missed = {}, {}
    off_lib = variants[F64_SWEEP_OFF][0]
    for name in QSR_PUBLISHED:
        fit, packed, _ = fast_fit(name, "w0wacdm")
        if not packed.hdr["H_SWEEP_F64"]:
            raise AssertionError(f"phase 16 {name}/w0wacdm: the packer did not choose the f64 "
                                 f"sweep")
        ref = get_preset(name, "w0wacdm", fast=True, synthetic_sys=True, device="cpu",
                         dtype=torch.float64)
        walkers = published_walkers(fit)
        theta = torch.as_tensor(walkers, device="cuda")
        names = [t.name for t in fit.terms if fl._emulated(t) is not None]
        parts = []
        for label, key in (("whole", "whole"), ("bao alone", names.index("bao"))):
            p32 = packed if key == "whole" else _term_alone(fl, packed, key)
            p64 = _pack(fl, ref) if key == "whole" else _term_alone(fl, _pack(fl, ref), key)
            lp64 = fl.fused_log_prob_reference(p64, torch.as_tensor(walkers.astype(np.float64)))
            for which, lp in (("kernel", fl.fused_log_prob(p32, theta)),
                              ("plain", fl.fused_log_prob_reference(p32, theta)),
                              (F64_SWEEP_OFF, _launch_variant(fl, off_lib, p32, theta))):
                gap = _gap(lp.double().cpu().numpy(), lp64.numpy())
                conditioning[f"{name} {label} {which}"] = gap
                parts.append(f"{label} {which} {gap:.3e}")
                if which == "kernel" and not gap <= LOGP_RTOL:
                    raise AssertionError(f"phase 16 {name}/w0wacdm near its published point, "
                                         f"{label}: f32 kernel vs f64 CPU {gap:.3e}")
            if not conditioning[f"{name} {label} {F64_SWEEP_OFF}"] > LOGP_RTOL:
                missed[f"{name} {label}"] = conditioning[f"{name} {label} {F64_SWEEP_OFF}"]
        scales = {model: bao_scales(name, model) for model in ("wzcdm", "w0wacdm")}
        conditioning[f"{name} bao table scale"] = scales
        halves = " / ".join(f"{x:.4g}" for x in scales["w0wacdm"])
        bench = torch.as_tensor(_flagship_walkers(fit, BENCH_WALKERS), device="cuda")
        sweep_ms = {"f64": _median_ms(lambda: fl.fused_log_prob(packed, bench), inner=20),
                    "3xTF32": _median_ms(lambda: _launch_variant(fl, off_lib, packed, bench),
                                         inner=20)}
        smem, blocks = fl.occupancy(packed)
        bound_ms = _split_bound_ms(fl, fit, packed, bench)[0]
        conditioning[f"{name} ms"] = dict(sweep_ms, bound_ms=bound_ms, smem_bytes=smem,
                                          blocks_per_sm=blocks)
        print(f"phase 16: {name}/w0wacdm near its published point (the f64 sweep, "
              f"sweep_cancellation {_cancellation(fl, fit):.4g}): f32 card vs f64 CPU (of "
              f"max|logp|, limit {LOGP_RTOL:g}): {', '.join(parts)}; the BAO table's scale "
              f"{scales['wzcdm'][0]:.4g} in wzcdm, {halves} in the w0wacdm halves; at "
              f"W={BENCH_WALKERS} bench walkers on {card}: kernel {sweep_ms['f64']:.4f} ms with "
              f"the f64 sweep ({smem} bytes of shared memory a block, {blocks} blocks an SM; "
              f"bound {bound_ms:.4f} ms, its products at the f64 tensor-core peak), "
              f"{sweep_ms['3xTF32']:.4f} ms with the 3xTF32 sweep (median of 20 samples of 20 "
              f"calls)")
    # the f64 sweep forced off must fail the check on each preset, whole or
    # the BAO alone
    for name in QSR_PUBLISHED:
        if all(f"{name} {label}" in missed for label in ("whole", "bao alone")):
            raise AssertionError(f"phase 16 {name}/w0wacdm: the check near the published point "
                                 f"missed {F64_SWEEP_OFF!r}: {missed}")

    return conditioning


def phase_qsr_family(card, variants):
    """Phase 16: the last six presets (ROADMAP item 10c: the five qsr.* and
    cmb.cmb) on both paths, with the fused kernel's two branches they take
    (a lift form of more than MAX_K values, qsr.des5y's 50 quasar bins; a
    fit with no emulated term, cmb.cmb); and, of the presets of phases
    14-15 whose fast path had run w0wacdm only on the CPU, sn.union3_cmb,
    whose packing is new (ROADMAP item 10c lists the rest)."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    t_phase = time.perf_counter()
    fits = {}

    def fast_fit(name, model):
        if (name, model) not in fits:
            t0 = time.perf_counter()
            fit = get_preset(name, model, fast=True, synthetic_sys=True, device="cuda")
            fits[name, model] = (fit, _pack(fl, fit), time.perf_counter() - t0)
        return fits[name, model]

    def models(name):
        if name == "cmb.cmb":
            return ("lcdm",)
        return MODELS[:3] if name in QSR_NO_W0WA else MODELS

    def lift_index(packed):
        """The index of the quasar lift among the forms, or None."""
        return next((i for i, f in enumerate(packed.forms) if fl.KINDS[f["F_KIND"]] == "lift"),
                    None)

    # the parity path in wzcdm (cmb.cmb: lcdm): all finite, 64 walkers
    # against the f64 CPU parity path
    worst = dict(fused=0.0, alone=0.0, lift=0.0, fast=0.0, parity=0.0)
    for name in QSR_FAMILY:
        par = get_preset(name, "wzcdm", synthetic_sys=True, device="cuda")
        walkers = _flagship_walkers(par, FAMILY_PARITY_WALKERS, seed=40)
        lp32 = par.log_prob()(torch.as_tensor(walkers, device="cuda")).double().cpu().numpy()
        par64 = get_preset(name, "wzcdm", synthetic_sys=True, device="cpu", dtype=torch.float64)
        gap = _gap(lp32[:64], par64.log_prob()(torch.as_tensor(walkers[:64].astype(np.float64)))
                   .numpy())
        if not (np.all(np.isfinite(lp32)) and gap <= LOGP_RTOL):
            raise AssertionError(f"phase 16 {name} parity: {int((~np.isfinite(lp32)).sum())} "
                                 f"non-finite, f32 card vs f64 CPU {gap:.3e}")
        worst["parity"] = max(worst["parity"], gap)
        print(f"phase 16: {name}/{par.model} parity on the card at W={FAMILY_PARITY_WALKERS}: "
              f"all finite; f32 card vs f64 CPU on 64 walkers {gap:.3e} of max|logp|")

    # the fast path in each model: whole and each term alone (the lift
    # alone among them) against the plain version, on the bench draw (and
    # in w0wacdm uniform over the box, both halves); f32 card against the
    # f64 CPU fast path
    for name in QSR_FAMILY:
        for model in models(name):
            fit, packed, build_s = fast_fit(name, model)
            names = [t.name for t in fit.terms if fl._emulated(t) is not None]
            draws = [("bench", _flagship_walkers(fit, FAMILY_WALKERS, seed=41))]
            if model == "w0wacdm":
                draws.append(("uniform", _box_walkers(fit, FAMILY_WALKERS, seed=42)))
            parts = []
            for dlabel, walkers in draws:
                walkers = _bad_rows(fit, walkers)
                label = f"phase 16 {name}/{model} {dlabel}"
                rel = _check_fused(fl, packed, walkers, label)
                alone, w = _each_term(fl, packed, torch.as_tensor(walkers, device="cuda"), names,
                                      label)
                worst["fused"], worst["alone"] = max(worst["fused"], rel), max(worst["alone"], w)
                parts.append(f"{dlabel} {rel:.3e}, each term alone: {', '.join(alone)}")
            i = lift_index(packed)
            lift = None if i is None else packed.forms[i]["F_K"]
            if lift is not None and lift > fl.MAX_K:  # the lift alone, worst of the draws
                for _, walkers in draws:
                    err, scale, _ = _fused_vs_plain(fl, _term_alone(fl, packed, i),
                                                    torch.as_tensor(walkers, device="cuda"))
                    worst["lift"] = max(worst["lift"], err / scale)
            gap = _gap_to_f64(fit, 43)
            if not gap <= LOGP_RTOL:
                raise AssertionError(f"phase 16 {name}/{model}: f32 card vs f64 CPU fast "
                                     f"{gap:.3e}")
            worst["fast"] = max(worst["fast"], gap)
            h = packed.hdr
            grid = (_tt_ranks(packed) if h["H_SPLIT"] else
                    f"Tucker ranks ({h['H_R1']}, {h['H_R2']}), {_layout(fl, packed)}"
                    if packed.forms else f"no grid, {_layout(fl, packed)}")
            print(f"phase 16: {name}/{model} fast, built and packed in {build_s:.2f}s ({grid}; "
                  f"{len(packed.forms)} forms, a lift of {lift or 'no'} values); fused kernel "
                  f"vs plain at W={FAMILY_WALKERS} (of max|logp|): {'; '.join(parts)}; f32 card "
                  f"vs f64 CPU fast path on 64 walkers {gap:.3e}")

    conditioning = _published_point(card, fast_fit, variants)

    # the planted faults: each must fail its term's check alone
    caught = {}
    for fault, (_, name, fault_models, key) in QSR_PLANTED.items():
        for model in fault_models:
            fit, packed, _ = fast_fit(name, model)
            i = lift_index(packed) if key == "lift" else key
            theta = torch.as_tensor(_flagship_walkers(fit, FAMILY_WALKERS, seed=44), device="cuda")
            alone = packed if key == "whole" else _term_alone(fl, packed, i)
            err, scale, _ = _fused_vs_plain(fl, alone, theta)
            if not err <= FUSED_RTOL * scale:
                raise AssertionError(f"phase 16 {name}/{model}: the term alone failed before "
                                     f"the fault: {err / scale:.3e}")
            err, scale, _ = _fused_vs_plain(fl, alone, theta, variants[fault][0])
            if err <= FUSED_RTOL * scale:
                raise AssertionError(f"phase 16 {name}/{model}: the term alone missed the "
                                     f"planted fault {fault!r}: {err / scale:.3e}")
            caught[f"{fault} {model}"] = err / scale
    print(f"phase 16: planted faults caught by their term alone (limit {FUSED_RTOL:g} of its "
          f"own max|logp|): " + "; ".join(f"{k} {v:.3e}" for k, v in caught.items()))

    # sn.union3_cmb, whose fast path had run w0wacdm on the CPU only (its
    # half 1 at full width Tucker, packed as a tensor train): the kernel
    # against its plain version on the bench and uniform draws, f32 card
    # against the f64 CPU fast path
    name = "sn.union3_cmb"
    fit, packed, build_s = fast_fit(name, "w0wacdm")
    rels = [_check_fused(fl, packed, _bad_rows(fit, walkers), f"phase 16 {name}/w0wacdm {dlabel}")
            for dlabel, walkers in (("bench", _flagship_walkers(fit, FAMILY_WALKERS, seed=45)),
                                    ("uniform", _box_walkers(fit, FAMILY_WALKERS, seed=46)))]
    gap = _gap_to_f64(fit, 47)
    if not gap <= LOGP_RTOL:
        raise AssertionError(f"phase 16 {name}/w0wacdm: f32 card vs f64 CPU fast {gap:.3e}")
    on_card = dict(fused=max(rels), fast=gap, build_seconds={name: build_s})
    print(f"phase 16: {name}/w0wacdm fast, built and packed in {build_s:.2f}s "
          f"({_tt_ranks(packed)}); fused kernel vs plain at W={FAMILY_WALKERS}: bench "
          f"{rels[0]:.3e}, uniform {rels[1]:.3e}; f32 card vs f64 CPU fast path on 64 walkers "
          f"{gap:.3e} (of max|logp|)")

    # the timing rows; qsr.des5y's also without the lift's second chunk
    # (the planted variant, timed as a probe)
    timing = {}
    for name, model, w in QSR_TIMING:
        fit, packed, _ = fast_fit(name, model)
        lib = variants["the lift's second chunk left out"][0]
        probe = (("the lift's second chunk", lambda theta: _launch_variant(fl, lib, packed, theta))
                 if name == "qsr.des5y" else None)
        timing[f"{name}/{model}"] = _fast_timing(
            fl, card, f"phase 16: fused_log_prob {name}/{model}", fit, packed, w, probe)
    seconds = time.perf_counter() - t_phase
    print(f"phase 16: worst of max|logp|: fused kernel vs plain {worst['fused']:.3e}, each term "
          f"alone {worst['alone']:.3e} (the 50-value lift alone {worst['lift']:.3e}), f32 card "
          f"vs f64 CPU fast {worst['fast']:.3e}, parity {worst['parity']:.3e}; {seconds:.1f}s "
          f"on {card}")
    return dict(worst, planted=caught, timing=timing, conditioning=conditioning,
                w0wacdm=on_card, seconds=seconds)


# phase 17: gradients on the card and the gradient samplers. The chi^2
# kernel's autograd Function against the f64 plain version's autograd on
# realistic residuals (per walker, |dg| / |g|), whole-fit gradients against
# f64 autograd on the CPU (per parameter, max|dg| over max|g|), HMC, the
# checkpoints and ``compare`` through their entry points
GRAD_WALKERS = 4096
CHI2_GRAD_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_PRESETS = (("bao.desi_cmb_des5y", "wzcdm", False), ("bao.desi_cmb_des5y", "wzcdm", True),
                ("bao.desi_cmb_des5y", "w0wacdm", True), ("joint.multiprobe", "wzcdm", True),
                ("qsr.desi", "w0wacdm", True))
HMC_CHAINS, HMC_WARMUP, HMC_SAMPLES, HMC_LEAPFROG = 512, 100, 60, 16
# BASELINE.md's published rows: (median, sigma)
BAO_DESI_PUBLISHED = {"h": (0.690, 0.005), "Om": (0.298, 0.0085)}
FLAGSHIP_PUBLISHED = {"rd": (148.08, 0.50), "H0": (68.01, 0.40), "Om": (0.3079, 0.0054)}
MEDIAN_SIGMAS, RHAT_MAX = 0.1, 1.01
COMPARE_ANCHORS = {"lcdm": 10.27, "wcdm": 9.04, "wzcdm": 8.43, "w0wacdm": 5.62}
COMPARE_ATOL = 0.01


def _grad_gap(g32, g64):
    """Per parameter, max over walkers of |g32 - g64| over max |g64| (0
    where both columns are 0), on the rows where the f64 gradient is
    finite; the rows must agree on which are finite."""
    import numpy as np

    g32, g64 = g32.double().cpu().numpy(), g64.double().cpu().numpy()
    ok = np.all(np.isfinite(g64), axis=1)
    if not np.array_equal(ok, np.all(np.isfinite(g32), axis=1)):
        raise AssertionError("the card's gradient is finite on other rows than the f64 one's")
    diff = np.max(np.abs(g32[ok] - g64[ok]), axis=0)
    scale = np.max(np.abs(g64[ok]), axis=0)
    return np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0), np.where(diff > 0, np.inf,
                                                                               0.0))


def _chi2_grad(card, label, cov, linv_np, gen):
    """(a): the chi^2 kernel's autograd Function on realistic residuals
    delta = z L^T at (GRAD_WALKERS, N): its gradient against the f64 plain
    version's autograd, |dg| / |g| per walker within CHI2_GRAD_RTOL, where
    the planted fault (the second product taken with Linv^T) must fail; a
    Hessian-vector product through the Function, finite and against the
    exact 2 (v Linv^T) Linv."""
    import numpy as np
    import torch

    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    w, n = GRAD_WALKERS, cov.shape[0]
    chol = torch.as_tensor(np.linalg.cholesky(cov), device="cuda")
    delta = (torch.randn((w, n), generator=gen, device="cuda", dtype=torch.float64)
             @ chol.T).float()
    linv = torch.as_tensor(linv_np, device="cuda").float()
    linv64 = linv.double()
    d64 = delta.double().requires_grad_(True)
    (want,) = torch.autograd.grad(kmod.whitened_chi2_reference(linv64, d64).sum(), d64)

    def rel(got):
        return float(((got.double() - want).norm(dim=1) / want.norm(dim=1)).max())

    kmod.LAUNCHES = 0
    d = delta.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(kmod.whitened_chi2(linv, d).sum(), d, create_graph=True)
    launches = kmod.LAUNCHES
    err = rel(g.detach())
    if launches != 1 or not bool(torch.isfinite(g).all()) or err > CHI2_GRAD_RTOL:
        raise AssertionError(f"{label}: the chi^2 Function's gradient at ({w}, {n}): max "
                             f"|dg|/|g| {err:.3e} against f64, {launches} forward launches")
    planted = rel((2.0 * torch.ones(w, device="cuda"))[:, None] * ((delta @ linv.T) @ linv.T))
    if planted <= CHI2_GRAD_RTOL:
        raise AssertionError(f"{label}: the gradient check missed the planted fault (second "
                             f"product with Linv^T): {planted:.3e}")
    v = torch.randn((w, n), generator=gen, device="cuda")
    (hv,) = torch.autograd.grad((g * v).sum(), d)
    hv_want = 2.0 * ((v.double() @ linv64.T) @ linv64)
    hv_err = float(((hv.double() - hv_want).norm(dim=1) / hv_want.norm(dim=1)).max())
    if not bool(torch.isfinite(hv).all()) or hv_err > CHI2_GRAD_RTOL:
        raise AssertionError(f"{label}: Hessian-vector product through the chi^2 Function: "
                             f"max rel err {hv_err:.3e}")
    fwd_ms = _median_ms(lambda: kmod.whitened_chi2(linv, delta))
    bwd_ms = _median_ms(lambda: kmod.whitened_chi2_grad(linv, delta,
                                                        torch.ones(w, device="cuda")))
    print(f"{label}: chi^2 Function on realistic residuals at (W={w}, N={n}): max |dg|/|g| "
          f"{err:.3e} against f64 autograd (limit {CHI2_GRAD_RTOL:g}), planted fault (second "
          f"product with Linv^T) {planted:.3e}; Hessian-vector product finite, max rel err "
          f"{hv_err:.3e}; on {card}: forward kernel {fwd_ms:.4f} ms, backward (two f32 "
          f"matmuls) {bwd_ms:.4f} ms (median of 20, CUDA events)")
    return dict(max_rel_err=err, planted=planted, hvp_rel_err=hv_err, forward_ms=fwd_ms,
                backward_ms=bwd_ms)


def _alone(fit, term):
    from cosmax_torch.likelihoods.base import autograd_value_and_grad, make_log_prob

    return autograd_value_and_grad(make_log_prob(fit.spec, [term], fit.derive))


def _fit_grad(label, name, model, fast):
    """(b): the card's float32 gradient of one fit against f64 autograd
    on the CPU, on GRAD_WALKERS bench walkers, whole and each term alone
    (GRAD_RTOL per parameter); on the split grid the per-term path's
    contraction takes f64 exactly where the packer gives the kernel its f64
    sweep."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    kw = dict(fast=fast, synthetic_sys=True)
    fit = get_preset(name, model, device="cuda", **kw)
    ref = get_preset(name, model, device="cpu", dtype=torch.float64, **kw)
    walkers = _flagship_walkers(fit, GRAD_WALKERS)
    th32 = torch.as_tensor(walkers, device="cuda")
    th64 = torch.as_tensor(walkers.astype(np.float64))
    if fast and model == "w0wacdm":
        bundle = next(fl._emulated(t)[1].bundle for t in fit.terms if fl._emulated(t))
        if bundle.sweep_f64 != bool(_pack(fl, fit).hdr["H_SWEEP_F64"]):
            raise AssertionError(f"{label}: {name}/{model}: the per-term path's f64 sweep "
                                 "disagrees with the packer's H_SWEEP_F64")
    gaps = {"whole": _grad_gap(fit.value_and_grad()(th32)[1], ref.value_and_grad()(th64)[1])}
    for t32, t64 in zip(fit.terms, ref.terms):
        gaps[t32.name] = _grad_gap(_alone(fit, t32)(th32)[1], _alone(ref, t64)(th64)[1])
    worst = {k: float(np.max(v)) for k, v in gaps.items()}
    tag = f"{name}/{model}{' fast' if fast else ''}"
    print(f"{label}: {tag}: float32 gradient on the card vs f64 autograd on the CPU at "
          f"{GRAD_WALKERS} bench walkers, max over parameters of max|dg| / max|g|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (limit {GRAD_RTOL:g})")
    if max(worst.values()) > GRAD_RTOL:
        raise AssertionError(f"{label}: {tag}: gradient gap {worst}")
    return fit, ref, th32, th64, worst


def _detached(term):
    """``term`` with its chi^2 cut off from the graph (a planted fault)."""
    from dataclasses import replace

    return replace(term, chi2=lambda p, t=term: t.chi2(p).detach())


def _hmc_cli(card, label, preset, model, chains, warmup, samples, fast=False,
             synthetic_sys=False, extra=(), out=None):
    """``cosmax_torch.fit --sampler hmc`` with the launch counts set to 0
    just before and read just after: (chain [T, C, D], summary, launches
    {kernel: n}, seconds)."""
    import numpy as np

    from cosmax_torch import fit as fit_cli
    from cosmax_torch.ops.kernels import fused_log_prob, whitened_chi2

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--preset", preset, "--model", model, "--sampler", "hmc",
                "--walkers", str(chains), "--burn-in", str(warmup),
                "--steps", str(warmup + samples), "--seed", "0",
                "--max-leapfrog", str(HMC_LEAPFROG), "--no-plots",
                *(["--fast"] if fast else []), *(["--synthetic-sys"] if synthetic_sys else []),
                *extra, "--out", out or tmp]
        _reset_counts()
        t0 = time.perf_counter()
        rc = fit_cli.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(fused_log_prob=fused_log_prob.LAUNCHES,
                        whitened_chi2=whitened_chi2.LAUNCHES)
        chain = np.load(os.path.join(out or tmp, "chain.npy"))
        with open(os.path.join(out or tmp, "summary.json")) as f:
            summary = json.load(f)
    if rc != 0 or not np.all(np.isfinite(chain)):
        raise AssertionError(f"{label}: HMC CLI run failed on {preset}: rc {rc}")
    s = summary["sampler"]
    print(f"{label}: cosmax_torch.fit {' '.join(argv[:-2])}: wall {wall:.2f}s on {card} "
          f"(sampling {summary['walltime_sec']:.2f}s), chain {chain.shape}, acceptance "
          f"{summary['acceptance_fraction']:.3f}, divergent trajectories "
          f"{s['divergent_trajectories']}, warmup retries {s['warmup_retries']}, rejuvenated "
          f"chains {s['rejuvenated_chains']}, {s['gradient_evals']} gradient evaluations "
          f"({s['gradient_evals'] / summary['walltime_sec']:.1f}/s), split R-hat "
          f"{np.round(s['split_gelman_rubin'], 5).tolist()}, launches {launches}")
    return chain, summary, launches, wall


def _hold_medians(label, summary, want, what):
    worst = {}
    for nm, (med, sig) in want.items():
        got = summary["params"][nm]["median"]
        worst[nm] = abs(got - med) / sig
        print(f"{label}: median {nm} = {got:.5f} against {what} {med:.5f} +- {sig:.5f}: "
              f"{worst[nm]:.3f} sigma")
    return worst


def _per_call_launches(fit, chains):
    """The chi^2 kernel's launches in one ``value_and_grad`` call at
    ``chains`` walkers."""
    import numpy as np
    import torch

    from cosmax_torch.ops.kernels import whitened_chi2

    theta = torch.as_tensor(_flagship_walkers(fit, chains).astype(np.float32), device="cuda")
    whitened_chi2.LAUNCHES = 0
    fit.value_and_grad()(theta)
    torch.cuda.synchronize()
    return whitened_chi2.LAUNCHES


def phase_grad(card):
    """Phase 17: gradients on the card and the gradient samplers."""
    import numpy as np
    import torch

    from cosmax_torch import compare
    from cosmax_torch.configs import get_preset
    from cosmax_torch.data.loaders import load_sn, use_synthetic_sys
    from cosmax_torch.likelihoods.base import autograd_value_and_grad, make_log_prob
    from cosmax_torch.samplers.optimize import fit_laplace, map_fit

    t_phase = time.perf_counter()
    out = {"part_seconds": {}}

    def lap(part):
        out["part_seconds"][part] = time.perf_counter() - t_phase - sum(
            out["part_seconds"].values())
        print(f"phase 17{part} took {out['part_seconds'][part]:.1f}s")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    # (a) the chi^2 Function on DES-SN5YR's and Union2.1's factors
    chi2 = {}
    for ds in ("des5y", "union21"):
        with use_synthetic_sys(True):
            sn = load_sn(ds)
        chi2[ds] = _chi2_grad(card, "phase 17a", sn.cov, np.ascontiguousarray(sn.linv), gen)
    out["chi2_function"] = chi2
    lap("a")

    # (b) whole-fit gradients, each term alone, and a planted fault
    grads = {}
    for name, model, fast in GRAD_PRESETS:
        fit, ref, th32, th64, worst = _fit_grad("phase 17b", name, model, fast)
        grads[f"{name}/{model}{' fast' if fast else ''}"] = worst
        if fast and name == "bao.desi_cmb_des5y" and model == "wzcdm":
            flag, flag_ref, flag_th = fit, ref, (th32, th64)
        if not fast:
            par, par_th = fit, th32
    terms = tuple(_detached(t) if t.name.startswith("cmb") else t for t in flag.terms)
    bad = autograd_value_and_grad(make_log_prob(flag.spec, terms, flag.derive))(flag_th[0])[1]
    caught = float(np.max(_grad_gap(bad, flag_ref.value_and_grad()(flag_th[1])[1])))
    if caught <= GRAD_RTOL:
        raise AssertionError(f"phase 17b: the gradient check missed the CMB term detached: "
                             f"{caught:.3e}")
    print(f"phase 17b: planted fault (the CMB term detached) on the fast flagship: gap "
          f"{caught:.3e} (limit {GRAD_RTOL:g}): caught")
    out["gradients"] = dict(grads, planted_cmb_detached=caught)
    lap("b")

    # (f) value_and_grad's time: the kernel against the per-term autograd
    times = {}
    for w in (GRAD_WALKERS, BENCH_WALKERS):
        theta = torch.as_tensor(_flagship_walkers(flag, w), device="cuda")
        lp, vg = flag.log_prob(), flag.value_and_grad()
        grad = autograd_value_and_grad(flag.differentiable_log_prob())
        times[f"fast flagship {w}"] = dict(
            value_and_grad_ms=_median_ms(lambda: vg(theta), reps=10),
            kernel_ms=_median_ms(lambda: lp(theta), reps=10),
            autograd_ms=_median_ms(lambda: grad(theta), reps=10))
    vg_par = par.value_and_grad()
    times[f"parity flagship {GRAD_WALKERS}"] = dict(
        value_and_grad_ms=_median_ms(lambda: vg_par(par_th), reps=5),
        chi2_forward_ms=chi2["des5y"]["forward_ms"], chi2_backward_ms=chi2["des5y"]["backward_ms"])
    for k, v in times.items():
        share = (f", per-term autograd {v['autograd_ms'] / v['value_and_grad_ms']:.1%} of it"
                 if "autograd_ms" in v else "")
        print(f"phase 17f: value_and_grad on the {k} walkers on {card}: "
              + ", ".join(f"{a} {b:.4f}" for a, b in v.items()) + share)
    out["times"] = times
    lap("f")

    # (c) HMC through the CLI
    desi = get_preset("bao.desi", "lcdm", device="cuda")
    k_desi = _per_call_launches(desi, HMC_CHAINS)
    hmc = {}
    chain, summary, launches, wall = _hmc_cli(card, "phase 17c", "bao.desi", "lcdm", HMC_CHAINS,
                                              HMC_WARMUP, HMC_SAMPLES)
    runs = [("bao.desi lcdm parity", summary, launches, "whitened_chi2", k_desi,
             _hold_medians("phase 17c", summary, BAO_DESI_PUBLISHED, "published"))]
    flag_lcdm = get_preset("bao.desi_cmb_des5y", "lcdm", fast=True, device="cpu",
                           dtype=torch.float64)
    best, _, _ = map_fit(flag_lcdm)
    x = np.array([best[nm] for nm in flag_lcdm.spec.names])
    _, sig, _ = fit_laplace(flag_lcdm, x)
    laplace = {nm: (best[nm], float(s)) for nm, s in zip(flag_lcdm.spec.names, sig)}
    chain, summary, launches, wall = _hmc_cli(card, "phase 17c", "bao.desi_cmb_des5y", "lcdm",
                                              HMC_CHAINS, HMC_WARMUP, HMC_SAMPLES, fast=True)
    # the published rows were run with DES-SN5YR's systematic covariance,
    # which the data store lacks (VALIDATION.md): the medians are held to
    # the f64 Laplace fit of the same likelihood, the published distance
    # printed beside them
    _hold_medians("phase 17c", summary, FLAGSHIP_PUBLISHED, "published (not held)")
    runs.append(("bao.desi_cmb_des5y lcdm fast", summary, launches, "fused_log_prob", 1,
                 _hold_medians("phase 17c", summary,
                               {k: laplace[k] for k in FLAGSHIP_PUBLISHED}, "f64 Laplace")))
    for tag, summary, launches, kernel, per_call, worst in runs:
        s = summary["sampler"]
        rhat = max(s["split_gelman_rubin"])
        need = per_call * s["gradient_evals"]
        if max(worst.values()) > MEDIAN_SIGMAS or rhat >= RHAT_MAX:
            raise AssertionError(f"phase 17c: {tag}: medians {worst} sigma, split R-hat {rhat}")
        if launches[kernel] < need:
            raise AssertionError(f"phase 17c: {tag}: {kernel} launched {launches[kernel]} "
                                 f"times for {s['gradient_evals']} gradient evaluations")
        hmc[tag] = dict(medians_sigma=worst, split_rhat=rhat, launches=launches[kernel],
                        gradient_evals=s["gradient_evals"],
                        gradient_evals_per_s=s["gradient_evals"] / summary["walltime_sec"],
                        divergent=s["divergent_trajectories"], retries=s["warmup_retries"])
        print(f"phase 17c: {tag}: {launches[kernel]} {kernel} launches for "
              f"{s['gradient_evals']} gradient evaluations ({per_call} a call, every leapfrog)")
    # the parity flagship's HMC (its chi^2 Function on the card) runs in
    # phase 18's dry run, through the row-block entry: the 64-chain CLI run
    # that held it here left for phase 18's time
    out["hmc"] = hmc
    lap("c")

    # (d) checkpoints: two segments equal the straight run bit for bit
    ck = {}
    with tempfile.TemporaryDirectory() as tmp:
        for sampler, base, n0, n1 in (("ensemble", ["--burn-in", "0"], 10, 20),
                                      ("hmc", ["--sampler", "hmc", "--burn-in", "20",
                                               "--max-leapfrog", str(HMC_LEAPFROG)], 30, 40)):
            path = os.path.join(tmp, f"{sampler}.npz")
            # --synthetic-sys: phase 7's build of the fast flagship
            argv = ["--preset", "bao.desi_cmb_des5y", "--fast", "--synthetic-sys",
                    "--walkers", "64", "--seed", "3", "--no-plots", *base]

            def cli(steps, *extra, o=os.path.join(tmp, "o")):
                from cosmax_torch import fit as fit_cli

                if fit_cli.main([*argv, "--steps", str(steps), *extra, "--out", o]) != 0:
                    raise AssertionError(f"phase 17d: {sampler} CLI run failed")
                return np.load(os.path.join(o, "chain.npy"))

            straight = cli(n1)
            segs = [cli(n, "--checkpoint", path, "--checkpoint-every", "10") for n in (n0, n1)]
            same = np.array_equal(np.concatenate(segs), straight)
            if not same:
                raise AssertionError(f"phase 17d: {sampler}: the checkpointed run differs from "
                                     "the straight run")
            ck[sampler] = dict(shape=list(straight.shape), bitwise=same)
            print(f"phase 17d: --fast {sampler}, two checkpointed runs (--steps {n0}, then "
                  f"{n1}) equal the straight run (--steps {n1}) bit for bit, chain "
                  f"{straight.shape}")
    out["checkpoints"] = ck
    lap("d")

    # (e) compare on the card
    with tempfile.TemporaryDirectory() as tmp:
        js = os.path.join(tmp, "c.json")
        compare.main(["--preset", "bao.desi", "--json", js])
        with open(js) as f:
            rows = {r["model"]: r for r in json.load(f)}
        for model, want in COMPARE_ANCHORS.items():
            if abs(rows[model]["chi2_min"] - want) > COMPARE_ATOL:
                raise AssertionError(f"phase 17e: compare bao.desi {model}: chi2_min "
                                     f"{rows[model]['chi2_min']} != {want}")
        t0 = time.perf_counter()
        compare.main(["--preset", "bao.desi", "--models", "lcdm,wzcdm", "--sampled-evidence",
                      "--replicates", "2", "--json", js])
        ss_s = time.perf_counter() - t0
        with open(js) as f:
            ss = {r["model"]: r for r in json.load(f)}
    d_ss, d_lap = ss["wzcdm"]["dlog_evidence_ss"], ss["wzcdm"]["dlog_evidence"]
    err = ss["wzcdm"]["log_evidence_ss_err"]
    print(f"phase 17e: compare bao.desi on {card}: chi2_min "
          + " / ".join(f"{rows[m]['chi2_min']:.4f}" for m in COMPARE_ANCHORS)
          + f" (anchors {' / '.join(str(v) for v in COMPARE_ANCHORS.values())}); stepping stone "
          f"wzcdm - lcdm {d_ss:+.3f} +- {err:.3f} against Laplace {d_lap:+.3f} ({ss_s:.1f}s)")
    if abs(d_ss - d_lap) > 3.0 * err + 0.05:
        raise AssertionError(f"phase 17e: stepping-stone ln Z difference {d_ss} +- {err} "
                             f"against Laplace {d_lap}")
    out["compare"] = dict(chi2_min={m: rows[m]["chi2_min"] for m in COMPARE_ANCHORS},
                          dlnz_ss=d_ss, dlnz_ss_err=err, dlnz_laplace=d_lap, ss_seconds=ss_s)
    lap("e")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17 took {out['seconds']:.1f}s on {card}")
    return out


def _rows_launch(lib, block, tensor_map, delta):
    """A row block's share from a library's row-block C entry (this
    source's, or a planted variant's), launched straight on the split
    slab's tensor map (the wrappers' launch counts stay as they are)."""
    import torch

    from cosmax_torch.ops.kernels import whitened_chi2 as kmod

    out = torch.empty(delta.shape[0], dtype=torch.float32, device=delta.device)
    err = kmod._rows_entry(lib)(tensor_map, delta.data_ptr(), out.data_ptr(),
                                delta.shape[0], delta.shape[1], block.ld - block.rows,
                                block.rows, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chi^2 row-block kernel failed: cudaError {err}")
    return out


def _rel(got, want):
    """max |got - want| / |want| per walker, in f64."""
    return float(((got.double() - want.double()).abs() / want.double().abs()).max())


def phase_rows(card, variants, ptxas_rows):
    """Phase 18 (a): the chi^2 kernel's row-block kernel at (65,536, 1829)
    on realistic residuals of DES-SN5YR's covariance, for d = 2 and d = 4
    blocks by equal work: each block through ``whitened_chi2_rows`` with its
    split kept (as the sharded path keeps it), one launch a call, against
    its plain version (f32, rtol 5e-5) and its f64 plain version
    (RTOL_CHI2_F64), a ragged batch, a repeat launch bit for bit; the
    blocks' sum against the square kernel (1e-6 a walker); the planted
    faults (CHI2_ROWS_PLANTED) on d = 2's second block, each of which must
    fail the f64 check; each block's time beside the square kernel's, the
    block's 3xTF32 bound and its plain version's (one cuBLAS product, f32:
    the library call too), and with the slab split at every call; the
    row-block kernel at (0, N) beside the square kernel, for the record."""
    import numpy as np
    import torch

    from cosmax_torch.data.loaders import load_sn, use_synthetic_sys
    from cosmax_torch.ops.kernels import whitened_chi2 as kmod
    from cosmax_torch.ops.kernels.build import load_kernel
    from cosmax_torch.ops.kernels.whitened_chi2 import (
        row_blocks,
        split_rows,
        whitened_chi2,
        whitened_chi2_reference,
        whitened_chi2_rows,
        whitened_chi2_rows_reference,
    )

    t_phase = time.perf_counter()
    with use_synthetic_sys(True):
        sn = load_sn("des5y")
    w, n = BENCH_WALKERS, sn.n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    chol = torch.as_tensor(np.linalg.cholesky(sn.cov), device="cuda")
    z = torch.randn((w, n), generator=gen, device="cuda", dtype=torch.float64)
    delta = (z @ chol.T).float()
    del z, chol
    linv = torch.as_tensor(np.ascontiguousarray(sn.linv), device="cuda").float()
    lib = load_kernel("whitened_chi2_rows").lib
    square = whitened_chi2(linv, delta)
    square_ms = _median_ms(lambda: whitened_chi2(linv, delta))
    # the row-block kernel over all N rows: not a route of the port (the
    # wrapper sends a slab of N rows to the square kernel), timed beside it
    full = split_rows(linv)
    full_map = kmod.encode_tensor_map(lib, full)
    whole = _rows_launch(lib, full, full_map, delta)
    whole_rel64 = _rel(whole, whitened_chi2_reference(linv.double(), delta.double()))
    whole_ms = _median_ms(lambda: _rows_launch(lib, full, full_map, delta))
    if not whole_rel64 <= RTOL_CHI2_F64:
        raise AssertionError(f"phase 18: the row-block kernel at (0, {n}) vs f64 plain: "
                             f"{whole_rel64:.3e}")
    del full, full_map
    print(f"phase 18: on {card}, ptxas whitened_chi2_rows_kernel {ptxas_rows}; square kernel "
          f"{square_ms:.4f} ms at (W={w}, N={n}); the row-block kernel over rows [0, {n}) "
          f"{whole_ms:.4f} ms ({whole_ms / square_ms:.3f}x the square's; not a route of the "
          f"port), vs f64 plain {whole_rel64:.3e}")
    out = dict(square_ms=square_ms, rows_kernel_at_0_n=dict(ms=whole_ms, max_rel_err_f64=whole_rel64),
               ptxas=ptxas_rows, parts={})
    ragged = delta[: w // 2 + 37]
    for parts in ROWS_PARTS:
        cuts = row_blocks(n, parts)
        total = torch.zeros(w, dtype=torch.float64, device="cuda")
        blocks = []
        for r0, r1 in zip(cuts, cuts[1:]):
            slab = linv[r0:r1, :r1].contiguous()
            block = split_rows(slab)
            before = (kmod.LAUNCHES, kmod.ROWS_LAUNCHES)
            got = whitened_chi2_rows(block, delta)
            if (kmod.LAUNCHES - before[0], kmod.ROWS_LAUNCHES - before[1]) != (1, 1):
                raise AssertionError(f"phase 18: rows [{r0}, {r1}): one call made "
                                     f"{kmod.LAUNCHES - before[0]} launches "
                                     f"({kmod.ROWS_LAUNCHES - before[1]} of the row-block kernel)")
            again = whitened_chi2_rows(block, delta)
            plain = whitened_chi2_rows_reference(slab, delta)
            want64 = whitened_chi2_rows_reference(slab.double(), delta.double())
            part_rag = whitened_chi2_rows(block, ragged)
            torch.cuda.synchronize()
            rel, rel64 = _rel(got, plain), _rel(got, want64)
            rel_rag = float((part_rag - got[: ragged.shape[0]]).abs().max() / got.abs().max())
            repeat = torch.equal(got, again)
            if not (rel <= RTOL_KERNEL and rel64 <= RTOL_CHI2_F64 and rel_rag <= RTOL_KERNEL
                    and repeat and bool(torch.isfinite(got).all())):
                raise AssertionError(f"phase 18: rows [{r0}, {r1}) of {n}: kernel vs plain "
                                     f"{rel:.3e}, vs f64 plain {rel64:.3e}, ragged {rel_rag:.3e}, "
                                     f"repeat bit for bit {repeat}")
            total += got.double()
            ms = _median_ms(lambda: whitened_chi2_rows(block, delta))
            split_ms = _median_ms(lambda: whitened_chi2_rows(slab, delta))
            plain_ms = _median_ms(lambda: whitened_chi2_rows_reference(slab, delta))
            flop = w * (r1 * (r1 + 1) - r0 * (r0 + 1))  # the block's triangle
            tc_ms = 1e3 * 3 * flop / PEAK_TF32_FLOPS
            bytes_ms = 1e3 * 4.0 * (w * r1 + (r1 - r0) * r1 + w) / PEAK_BYTES
            bound = max(tc_ms, bytes_ms)
            blocks.append(dict(rows=[r0, r1], max_rel_err=rel, max_rel_err_f64=rel64,
                               max_abs_err=float((got - plain).abs().max()), ms=ms,
                               ms_split_each_call=split_ms, plain_ms=plain_ms,
                               library_ms=plain_ms, bound_ms=bound,
                               bound_by="operations" if tc_ms >= bytes_ms else "bytes"))
            print(f"phase 18: d={parts} rows [{r0}, {r1}): kernel vs plain {rel:.3e} (limit "
                  f"{RTOL_KERNEL:g}), vs f64 plain {rel64:.3e} (limit {RTOL_CHI2_F64:g}), ragged "
                  f"batch {rel_rag:.3e}, repeat bit for bit; {ms:.4f} ms ({split_ms:.4f} split "
                  f"at each call), plain (cuBLAS, f32) {plain_ms:.4f} ms ({plain_ms / ms:.2f}x "
                  f"the kernel's), bound {bound:.4f} ms (3xTF32 {tc_ms:.4f}, bytes "
                  f"{bytes_ms:.4f}), {ms / bound:.2f}x")
        gap = float(((total - square.double()).abs() / square.double().abs()).max())
        if gap > 1e-6:
            raise AssertionError(f"phase 18: d={parts}: the blocks' sum vs the square kernel: "
                                 f"{gap:.3e}")
        slowest = max(b["ms"] for b in blocks)
        out["parts"][str(parts)] = dict(cuts=cuts, blocks=blocks, sum_vs_square=gap,
                                        slowest_over_square=slowest / square_ms)
        print(f"phase 18: d={parts}: blocks {cuts} by equal work; their sum vs the square "
              f"kernel {gap:.3e} a walker (limit 1e-6); slowest block {slowest:.4f} ms = "
              f"{slowest / square_ms:.3f} of the square kernel's {square_ms:.4f} (1/d = "
              f"{1 / parts:.3f})")
    # the planted faults: d = 2's second block, rows [1296, 1829) (its
    # trailing tile of 21 rows)
    r0, r1 = row_blocks(n, 2)[1:]
    block = split_rows(linv[r0:r1, :r1].contiguous())
    want64 = whitened_chi2_rows_reference(block.unsplit().double(), delta.double())
    caught = {}
    for name in CHI2_ROWS_PLANTED:
        lib_v = variants[name][0]
        got_v = _rows_launch(lib_v, block, kmod.encode_tensor_map(lib_v, block), delta)
        caught[name] = _rel(got_v, want64)
        if not caught[name] > RTOL_CHI2_F64:
            raise AssertionError(f"phase 18: the row-block check missed the planted fault "
                                 f"{name!r}: {caught[name]:.3e}")
    print(f"phase 18: planted faults on rows [{r0}, {r1}) against the f64 plain version: "
          + ", ".join(f"{k} {v:.3e}" for k, v in caught.items()) + ": all caught")
    out.update(planted=caught, walkers=w, n=n, seconds=time.perf_counter() - t_phase)
    return out


def _dryrun_gap(a, b):
    """max |a - b| over the finite values, of max|b|; -inf rows must agree."""
    import numpy as np

    if not np.array_equal(np.isinf(a), np.isinf(b)):
        return float("inf")
    fin = np.isfinite(b)
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin].astype(np.float64) - b[fin])) / np.max(np.abs(b[fin])))


def phase_dryrun(card):
    """Phase 18 (b, c): the port of dryrun_multichip (cosmax_torch/dryrun.py)
    under NCCL at world size 1 in this process, then on a gloo pair, both
    ranks on cuda:0 with d = 2 (each launches the row-block entry on its
    own rows of DES-SN5YR's whitener and the fused kernel on its walkers),
    through the spawn helper; the pair's results against world size 1
    (the parity log-prob and chains within 1e-6 of max|logp|, the fast
    calls bit for bit: on the pair's mesh a fast preset's walkers split over
    'd', so each rank's fused launch takes half of them) and the kernels'
    launches in each run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cosmax_torch import dryrun
    from cosmax_torch.ops.kernels import fused_log_prob, whitened_chi2
    from cosmax_torch.parallel import spawn
    from cosmax_torch.parallel.launch import resolve_rank_device

    opts = dict(eval_walkers=BENCH_WALKERS, synthetic_sys=True)
    t0 = time.perf_counter()
    resolve_rank_device("cuda", 0, "nccl")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            _reset_counts()
            one = dryrun.run(opts)
            launches = dict(whitened_chi2=whitened_chi2.LAUNCHES,
                            fused_log_prob=fused_log_prob.LAUNCHES)
        finally:
            dist.destroy_process_group()
    one_s = time.perf_counter() - t0
    if min(launches.values()) == 0 or one["launches"] != launches:
        raise AssertionError(f"phase 18: the NCCL dry run's launches {launches} "
                             f"(its own count {one['launches']})")
    print(f"phase 18: dry run under NCCL at world size 1 on {card}: mesh {one['mesh']}, "
          f"{one_s:.1f}s, launches {launches}")
    t0 = time.perf_counter()
    pair = spawn("cosmax_torch.dryrun:run", 2, backend="gloo", device="cuda:0",
                 args=(dict(opts, data=2),), timeout=DRYRUN_PAIR_TIMEOUT)
    pair_s = time.perf_counter() - t0
    checks = {}
    for rank, got in enumerate(pair):
        if got["mesh"] != {"w": 1, "d": 2} or min(got["launches"].values()) == 0:
            raise AssertionError(f"phase 18: gloo rank {rank}: mesh {got['mesh']}, launches "
                                 f"{got['launches']}")
        if got["parity flagship"]["launches"]["whitened_chi2"] == 0:
            raise AssertionError(f"phase 18: gloo rank {rank} launched no row block")
        if got["row_block_launches"] == 0:
            raise AssertionError(f"phase 18: gloo rank {rank} never launched the row-block kernel")
        if got["device"] != "cuda:0":
            raise AssertionError(f"phase 18: gloo rank {rank} ran on {got['device']}")
        for label in ("fast flagship wzcdm", "fast flagship w0wacdm", "fast multiprobe lcdm"):
            if got[label]["launches"]["fused_log_prob"] == 0:
                raise AssertionError(f"phase 18: gloo rank {rank} made no fused launch on its "
                                     f"half of the {label} walkers")
        for label, key, tol in (("parity flagship", "logp", 1e-6),
                                ("fast flagship wzcdm", "logp", 0.0),
                                ("fast flagship w0wacdm", "logp", 0.0),
                                ("fast multiprobe lcdm", "logp", 0.0),
                                ("chain", "log_probs", 1e-6), ("hmc", "log_probs", 1e-6),
                                ("wzcdm_step", "log_probs", 0.0),
                                ("w0wacdm_step", "log_probs", 0.0),
                                ("multiprobe_step", "log_probs", 0.0)):
            a, b = np.asarray(got[label][key]), np.asarray(one[label][key])
            gap = _dryrun_gap(a, b) if tol else (0.0 if np.array_equal(a, b) else float("inf"))
            if not gap <= tol:
                raise AssertionError(f"phase 18: gloo rank {rank}, {label}: {key} against world "
                                     f"size 1: {gap:.3e} (limit {tol:g}"
                                     f"{', bit for bit' if not tol else ''})")
            checks[label] = max(checks.get(label, 0.0), gap)
        for key in ("samples", "accepted"):
            if not np.array_equal(got["chain"][key], one["chain"][key]):
                raise AssertionError(f"phase 18: gloo rank {rank}: the chain's {key} differ "
                                     "from world size 1")
    print(f"phase 18: dry run on a gloo pair (both ranks on cuda:0, mesh w=1 x d=2) on {card}: "
          f"{pair_s:.1f}s; against world size 1 (of max|logp|): "
          + ", ".join(f"{k} {v:.3e}" for k, v in checks.items())
          + f"; launches rank 0 {pair[0]['launches']}, rank 1 {pair[1]['launches']} (of the "
          f"row-block kernel {pair[0]['row_block_launches']}, {pair[1]['row_block_launches']})")
    offsets = {k: one[k].get("offset_bitwise") for k in one
               if isinstance(one[k], dict) and "offset_bitwise" in one[k]}
    print(f"phase 18: a walker's fused log-prob from its own row alone (a block from walker "
          f"{dryrun.ROW_OFFSET}, bit for bit): {offsets}")
    if not all(offsets.values()):
        raise AssertionError(f"phase 18: a fused log-prob depends on the walker's place in its "
                             f"block: {offsets}")
    strip = ("logp",)

    def summary(run):
        return {k: ({kk: vv for kk, vv in v.items() if kk not in strip and not hasattr(vv, "shape")}
                    if isinstance(v, dict) else v)
                for k, v in run.items() if k not in ("chain", "hmc", "step", "ladder")}

    return dict(nccl_world_1=dict(summary(one), seconds=one_s, launches=launches),
                gloo_world_2=dict(summary(pair[0]), seconds=pair_s,
                                  launches=[r["launches"] for r in pair],
                                  row_block_launches=[r["row_block_launches"] for r in pair]),
                against_world_1=checks, offset_bitwise=offsets)


def _tool(name):
    """The module of ``tools/<name>.py`` (tools/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_outer(card):
    """Phase 19: the outer layers (ROADMAP items 13 and 14) on the card.
    (a) the GP reconstruction of H(z) at its 5,000 Adam steps against the
    published hyperparameters and H0 (tests/test_gp.py) and against the
    port's f64 CPU run at the same steps (H(z) mean and sigma on the grid
    within GP_RTOL); (b) the quintessence field against the f64 CPU within
    FIELD_RTOL of each array's max|value|; (c) the emcee facade over the
    fast flagship's ``fit.log_prob()`` (64 walkers x 200 steps: a finite
    chain, acceptance in (0, 1), at least two fused launches a step; the
    same seed twice bit for bit; an ``NpzBackend`` run stopped after 100
    steps and resumed, bit for bit against the straight run); (d)
    ``fit.main --out``: the fast flagship with --no-plots (summary with the
    derived and residual blocks, fused launches) and ``sn.pantheon`` parity
    (the HTML Hubble diagram, chi^2 kernel launches), and with the figures
    where matplotlib is installed; (e) ``tools/torch_profile_terms.py`` on
    the fast flagship at 65,536 walkers and the parity flagship at 4,096;
    (f) ``timed_evals`` against CUDA events over the same calls, and a
    profiler trace written."""
    import glob

    import numpy as np
    import torch

    from cosmax_torch import fit as fit_cli
    from cosmax_torch.compat import EnsembleSampler as Facade
    from cosmax_torch.compat import NpzBackend
    from cosmax_torch.configs import get_preset
    from cosmax_torch.data import load_cc
    from cosmax_torch.gp import reconstruct_hz
    from cosmax_torch.models.scalar_field import reconstruct
    from cosmax_torch.ops.kernels import fused_log_prob, whitened_chi2
    from cosmax_torch.utils.debugging import profile_trace, timed_evals

    out, t_phase = {}, time.perf_counter()

    # (a) the GP on the card (float32) and on the CPU (float64)
    ds = load_cc()
    times = {}
    runs = {}
    for label, kw in (("card", dict(device="cuda")),
                      ("cpu_f64", dict(device="cpu", dtype=torch.float64))):
        t0 = time.perf_counter()
        runs[label] = reconstruct_hz(ds.z, ds.values, ds.cov, iters=GP_STEPS, **kw)
        times[label] = time.perf_counter() - t0
    gp, ref = runs["card"], runs["cpu_f64"]
    info = gp["info"]
    gaps = {k: float(np.max(np.abs(gp[k] - ref[k]) / np.abs(ref[k]))) for k in ("h_mean", "h_std")}
    h0, sig = float(gp["h_mean"][0]), float(gp["h_std"][0])
    q, zg = gp["q"], gp["z_grid"]
    print(f"phase 19: GP H(z) on {card}: {GP_STEPS} Adam steps in {times['card']:.2f}s "
          f"({GP_STEPS / times['card']:.1f} steps/s; f64 CPU {times['cpu_f64']:.2f}s); "
          f"lengthscale {info['lengthscale']:.4f}, noise_scale {info['noise_scale']:.4f}, "
          f"H0 {h0:.2f} +- {sig:.2f}, q(0) {q[0]:.3f}, q(z_max) {q[-1]:.3f}; against f64 CPU: "
          f"H mean {gaps['h_mean']:.3e}, sigma {gaps['h_std']:.3e} (limit {GP_RTOL:g})")
    if not (abs(info["lengthscale"] - 2.366) <= 0.05 and abs(info["noise_scale"] - 0.489) <= 0.03
            and abs(h0 - 67.5) <= 2.0 and 2.0 < sig < 8.0 and q[0] < 0 and q[zg > 1.5][-1] > 0):
        raise AssertionError("phase 19: the GP misses the published hyperparameters or H0")
    if max(gaps.values()) > GP_RTOL:
        raise AssertionError(f"phase 19: the card's GP against the f64 CPU: {gaps}")
    out["gp"] = dict(seconds=times["card"], steps_per_s=GP_STEPS / times["card"],
                     cpu_f64_seconds=times["cpu_f64"], lengthscale=info["lengthscale"],
                     noise_scale=info["noise_scale"], H0=h0, H0_sigma=sig,
                     against_cpu_f64=gaps)

    # (b) the quintessence field
    t0 = time.perf_counter()
    got = reconstruct(0.307, -0.833, device="cuda")
    field_s = time.perf_counter() - t0
    want = reconstruct(0.307, -0.833, device="cpu", dtype=torch.float64)
    fgap = {k: float(np.max(np.abs(got[k] - want[k])) / max(np.max(np.abs(want[k])), 1e-300))
            for k in want}
    print(f"phase 19: field reconstruct(0.307, -0.833) on {card} in {field_s:.3f}s; against f64 "
          f"CPU (of each array's max|value|, limit {FIELD_RTOL:g}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in fgap.items()))
    if max(fgap.values()) > FIELD_RTOL:
        raise AssertionError(f"phase 19: the field on the card against f64 CPU: {fgap}")
    out["field"] = dict(seconds=field_s, against_cpu_f64=fgap)

    # (c) the emcee facade over the fast flagship's batched log-prob
    fit = get_preset("bao.desi_cmb_des5y", "wzcdm", fast=True, device="cuda")
    lp = fit.log_prob()
    p0 = _flagship_walkers(fit, FACADE_WALKERS, seed=19)

    def facade(backend=None):
        return Facade(FACADE_WALKERS, fit.spec.dim, lp, vmapped_log_prob=lp, seed=19,
                      backend=backend, device=fit.device)

    _reset_counts()
    t0 = time.perf_counter()
    first = facade()
    first.run_mcmc(p0, FACADE_STEPS)
    torch.cuda.synchronize()
    facade_s = time.perf_counter() - t0
    compat_launches = fused_log_prob.LAUNCHES
    compat_chi2_launches = whitened_chi2.LAUNCHES
    chain, acc = first.get_chain(), float(first.acceptance_fraction.mean())
    again = facade()
    again.run_mcmc(p0, FACADE_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.npz")
        facade(NpzBackend(path)).run_mcmc(p0, FACADE_STEPS // 2)
        resumed = facade(NpzBackend(path))  # a new process would do the same
        resumed.run_mcmc(None, FACADE_STEPS - FACADE_STEPS // 2)
        resumed_chain = resumed.get_chain()
    same = bool(np.array_equal(chain, again.get_chain())
                and np.array_equal(first.get_log_prob(), again.get_log_prob()))
    resume_ok = bool(np.array_equal(chain, resumed_chain)
                     and np.array_equal(first.get_log_prob(), resumed.get_log_prob()))
    print(f"phase 19: emcee facade over fit.log_prob() (fast flagship wzcdm) on {card}: "
          f"{FACADE_WALKERS} walkers x {FACADE_STEPS} steps in {facade_s:.2f}s "
          f"({FACADE_STEPS / facade_s:.1f} steps/s), acceptance {acc:.3f}, {compat_launches} fused "
          f"launches ({compat_launches / FACADE_STEPS:.2f} a step), {compat_chi2_launches} chi2 "
          f"launches; same seed twice bit for bit: "
          f"{same}; NpzBackend stopped at {FACADE_STEPS // 2} and resumed = straight, bit for "
          f"bit: {resume_ok}")
    if not (np.all(np.isfinite(chain)) and chain.shape == (FACADE_STEPS, FACADE_WALKERS,
                                                            fit.spec.dim) and 0.0 < acc < 1.0):
        raise AssertionError(f"phase 19: facade chain {chain.shape}, acceptance {acc}")
    if compat_launches < 2 * FACADE_STEPS or not same or not resume_ok:
        raise AssertionError(f"phase 19: facade launches {compat_launches}, same seed {same}, "
                             f"resume {resume_ok}")
    out["compat"] = dict(seconds=facade_s, steps_per_s=FACADE_STEPS / facade_s, acceptance=acc,
                         launches=compat_launches, chi2_launches=compat_chi2_launches,
                         bitwise_rerun=same, bitwise_resume=resume_ok)

    # (d) fit --out
    try:
        import matplotlib

        mpl = matplotlib.__version__
    except ImportError:
        mpl = None
    print(f"phase 19: matplotlib on this machine: {mpl or 'not installed'}")
    fit_out = {}
    runs = [("fast flagship", ["--preset", "bao.desi_cmb_des5y", "--fast", "--walkers", "64"],
             fused_log_prob, True),
            ("sn.pantheon parity", ["--preset", "sn.pantheon", "--walkers", "150"],
             whitened_chi2, True)]
    if mpl is not None:
        runs.append(("sn.pantheon parity, figures", ["--preset", "sn.pantheon", "--walkers",
                                                     "150"], whitened_chi2, False))
    for label, argv, kmod, no_plots in runs:
        with tempfile.TemporaryDirectory() as tmp:
            _reset_counts()
            t0 = time.perf_counter()
            rc = fit_cli.main([*argv, "--model", "wzcdm", "--steps", "20", "--seed", "0",
                               "--out", tmp, *(["--no-plots"] if no_plots else [])])
            wall = time.perf_counter() - t0
            files = sorted(os.listdir(tmp))
            with open(os.path.join(tmp, "summary.json")) as f:
                summ = json.load(f)
        n = kmod.LAUNCHES
        print(f"phase 19: fit --out, {label}: rc {rc}, {wall:.2f}s, {n} "
              f"{kmod.__name__.split('.')[-1]} launches; files {files}; derived "
              f"{sorted(summ['derived'])}; residual_stats {summ['residual_stats']}")
        want = {"summary.json", "chain.npy"}
        if "pantheon" in label:
            want.add("predictions_sn.html")
        if not no_plots:
            want |= {"corner.png", "trace.png", "predictions_sn.png"}
        # the flagship derives Om h^2, z*, r_d...; sn.pantheon samples no H0
        if rc != 0 or n == 0 or not want <= set(files) or "sn" not in summ["residual_stats"] \
                or ("flagship" in label and not summ["derived"]):
            raise AssertionError(f"phase 19: fit --out, {label}: rc {rc}, launches {n}, "
                                 f"files {files}")
        fit_out[label] = dict(launches=n, seconds=wall, files=files)
    out["fit_out"] = fit_out

    # (e) the per-term ablation tool, fast and parity
    tool = _tool("torch_profile_terms")
    prof = {}
    for label, kw in (("fast", dict(walkers=BENCH_WALKERS, iters=200, fast=True, fit=fit)),
                      ("parity", dict(walkers=4096, iters=5, fast=False))):
        r = tool.profile_terms("bao.desi_cmb_des5y", "wzcdm", **kw)
        print(f"phase 19: torch_profile_terms {label} flagship at {r['walkers']} walkers on "
              f"{card} (median of {r['rounds']} rounds of {r['iters']} calls): full "
              f"{r['full_ms']:.4f} ms; "
              + ", ".join(f"{k} {share:+.4f} ms (rounds {r['spread'][k][0]:+.4f} to "
                          f"{r['spread'][k][1]:+.4f}; without it {w:.4f})"
                          for k, (w, share) in r["terms"].items())
              + f"; launches {r['launches']}")
        prof[label] = r
    if prof["fast"]["launches"]["fused_log_prob"] == 0 or \
            prof["parity"]["launches"]["whitened_chi2"] == 0:
        raise AssertionError(f"phase 19: torch_profile_terms launched "
                             f"{[p['launches'] for p in prof.values()]}")
    out["profile_terms"] = prof

    # (f) timed_evals against CUDA events over the same calls; a trace
    theta = torch.as_tensor(_flagship_walkers(fit, BENCH_WALKERS), device=fit.device)
    lp(theta)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rate, dt = timed_evals(lp, (theta,), iters=500, warmup=0)
    stop.record()
    stop.synchronize()
    ev_s = start.elapsed_time(stop) / 1e3
    gap = abs(dt - ev_s) / ev_s
    # the trace holds TRACE_CALLS back-to-back calls: the device's busy
    # share of their span says whether the host or the kernel paces them
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as p:
            start.record()
            for _ in range(TRACE_CALLS):
                lp(theta)
            stop.record()
            stop.synchronize()
        traces = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        ops = sorted(((getattr(e, "self_device_time_total", 0.0) or 0.0, e.count, e.key)
                      for e in p.key_averages()), reverse=True)
        dev_us = sum(t for t, _, _ in ops)
    span_us = 1e3 * start.elapsed_time(stop)
    top_ops = [dict(name=k[:60], calls=n, us=t) for t, n, k in ops[:3] if t > 0]
    busy = (f"device time {dev_us:.1f} us of a {span_us:.1f} us span ({dev_us / span_us:.1%} "
            f"busy, under the profiler); the most device time: {top_ops}" if dev_us > 0 else
            "the profiler recorded no device time (not measured)")
    print(f"phase 19: timed_evals of fit.log_prob() at {BENCH_WALKERS} walkers: {rate:.1f} "
          f"calls/s over {dt:.4f}s, CUDA events {ev_s:.4f}s (gap {gap:.2%}, limit 10%); "
          f"profile_trace wrote {len(traces)} trace file(s) of {TRACE_CALLS} calls: {busy}")
    if gap > 0.10 or not traces:
        raise AssertionError(f"phase 19: timed_evals {dt} s against events {ev_s} s; traces "
                             f"{traces}")
    out["debugging"] = dict(timed_evals_s=dt, events_s=ev_s, gap=gap, trace_files=len(traces),
                            trace_calls=TRACE_CALLS, trace_device_us=dev_us, trace_span_us=span_us,
                            trace_top_ops=top_ops)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['seconds']:.1f}s")
    print("phase 19: " + json.dumps(
        {k: out[k] for k in ("gp", "field", "compat", "profile_terms", "debugging")},
        default=float))
    return out


# phase 20: the last tools of the JAX package on the card (ROADMAP item 15),
# cut to fit the phase: the evidence convergence on the fast flagship in
# lcdm (2 replicate ladders, base budget 6 + 6, one doubling, golden x2),
# one seed of the warmup sweep (128 chains, 30 warmup steps), the row
# precheck on three rows that the JAX precheck passes (bao.desi_union3_omh2
# with its dM profiled out); and cc.cc_pantheon in w0wacdm, the one preset
# x model of the port no earlier run had taken to the card (ROADMAP 10c)
TOOLS_FIT = ("bao.desi_cmb_des5y", "lcdm")
EVIDENCE_ARGV = ("--replicates", "2", "--base-warmup", "6", "--base-samples", "6",
                 "--max-doublings", "1", "--golden-mult", "2")
SWEEP_CHAINS, SWEEP_WARMUP, SWEEP_SAMPLES = 128, 30, 8
PRECHECK_ROWS = ("bao.desi[lcdm]", "cc.cc[lcdm]", "bao.desi_union3_omh2[lcdm]")
NEVER_RAN = ("cc.cc_pantheon", "w0wacdm")


def phase_tools(card):
    """Phase 20: (a) ``tools/torch_evidence_convergence.py`` on the fast
    flagship in lcdm at EVIDENCE_ARGV's budget: each stage's ln Z and error,
    the worst rung's split R-hat, seconds and fused launches (a non-finite
    ln Z, or a stage with no fused launch, fails); (b)
    ``tools/torch_warmup_sweep.py``, one seed on the same fit: rejuvenated,
    retries, divergent, gradient evaluations a second, and at least one
    fused launch a gradient evaluation; (c) ``tools/torch_precheck_rows.py``
    on PRECHECK_ROWS (f64 on the host): a non-finite chi^2 or a row beyond
    the tool's FLAG fails; (d) NEVER_RAN fast at FAMILY_WALKERS (bench and
    uniform draws, seeded bad rows): the kernel against its plain version
    within FUSED_RTOL of max|logp|, whole and each term alone, and the f32
    card against the f64 CPU fast path within LOGP_RTOL."""
    import numpy as np
    import torch

    from cosmax_torch.configs import get_preset
    from cosmax_torch.ops.kernels import fused_log_prob as fl

    out, t_phase = {}, time.perf_counter()
    preset, model = TOOLS_FIT

    # (a) the evidence ladder's three stages
    tool = _tool("torch_evidence_convergence")
    records = tool.run(["--preset", preset, "--model", model, *EVIDENCE_ARGV])
    stages, summary = records[:3], records[3]
    for r in stages:
        print(f"phase 20: evidence {r['stage']} on {card}: ln Z {r['log_evidence']:.4f} +- "
              f"{r['error']:.4f}, max rung R-hat {r['max_rung_rhat']:.4f}, acceptance "
              f"{r['acceptance']:.3f}, {r['wall_s']:.1f}s, {r['fused_launches']} fused launches")
        if not np.isfinite(r["log_evidence"]) or r["fused_launches"] == 0:
            raise AssertionError(f"phase 20: evidence stage {r['stage']}: ln Z "
                                 f"{r['log_evidence']}, {r['fused_launches']} fused launches")
    print(f"phase 20: evidence summary ({' '.join(EVIDENCE_ARGV)}): {json.dumps(summary)}")
    out["evidence"] = dict(stages=stages, summary=summary)

    # (b) one seed of the warmup sweep
    tool = _tool("torch_warmup_sweep")
    before = fl.LAUNCHES
    sweep = tool.sweep(preset, model, 1, SWEEP_CHAINS, SWEEP_WARMUP, SWEEP_SAMPLES,
                       device="cuda")
    launches = fl.LAUNCHES - before
    (seed,) = sweep.pop("per_seed")
    print(f"phase 20: warmup sweep {preset}/{model} on {card}: {SWEEP_CHAINS} chains, warmup "
          f"{SWEEP_WARMUP}: rejuvenated {seed['rejuvenated']}, retries {seed['retries']}, "
          f"divergent {seed['divergent']}, {seed['gradient_evals']} gradient evaluations in "
          f"{seed['seconds']:.1f}s ({sweep['gradient_evals_per_s']:.1f}/s), {launches} fused "
          f"launches over the sweep (its MAP start too)")
    if launches < seed["gradient_evals"] or seed["gradient_evals"] == 0:
        raise AssertionError(f"phase 20: the warmup sweep launched the fused kernel {launches} "
                             f"times for {seed['gradient_evals']} gradient evaluations")
    out["warmup_sweep"] = dict(sweep, **seed, launches=launches)

    # (c) the row precheck on the host
    tool = _tool("torch_precheck_rows")
    rows = {}
    for label in PRECHECK_ROWS:
        (row,) = [r for r in tool.precheck(only=label) if r["label"] == label]
        if row["flagged"] or not np.isfinite(row.get("chi2", np.nan)):
            raise AssertionError(f"phase 20: precheck {label}: {row}")
        rows[label] = row
    print(f"phase 20: precheck (f64 on the host) chi2 at the published medians against the "
          f"published chi2 (flag at |d| >= {tool.FLAG}): "
          + "; ".join(f"{k} {r['chi2']:.4f} vs {r['chi2_pub']} (d {r['delta']:+.4f}"
                      + (f", profiled {r['profiled']})" if r["profiled"] else ")")
                      for k, r in rows.items()))
    out["precheck"] = rows

    # (d) the preset x model never run on the card
    name, model = NEVER_RAN
    t0 = time.perf_counter()
    fit = get_preset(name, model, fast=True, synthetic_sys=True, device="cuda")
    packed = _pack(fl, fit)
    build_s = time.perf_counter() - t0
    names = [t.name for t in fit.terms if fl._emulated(t) is not None]
    checks, worst = [], dict(fused=0.0, alone=0.0)
    for dlabel, walkers in (("bench", _flagship_walkers(fit, FAMILY_WALKERS, seed=60)),
                            ("uniform", _box_walkers(fit, FAMILY_WALKERS, seed=61))):
        walkers = _bad_rows(fit, walkers)
        rel = _check_fused(fl, packed, walkers, f"phase 20 {name}/{model} {dlabel}")
        alone, w = _each_term(fl, packed, torch.as_tensor(walkers, device="cuda"), names,
                              f"phase 20 {name}/{model} {dlabel}")
        worst["fused"], worst["alone"] = max(worst["fused"], rel), max(worst["alone"], w)
        checks.append(f"{dlabel} {rel:.3e}, each term alone: {', '.join(alone)}")
    gap = _gap_to_f64(fit, seed=62)
    if not gap <= LOGP_RTOL:
        raise AssertionError(f"phase 20 {name}/{model}: f32 card vs f64 CPU fast {gap:.3e}")
    print(f"phase 20: {name}/{model} fast, built and packed in {build_s:.2f}s; fused kernel vs "
          f"plain at W={FAMILY_WALKERS} (of max|logp|): {'; '.join(checks)}; f32 card vs f64 CPU "
          f"fast path on 64 walkers (half 1's among them) {gap:.3e}")
    out["never_ran"] = dict(preset=f"{name}/{model}", build_s=build_s, f32_vs_f64=gap, **worst)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20: {out['seconds']:.1f}s on {card}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    card = _card()
    print(card)
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from cosmax_torch.device import disable_tf32
    from cosmax_torch.ops.kernels.build import load_kernels

    disable_tf32()
    t_start = time.perf_counter()
    jobs = _start_variants()
    try:
        built = load_kernels(["whitened_chi2", "fused_log_prob", "whitened_chi2_rows"])
    except BaseException:
        _stop(jobs)
        raise
    variants = _finish_variants(jobs)
    print(f"phase 2: built the three kernel sources and {len(variants)} variants in "
          f"{time.perf_counter() - t_start:.2f}s (in parallel)")
    for src, b in zip((SOURCE, FUSED_SOURCE, ROWS_SOURCE), built):
        ptxas = [ln.strip() for ln in b.log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"phase 2: {src} in {b.seconds:.2f}s; {'; '.join(ptxas)}")
    ptxas_split = _ptxas_of(built[1].log, "split_kernel") or "ptxas report not found"
    ptxas_tucker = _ptxas_of(built[1].log, "fused_log_prob_kernel") or "ptxas report not found"
    ptxas_f64 = _ptxas_of(built[1].log, "split_f64_kernel") or "ptxas report not found"
    ptxas_chi2 = _ptxas_of(built[0].log, "whitened_chi2_kernel") or "ptxas report not found"
    ptxas_rows = _ptxas_of(built[2].log, "whitened_chi2_rows_kernel") or "ptxas report not found"
    # ptxas's notes on the wgmma pipeline (a serialized wgmma is one it
    # could not prove safe to overlap)
    rows_notes = [ln.strip() for ln in built[2].log.splitlines() if "wgmma" in ln.lower()]
    print(f"phase 2: ptxas: whitened_chi2_rows_kernel {ptxas_rows}; its wgmma notes: "
          f"{rows_notes or 'none'}")
    print(f"phase 2: ptxas: whitened_chi2_kernel {ptxas_chi2}; fused_log_prob_kernel "
          f"{ptxas_tucker}; fused_log_prob_split_kernel {ptxas_split}; "
          f"fused_log_prob_split_f64_kernel {ptxas_f64}")

    stamps = {}

    def stamp(phase):
        """Seconds since the last stamp (from phase 2's start), by phase."""
        stamps[phase] = time.perf_counter() - t_start - sum(stamps.values())

    stamp("2")
    timing = phase_kernel(card, variants)
    stamp("3")
    phase_anchor()
    stamp("4")
    parity_ref = phase_flagship(card)
    stamp("5")
    launches = phase_cli(card, "phase 6")
    stamp("6")
    fused = phase_fast(card, parity_ref, ptxas_tucker, variants)
    stamp("7")
    fused_launches = phase_cli(card, "phase 8", fast=True)
    stamp("8")
    mp_ref, mp_fused = phase_multiprobe_fast(card, variants)
    stamp("9")
    mp_parity_launches = phase_multiprobe_parity(card, mp_ref)
    stamp("10")
    mp_cli_launches = phase_cli(card, "phase 11", "joint.multiprobe", 256, 11, fast=True)
    stamp("11")
    w0wa = phase_w0wa_fast(card, ptxas_split, variants)
    w0wa_cli_launches = phase_cli(card, "phase 12", walkers=150, dim=7, fast=True,
                                  model="w0wacdm", synthetic_sys=True)
    stamp("12")
    w0wa_mp, cc_cc = phase_w0wa_multiprobe(card, ptxas_split, variants)
    w0wa_mp_cli_launches = phase_cli(card, "phase 13", "joint.multiprobe", 256, 12, fast=True,
                                     model="w0wacdm", synthetic_sys=True)
    stamp("13")
    family = phase_bao_family(card, variants)
    family["cli_launches"] = phase_cli(card, "phase 14", "bao.desi_bbn", 150, 4, fast=True)
    stamp("14")
    sn_family = phase_sn_family(card, variants)
    sn_family["cli_launches"] = phase_cli(card, "phase 15", "sn.pantheon_shoes", 500, 4,
                                          fast=True, synthetic_sys=True)
    sn_parity_cli_launches = phase_cli(card, "phase 15", "cc.cc_pantheon", 150, 5,
                                       synthetic_sys=True)
    stamp("15")
    qsr_family = phase_qsr_family(card, variants)
    qsr_family["cli_launches"] = phase_cli(card, "phase 16", "qsr.des5y", 150, 5, fast=True)
    stamp("16")
    grad = phase_grad(card)
    stamp("17")
    rows = phase_rows(card, variants, ptxas_rows)
    dry = phase_dryrun(card)
    stamp("18")
    outer = phase_outer(card)
    stamp("19")
    tools = phase_tools(card)
    stamp("20")
    # the row-block kernel's line: d = 4's slowest block, which sets the
    # sharded chi^2's time
    rows_slowest = max(rows["parts"][str(max(ROWS_PARTS))]["blocks"], key=lambda b: b["ms"])
    print(f"phases 2-20 took {time.perf_counter() - t_start:.1f}s on {card}; by phase: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in stamps.items()))

    print(json.dumps({"kernels": [
        {"name": "whitened_chi2", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches, **timing, "ptxas": ptxas_chi2,
         "multiprobe_parity_launches": mp_parity_launches,
         "sn_family": dict(sn_family["chi2"], parity_launches=sn_family["parity_launches"],
                           cli_launches=sn_parity_cli_launches),
         "autograd_function": grad["chi2_function"],
         "hmc_parity": {k: v for k, v in grad["hmc"].items() if "parity" in k},
         "dryrun": {"nccl_world_1_launches": dry["nccl_world_1"]["launches"]["whitened_chi2"],
                    "gloo_world_2_launches": [r["whitened_chi2"]
                                              for r in dry["gloo_world_2"]["launches"]],
                    "parity_vs_world_1": dry["against_world_1"]["parity flagship"]},
         "compat_launches": outer["compat"]["chi2_launches"],
         "fit_out_launches": {k: v["launches"] for k, v in outer["fit_out"].items()
                              if "pantheon" in k},
         "profile_terms_launches": outer["profile_terms"]["parity"]["launches"]["whitened_chi2"]},
        {"name": "whitened_chi2_rows", "route": "cuda", "source": ROWS_SOURCE,
         "replaces": REPLACES,
         "launches": sum(dry["gloo_world_2"]["row_block_launches"]),
         **{k: rows_slowest[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "rows")},
         "phase_18": rows,
         "gloo_world_2_launches": dry["gloo_world_2"]["row_block_launches"]},
        {"name": "fused_log_prob", "route": "cuda", "source": FUSED_SOURCE,
         "replaces": FUSED_REPLACES, "launches": fused_launches, **fused,
         "multiprobe": dict(mp_fused, walkers=MP_WALKERS, cli_launches=mp_cli_launches),
         "w0wacdm": dict(w0wa, cli_launches=w0wa_cli_launches),
         "w0wacdm_multiprobe": dict(w0wa_mp, cli_launches=w0wa_mp_cli_launches),
         "cc_cc": cc_cc,
         "branches_1e": [label for label, _, _ in BRANCHES], "bao_family": family,
         "sn_family": {k: v for k, v in sn_family.items()
                       if k not in ("chi2", "parity_launches")},
         "qsr_family": qsr_family, "sweep_f64": sorted(SWEEP_F64), "ptxas_f64": ptxas_f64,
         "gradients": {k: v for k, v in grad.items() if k != "chi2_function"},
         "dryrun": dict(dry, nccl_world_1_launches=dry["nccl_world_1"]["launches"][
             "fused_log_prob"], gloo_world_2_launches=[
             r["fused_log_prob"] for r in dry["gloo_world_2"]["launches"]]),
         "compat_launches": outer["compat"]["launches"],
         "fit_out_launches": outer["fit_out"]["fast flagship"]["launches"],
         "profile_terms_launches": outer["profile_terms"]["fast"]["launches"]["fused_log_prob"],
         "outer_layers": {k: outer[k] for k in ("gp", "field", "compat", "profile_terms",
                                                "debugging")},
         "tools": tools},
    ]}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
