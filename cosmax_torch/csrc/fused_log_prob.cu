// Fused fast log-prob for Hopper (sm_90a): logp[W] for walkers theta[W, D]
// of a fast preset (get_preset(..., fast=True)), the whole joint in one
// launch.
//
// Replaces the TPU kernel cosmax/ops/pallas/megakernel.py::blocked_log_prob,
// which replays the traced log-prob of a walker block inside one
// pallas_call with every constant resident in VMEM. This kernel is not a
// replayer: it is the bundled fast log-prob written out by hand. Per walker:
//   1. H0 and Or from theta (Or = orh2 / h^2, or 0 without radiation; a
//      fit may sample no H0 at all, then nothing reads it, or fix it for
//      every walker: the H0-free bao.desi_des5y's H0 = 1), w0 (or log of the
//      sampled exp(w0)), and the walker's r_d: fixed, sampled (times a
//      scale), r_d h / h, a drag-epoch fitting formula of (wb, wm), or
//      r_s(z_drag) by GL-128 in a with this model's E(z);
//   2. barycentric weights on each Chebyshev axis (a one-hot within 1e-14
//      of a node), folded straight into the Tucker factor projections
//      wp_i = U_i^T w_i in one pass over the nodes (the sum of the
//      unnormalised weights divided out once at the end), so the node
//      weights are never stored. On the split w0wacdm grid (#1b) the
//      walker takes half 0 if s = w0 + wa <= 0, else half 1 (the
//      reference's jnp.where, cosmax/models/linear_chi2.py:575-587), and
//      only that half is computed for it: the tensor-train sweep v <- w_0^T
//      G_0, then v'[r] = sum_n sum_p w[n] v[p] G[n, p, r] for the two later
//      cores (block products on the tensor cores, see below); the
//      coefficient vector is then a = v^T tail;
//   3. the emulated terms, one form at a time. Each form owns a window of
//      the core's columns, whole quads in an order the packer chose; the
//      window is contracted a[q] = sum_jk wp1[j] wp2[k] core[j, k, q] (on
//      the native grid by the warp's block product, at most NCOLT columns
//      a pass; on the split grid QC quads at a time from the tail) and each
//      quad reduced at once, so never the whole a[R_all] is held:
//      * linear (BAO, SN, CC): quads of two (base, Or-delta) pairs,
//        e = beta s (a + Or/OR_REF a_d) - ba_ref, chi2 = c_ref - 2 e.v_ref
//        + e.e, plus g.S g - 2 g.q_ref + 2 e.P g where the form has
//        nuisance columns (cosmax/models/linear_chi2.py:547-567); beta is
//        1, c / (H0 r_d) with the walker's r_d, or H0;
//      * lift (quasars): dmu[K] += a_i (scale B_t)[i, :] pair by pair,
//        then d = (mu - mu_ref) - dmu - dM, chi2 = sum d^2 / (sigma^2 +
//        s^2), log_norm = -1/2 sum ln(sigma^2 + s^2); the K values (at
//        most MAX_LIFT, qsr.des5y's 50) in chunks of MAX_K held in
//        registers, the window walked again for each chunk;
//      * amp_pair (fs8): quads (u, du, v, dv) of one rank index, r = scale
//        ((u + t du) - amp (v + t dv)), chi2 = |r|^2
//        (cosmax/models/linear_chi2.py:679-689);
//      then a form's rescaling f: chi2 * f^-2 or f^2, log_norm += const +
//      coef ln f;
//   4. the compressed CMB: z* (Aizpuru A4, or Hu & Sugiyama), r_s by GL in
//      a and D_C by GL in ln a with the radiation-aware E(z), the three
//      observables and the 3 x 3 whitened chi^2; or from the same r_s and
//      D_C the 100 theta* prior ((theta_100 - 100 r_s / D_C) / sigma)^2; and
//      one scalar prior ((mean - x) / sigma)^2 from header slots, x = Om
//      (H0/100)^2 or a sampled parameter (the BBN omega_b);
//   5. -chi2/2 + log_norm, or -inf outside the strict interior of the f32
//      bounds or where the sum is not finite.
// A fit with no emulated term (cmb.cmb: the CMB block alone, lcdm) has no
// grid and no forms, and skips steps 2 and 3.
// The constants come packed by cosmax_torch/ops/kernels/fused_log_prob.py
// (pack): a header of sizes and offsets (the H_* slots below, the same in
// both files), 14 KB for the flagship, 45 KB for the multiprobe joint in
// wzcdm and 80 KB in wcdm. The split grid's TT cores and tails (620 KB for
// the w0wacdm flagship, more than a block's shared memory) stay in a
// second buffer in device memory, each core a matrix [n r_in][r] read
// slice by slice.
//
// What bounds it on the card: per walker about 8.9k operations for the
// flagship and 24.8k for the multiprobe joint (wzcdm; 4.9k and 19.7k of
// them the core contraction's products), about 198k (half 0) or 107k (half
// 1) for the w0wacdm flagship, 184k (half 0) of them in the TT sweep's two
// products with r_in > 1, against 28-48 bytes of HBM traffic (theta in,
// logp out). It is bound by operations (the tensor cores' TF32 rate for
// the products; FFMA issue, the loads that feed it and the accurate
// transcendental sequences for the rest), never by memory. With the
// contraction as FFMA, one thread per walker, the flagship's walker took
// ~21k instructions: ~8.3k the CMB's 72 nodes, ~7.8k the projections' two
// passes of IEEE divisions, ~3.9k the contraction (PERF.md).
//
// What the design does about it:
// * One thread per walker, 128 threads a block (256 in the Tucker
//   instance); the block first copies the constant buffer into shared
//   memory.
// * The Tucker instance (fused_log_prob_kernel) contracts on the tensor
//   cores, per warp: its 32 walkers' projections go to the warp's slices
//   of shared memory, the outer factor w1 [KO][WLD] and the inner one w2
//   [KI][WLD] (the axis the packer chose, its rank padded to k-steps of 8:
//   at most 16; the outer one, read row by row, up to MAX_RANK_OUTER),
//   and each column pass of a form's window is C[32, 8 NT] = sum_j w1[j]
//   D_j with D_j = W2[32, KI] B_j[KI, 8 NT], B_j the rows j KI.. of the
//   core stored as the matrix [KO KI][H_LDB] (its row stride 8 or 24 mod
//   32: the fragments fall on 32 banks). Each D_j is a product on the
//   tensor cores, mma.sync m16n8k8 in 3xTF32 as the split grid's sweep,
//   from zero over its one or two k-steps, with A = W2 split once a pass;
//   w1[j] scales its rows into C's registers by FFMA (rounded f32, so the
//   tensor cores' truncating adds never run long). That forms no
//   Kronecker product A[b, (j, p)] = w1[j] w2[p]: its products and splits
//   took half a k-step's instructions (PERF.md). C lands in the warp's
//   buffer [column][CLD], from which each walker reduces the quads of its
//   own row. Only warp barriers are needed, so a thread past
//   the last walker takes part on a copy of it, and the warps of a block
//   run unsynchronised. The CMB's integrands are written in a, one square
//   root and one IEEE division a node (q_of_a).
// * Register pressure stays flat in R_all: a window is contracted one
//   column pass (at most NCOLT columns) at a time and each quad is
//   consumed at once, so the live state is the pass and the form's sums
//   (dmu[MAX_K] for a lift; a longer lift walks its window again for each
//   further chunk of MAX_K values). On the split grid the tail is contracted QC
//   quads at a time (acc[QC], float4) from per-thread slices of the sweep
//   vectors.
// * The TT sweep (the split instance, its own kernel
//   fused_log_prob_split_kernel) runs per block, not per thread. The block
//   first groups its walkers by half (ballots): half 0's take rows [0, c0)
//   of the block's sweep arrays, half 1's rows [THREADS - c1, THREADS).
//   The first step (r_in = 1), each step's barycentric weights, the tail
//   and the forms run per walker in its own half, once for both halves;
//   each later step is one block product per half, C[rows, r] =
//   A[rows, n r_in] G[n r_in, r], over the half's rows padded to m-tiles
//   of 16 (at most 15 padding rows a half, which lie on the other half's
//   rows: read, never written), where a warp that straddled s = 0 ran
//   both sweeps before. A[b, (m, p)] = w_m(b) v_b[p] is formed fragment
//   by fragment from the weights [n][VLD] and the sweep vector [r_in][VLD]
//   in shared memory, never stored. The products run on the tensor cores
//   (mma.sync m16n8k8 TF32, f32 accumulation) in 3xTF32: each operand x =
//   hi + lo with hi = tf32(x), lo = tf32(x - hi) (rounded to nearest,
//   ties away, as cvt.rna.tf32.f32), and the sum of a_hi b_hi + a_hi b_lo
//   + a_lo b_hi keeps f32 accuracy (one pass of TF32 keeps ~3 digits, too
//   few for the reference-centred forms). G streams through a ring of
//   STAGES shared-memory slices of KSLICE rows by cp.async, so each slice
//   is read from L2 once per block of THREADS walkers, not once per warp;
//   B's hi/lo split is done at fragment load. A warp owns m-tiles warp and
//   warp + 4 and all n-tiles of a column pass (NCOL columns; a half of one
//   or two m-tiles is spread over all warps by n-tiles), so its
//   accumulators stay in registers for the whole K loop; the tile counts
//   are compile-time in the slice's code (an instance per count), so the
//   slice is straight-line code whose tiles' mma interleave. The tensor
//   cores' f32 adds truncate: each slice sums from zero and is added to
//   the accumulators with rounding FADDs. A product of one column pass
//   writes its output over its input,
//   which keeps the flagship's block at 76 KB of shared memory and 168
//   registers: three blocks an SM.
// * The f64 sweep (a third kernel, fused_log_prob_split_f64_kernel, chosen
//   by the packer's H_SWEEP_F64 through the launch's instance): where a
//   bundle's group scale exceeds its values at a half's reference centre
//   more than 1e3 times (qsr.desi and qsr.des5y_desi in w0wacdm, whose
//   boxes reach Om = 0: the BAO table's scale is ~9e4 there against ~15 in
//   wzcdm), the tensor train carries the group's columns as cancellations
//   of corner-sized terms, and a float32 sweep, 3xTF32 or not, loses more
//   than 1e-4 of max|logp|. That instance keeps the cores float32 in device
//   memory and runs everything from the weights to the tail in f64: the
//   barycentric weights, the first step, each later step's block product
//   on the f64 tensor cores (mma.sync m8n8k4, IEEE double: no per-slice
//   flush), A = w_m v_b[p] formed in f64, B widened at fragment load, the
//   sweep vectors kept in f64 between steps, and a = v^T tail; each quad of
//   a is then rounded to f32 for the forms, as the plain version casts its
//   f64 sweep. Its m-tiles of 16 rows are two tiles of 8 whose C takes the
//   TF32 fragment's places, so the half's rows, warps and padding rows are
//   block_step's. The rows of doubles take twice the shared memory: one
//   block an SM, and the f64 tensor cores' peak is a seventh of TF32's;
//   the two bundles pay that for their accuracy (times in PERF.md).
// * Accurate libm functions and IEEE division and square root (no
//   --use_fast_math): the CMB term divides theta* by its sigma ~ 2.6e-6,
//   and the quasar term takes 22 logf a walker.
// * The ragged last block is masked: a thread past the end computes a copy
//   of the last walker and writes nothing. Each thread reads and writes
//   only its own walker, so a NaN walker stays in its row (a product's rows
//   are independent, and a walker reads only its own row of C).
// Maxima such as MAX_RANK are compile-time; the packer refuses larger fits.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32.cuh"  // tf32_rna, split_tf32, mma_tf32

namespace {

constexpr int MAX_DIM = 16;
constexpr int MAX_NODES = 64;
constexpr int MAX_RANK = 16;  // Tucker rank of the inner axis, and of any axis but the outer
constexpr int MAX_RANK_OUTER = 24;  // Tucker rank of the outer axis
constexpr int MAX_BOND = 128;
constexpr int MAX_RALL = 256;
constexpr int MAX_FORMS = 8;
constexpr int MAX_K = 32;  // values of a lift form in registers at once (a chunk)
constexpr int MAX_LIFT = 64;  // values of a lift form, in chunks of MAX_K
constexpr int MAX_GL = 64;
constexpr int MAX_GL_RD = 128;  // nodes of r_s(z_drag) (the packer refuses more)
constexpr int MAX_FLOATS = 40960;
constexpr int THREADS = 128;
// quads contracted together (acc[QC] in registers): 5 takes the 5-quad
// windows of the rank-9/10 linear forms in one chunk; the fastest of 3-8
// on the flagship and the multiprobe joint (fused_ab.py, PERF.md)
constexpr int QC = 5;
// output-rank quads of the first TT step accumulated together (acc[RC])
constexpr int RC = 8;
// the split grid's block products: A's rows (the block's walkers) at a
// stride of VLD floats, G staged in slices of KSLICE rows of one column
// pass (at most NCOL columns) at a stride of SLD floats, in a ring of
// STAGES slices. VLD and SLD are 8 mod 32, so that the fragments' shared
// loads (lanes 4 g + t at row t, column g) fall on 32 banks.
constexpr int VLD = 136;
constexpr int KSLICE = 32;
constexpr int NCOL = 56;
constexpr int SLD = 72;
constexpr int STAGES = 2;
// k-steps of 8 unrolled together in a slice: the slice's code is an
// instance per tile count, so its size counts against the instruction cache
constexpr int KUNROLL = 2;
constexpr int MIN_RIN = 8;  // a block product's r_in (the packer pads smaller bonds)
// zero rows after the n rows of weights: the nodes m >= n of G's padding
// rows (up to KSLICE - 1 of them) read weight 0, without a test
constexpr int WPAD = 4;
constexpr int WARPS = THREADS / 32;
constexpr int MT_WARP = THREADS / 16 / WARPS;  // m-tiles of 16 rows a warp
// blocks of the split instance an SM should hold (registers capped to fit;
// the flagship's shared memory, 76 KB a block, fits three)
constexpr int SPLIT_BLOCKS = 3;
// the split instance's f64 sweep (H_SWEEP_F64): the sweep's weights and
// vectors in doubles at a stride of VLD_F64 (4 mod 16, so that a
// half-warp's 8-byte loads of A, lanes 4 g + t at row t, column g, fall on
// 32 banks), one block an SM (its rows take twice the shared memory)
constexpr int VLD_F64 = 132;
constexpr int SPLIT_F64_BLOCKS = 1;
// timing probes of the Tucker instance, built only by `fused_ab.py --variant
// PROBE=n` (0 is the kernel): bit 1 leaves out the CMB, bit 2 the core
// contraction (each quad of a window takes wp1[0] wp2[0]), bit 4 the
// weights' projection (each wp[j] takes the coordinate); what is left out
// is the part's time. A probe computes another function, so fused_ab.py
// does not hold it against the plain version.
constexpr int PROBE = 0;
// the Tucker instance's contraction, block products per warp over its 32
// walkers: the projections at a stride of WLD floats a row, C [column][CLD],
// column passes of at most NCOLT columns (wider passes took more registers
// and time, PERF.md). WLD is 8 mod 32 and 2 CLD 8 mod 32, so that A's
// fragments and C's stores (lanes 4 g + t at row g, column t or 2 t) fall
// on 32 banks.
constexpr int WLD = 40;
constexpr int CLD = 36;
constexpr int NCOLT = 24;
// the Tucker instance's warps a block (8 share one copy of the constants:
// the multiprobe's 73 KB leave room for 3 blocks of 4 warps, 2 of 8), and
// the warps an SM should hold (its registers capped to 128 to fit)
constexpr int TUCKER_WARPS = 8;
constexpr int TUCKER_SM_WARPS = 16;
constexpr int TUCKER_THREADS = 32 * TUCKER_WARPS;
static_assert(VLD >= THREADS && VLD % 32 == 8 && SLD >= NCOL && SLD % 32 == 8, "bank layout");
static_assert(VLD_F64 >= THREADS && VLD_F64 % 16 == 4, "bank layout of the f64 sweep");
static_assert(WLD >= 32 && WLD % 32 == 8 && CLD >= 32 && CLD % 16 == 4 && NCOLT % 8 == 0,
              "bank layout of the Tucker contraction");
static_assert(MAX_RANK == 16, "inner ranks pad to 8 or 16: one or two k-steps");
static_assert(MAX_RANK_OUTER % 8 == 0 && MAX_RANK_OUTER <= 24, "factor rows of 8, 16 or 24");
static_assert(KSLICE % 8 == 0 && NCOL % 8 == 0 && STAGES >= 2, "tile shapes");
static_assert(MIN_RIN >= 8, "a k-step of 8 columns wraps r_in at most once");
static_assert(WPAD * MIN_RIN >= KSLICE, "G's padding rows lie on the zero rows of weights");

// header slots (cosmax_torch/ops/kernels/fused_log_prob.py: HEADER)
constexpr int H_MAGIC = 0;
constexpr int H_SIZE = 1;
constexpr int H_DIM = 2;
constexpr int H_MODEL = 3;
constexpr int H_I_OM = 4;
constexpr int H_I_W0 = 5;
constexpr int H_I_H0 = 6;
constexpr int H_H0_SCALE = 7;
constexpr int H_ORH2 = 8;
constexpr int H_NAXES = 9;
constexpr int H_N1 = 10;
constexpr int H_N2 = 11;
constexpr int H_R1 = 12;
constexpr int H_R2 = 13;
constexpr int H_NQ = 14;
constexpr int H_RALL = 15;
constexpr int H_NFORMS = 16;
constexpr int H_HAS_CMB = 17;
constexpr int H_OFF_BOUNDS = 18;
constexpr int H_OFF_AX1 = 19;
constexpr int H_OFF_AX2 = 20;
constexpr int H_OFF_BW1 = 21;
constexpr int H_OFF_BW2 = 22;
constexpr int H_OFF_U1 = 23;
constexpr int H_OFF_U2 = 24;
constexpr int H_OFF_CORE = 25;
constexpr int H_OFF_FORMS = 26;
constexpr int H_OFF_CMB = 27;
constexpr int H_I_WA = 28;
constexpr int H_SPLIT = 29;
constexpr int H_OFF_HALVES = 30;
constexpr int H_VROWS = 31;
constexpr int H_KO = 32;
constexpr int H_KI = 33;
constexpr int H_LDB = 34;
constexpr int H_INNER = 35;
constexpr int H_PRIOR = 36;
constexpr int H_PRIOR_MEAN = 37;
constexpr int H_PRIOR_SIGMA = 38;
constexpr int H_H0_CONST = 39;
constexpr int H_W0_LOG = 40;
constexpr int H_RD_KIND = 41;
constexpr int H_RD = 42;
constexpr int H_I_RD = 43;
constexpr int H_RD_N = 44;
constexpr int H_OFF_RD = 45;
constexpr int H_I_PRIOR = 46;
constexpr int H_SWEEP_F64 = 47;  // 1: the split grid's sweep in f64 (the launch's instance)

// one half of the split grid (HALF)
// (per core i = 0, 1, 2 the slots T_PERM0 + i, T_AX0 + i, T_N0 + i,
// T_G0 + i; its output bond T_R1 + i)
constexpr int HALF_STRIDE = 24;
constexpr int T_PERM0 = 0;
constexpr int T_PERM1 = 1;
constexpr int T_PERM2 = 2;
constexpr int T_AX0 = 3;
constexpr int T_AX1 = 4;
constexpr int T_AX2 = 5;
constexpr int T_N0 = 6;
constexpr int T_N1 = 7;
constexpr int T_N2 = 8;
constexpr int T_R1 = 9;
constexpr int T_R2 = 10;
constexpr int T_R3 = 11;
constexpr int T_G0 = 12;
constexpr int T_G1 = 13;
constexpr int T_G2 = 14;
constexpr int T_TAIL = 15;
constexpr int T_NQ = 16;
constexpr int T_RALL = 17;
constexpr int T_OFF_FORMS = 18;
constexpr int T_ONE = 19;

// one (base, delta) pair row of a linear form (PAIR)
constexpr int PAIR_STRIDE = 4;
constexpr int P_BA = 0;
constexpr int P_V = 1;
constexpr int P_P0 = 2;
constexpr int P_P1 = 3;

// one emulated term (FORM)
constexpr int FORM_STRIDE = 32;
constexpr int F_KIND = 0;
constexpr int F_Q0 = 1;
constexpr int F_NQ = 2;
constexpr int F_ROWS = 3;
constexpr int F_SCALE = 4;
constexpr int F_CREF = 5;
constexpr int F_BETA = 6;
constexpr int F_J = 7;
constexpr int F_MAG_IDX = 8;
constexpr int F_OFFSET = 9;
constexpr int F_H0REF = 10;
constexpr int F_GREF0 = 11;
constexpr int F_GREF1 = 12;
constexpr int F_QREF0 = 13;
constexpr int F_QREF1 = 14;
constexpr int F_S00 = 15;
constexpr int F_S01 = 16;
constexpr int F_S10 = 17;
constexpr int F_S11 = 18;
constexpr int F_F_IDX = 19;
constexpr int F_POW = 20;
constexpr int F_LN_CONST = 21;
constexpr int F_LN_COEF = 22;
constexpr int F_K = 23;
constexpr int F_I_AMP = 24;
constexpr int F_I_OFF = 25;
constexpr int F_I_S = 26;

// form kinds (KINDS) and betas
constexpr int KIND_LINEAR = 0;
constexpr int KIND_LIFT = 1;
constexpr int BETA_BAO = 1;
constexpr int BETA_H0 = 2;

// the CMB block (CMB)
constexpr int C_PRIOR = 0;
constexpr int C_L = 3;
constexpr int C_OG4 = 12;
constexpr int C_OBS = 13;
constexpr int C_ZSTAR = 14;
constexpr int C_I_OBH2 = 15;
constexpr int C_NRS = 16;
constexpr int C_NDC = 17;
constexpr int C_SIGMA = 18;
constexpr int C_NODES = 20;
constexpr int OBS_THETA_100 = 3;  // the 100 theta* prior (OBSERVABLES)

// the walker's r_d (RD_KINDS) and the scalar prior (PRIORS)
constexpr int RD_FIXED = 1;
constexpr int RD_PARAM = 2;
constexpr int RD_OVER_H = 3;
constexpr int RD_AIZPURU = 4;
constexpr int RD_DESI = 5;
constexpr int PRIOR_OMH2 = 1;

constexpr float C_KM_S = 299792.458f;
constexpr float OR_REF = 2e-4f;
constexpr float PI = 3.14159265358979f;
constexpr float LN2 = 0.693147180559945f;

// E(z) of w0wacdm (CPL) with radiation; o_r = 0 gives the radiation-free E
// exactly
__device__ __forceinline__ float e_cpl(float z, float om, float o_r, float w0, float wa) {
  const float opz = 1.0f + z;
  const float cubed = opz * opz * opz;
  // up to ~1e27 at z* for s = w0 + wa near 2, inside f32
  const float rho = expf(3.0f * (1.0f + w0 + wa) * logf(opz) - 3.0f * wa * z / opz);
  const float ode = 1.0f - om - o_r;
  return sqrtf(o_r * cubed * opz + om * cubed + ode * rho);
}

// q = a^4 E(a)^2 = o_r + a (om + a^3 ode rho(a)) for the flat lcdm (MODEL
// 0), wcdm (1) and wzcdm (2) families, with ln_a = ln a (read by wcdm
// only): the r_s integrand c / (a^2 E sqrt(3 (1 + Rb a))) is then
// c / sqrt(q 3 (1 + Rb a)), and the D_C integrand c / (a E) is c a / sqrt(q),
// one square root and one division a node and no 1 / a; wzcdm's
// ln(2 (1 + z)^3 / (1 + (1 + z)^3)) is ln 2 - ln(1 + a^3), without a division
template <int MODEL>
__device__ __forceinline__ float q_of_a(float a, float ln_a, float om, float o_r, float w0) {
  const float a3 = a * a * a;
  float rho = 1.0f;
  if constexpr (MODEL == 1) {
    rho = expf(-3.0f * (1.0f + w0) * ln_a);
  } else if constexpr (MODEL == 2) {
    rho = expf(2.0f * (1.0f + w0) * (LN2 - logf(1.0f + a3)));
  }
  return fmaf(a, fmaf(a3, (1.0f - om - o_r) * rho, om), o_r);
}

// r_s(z) h0 by GL in a (nodes t, weights w on [0, 1], a = a_end t), the
// integrand c / sqrt(q 3 (1 + Rb a)) of the native grid's families; the CMB's
// r_s(z*) and the BAO's r_s(z_drag) share it
template <int MODEL>
__device__ __forceinline__ float rs_sum(const float* t, const float* w, int n, float a_end,
                                        float rb, float om, float o_r, float w0) {
  float rs = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float a = a_end * t[i];
    const float q = q_of_a<MODEL>(a, MODEL == 1 ? logf(a) : 0.0f, om, o_r, w0);
    rs += C_KM_S / sqrtf(q * (3.0f * fmaf(rb, a, 1.0f))) * (a_end * w[i]);
  }
  return rs;
}

// rs_sum for CPL (the split grid)
__device__ __forceinline__ float rs_sum_cpl(const float* t, const float* w, int n, float a_end,
                                            float rb, float om, float o_r, float w0, float wa) {
  float rs = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float a = a_end * t[i];
    const float ez = e_cpl(1.0f / a - 1.0f, om, o_r, w0, wa);
    const float integ = C_KM_S / (a * a * ez * sqrtf(3.0f * (1.0f + rb * a)));
    rs += integ * (a_end * w[i]);
  }
  return rs;
}

// the native grid's CMB integrals rs += r_s(z*) h0 and dm += D_C(z*) h0 by GL
// in a (nodes t_rs, weights w_rs on [0, 1]) and in ln a from u0 = ln a* up
// to 0, one loop per model so that a node computes its own model's density
// only
template <int MODEL>
__device__ __forceinline__ void cmb_integrals(const float* t_rs, const float* w_rs, int n_rs,
                                              const float* t_dc, const float* w_dc, int n_dc,
                                              float a_end, float u0, float rb, float om,
                                              float o_r, float w0, float& rs, float& dm) {
  rs += rs_sum<MODEL>(t_rs, w_rs, n_rs, a_end, rb, om, o_r, w0);
  for (int i = 0; i < n_dc; ++i) {
    const float u = u0 * (1.0f - t_dc[i]);
    const float a = expf(u);
    dm += C_KM_S * a / sqrtf(q_of_a<MODEL>(a, u, om, o_r, w0)) * (-u0 * w_dc[i]);
  }
}

// the drag-epoch fitting formulae of (wb, wm): z_drag (arXiv:2106.00428 eq
// A2), and r_d in Mpc from arXiv:2106.00428 eq 8 or from DESI DR2
// (arXiv:2503.14738 eq 2)
__device__ __forceinline__ float z_drag(float wb, float wm) {
  return (1.0f + 428.169f * powf(wb, 0.256459f) * powf(wm, 0.616388f) +
          925.56f * powf(wm, 0.751615f)) *
         powf(wm, -0.714129f);
}

__device__ __forceinline__ float r_drag_aizpuru(float wb, float wm) {
  const float term_a = 1.0f / (0.00257366f * powf(wb, 0.05032f) +
                               0.013f * powf(wb, 0.7720642f) * powf(wm, 0.24346362f) +
                               0.00641072f * powf(wm, 0.5350899f));
  return term_a - 32.7525f / powf(wm, 0.315473f);
}

__device__ __forceinline__ float r_drag_desi(float wb, float wm, float n_eff) {
  return 147.05f * powf(0.02236f / wb, 0.13f) * powf(0.1432f / wm, 0.23f) *
         powf(3.04f / n_eff, 0.1f);
}

// the walker's r_d in Mpc from the sampled x = theta[H_I_RD] for the kinds
// beyond a fixed or sampled r_d: r_d h / h (x = r_d h), a drag-epoch fitting
// formula of (x = wb, wm), or r_s(z_drag(wb, wm)) by the GL rule of H_RD_N
// nodes at H_OFF_RD (the nodes, then their weights; H_RD = 4 omega_gamma h^2)
// in this model's radiation-aware E(z). Not inlined: the flagship's r_d is
// sampled, and the kernel keeps one inlined copy of the r_s loops (the CMB's).
template <bool SPLIT>
__device__ __noinline__ float rd_derived(const float* s, float x, float h0, float om, float o_r,
                                         float w0, float wa, int model) {
  const int kind = static_cast<int>(s[H_RD_KIND]);
  const float hh = h0 / 100.0f;
  if (kind == RD_OVER_H) return x / hh;
  const float wm = om * (hh * hh);
  if (kind == RD_AIZPURU) return r_drag_aizpuru(x, wm);
  if (kind == RD_DESI) return r_drag_desi(x, wm, s[H_RD]);
  const float a_end = 1.0f / (1.0f + z_drag(x, wm));
  const float rb = 3.0f * x / s[H_RD];
  const float* t = s + static_cast<int>(s[H_OFF_RD]);
  const float* w = t + static_cast<int>(s[H_RD_N]);
  const int n = static_cast<int>(s[H_RD_N]);
  float rs;
  if constexpr (SPLIT) {
    rs = rs_sum_cpl(t, w, n, a_end, rb, om, o_r, w0, wa);
  } else if (model == 1) {
    rs = rs_sum<1>(t, w, n, a_end, rb, om, o_r, w0);
  } else if (model == 2) {
    rs = rs_sum<2>(t, w, n, a_end, rb, om, o_r, w0);
  } else {
    rs = rs_sum<0>(t, w, n, a_end, rb, om, o_r, w0);
  }
  return rs / h0;
}

// the walker's r_d in Mpc (H_RD_KIND), computed once before the forms: H_RD
// fixed, H_RD theta[H_I_RD], or rd_derived
template <bool SPLIT>
__device__ __forceinline__ float walker_rd(const float* s, const float* th, float h0, float om,
                                           float o_r, float w0, float wa, int model) {
  const int kind = static_cast<int>(s[H_RD_KIND]);
  if (kind <= RD_FIXED) return s[H_RD];
  const float x = th[static_cast<int>(s[H_I_RD])];
  if (kind == RD_PARAM) return s[H_RD] * x;
  return rd_derived<SPLIT>(s, x, h0, om, o_r, w0, wa, model);
}

// barycentric weights of x on one axis, projected on the Tucker factor
// u [n, R] (its rank padded with zero columns to R = 8 or 16) in one pass
// over the nodes: wp[j] = sum_m u[m, j] t_m / sum_m t_m with t_m = bw[m] /
// (x - node m), one division a node and one reciprocal of the sum (row m
// of u where x lies within 1e-14 of node m), stored at wp_out[j * WLD] for
// j < rows (<= R)
template <int R>
__device__ void project_axis(float x, const float* nodes, const float* bw, const float* u,
                             int n, int rows, float* wp_out) {
  float wp[R];
#pragma unroll
  for (int j = 0; j < R; ++j) wp[j] = 0.0f;
  float sum = 0.0f;
  int near = -1;
  for (int m = 0; m < n; ++m) {
    const float d = x - nodes[m];
    if (fabsf(d) < 1e-14f) {
      near = m;
      continue;
    }
    const float tm = bw[m] / d;
    sum += tm;
    const float4* um = reinterpret_cast<const float4*>(u + m * R);
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const float4 v = um[j];
      wp[4 * j] = fmaf(v.x, tm, wp[4 * j]);
      wp[4 * j + 1] = fmaf(v.y, tm, wp[4 * j + 1]);
      wp[4 * j + 2] = fmaf(v.z, tm, wp[4 * j + 2]);
      wp[4 * j + 3] = fmaf(v.w, tm, wp[4 * j + 3]);
    }
  }
  const float inv = 1.0f / sum;
  const float* un = u + max(near, 0) * R;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (j < rows) wp_out[j * WLD] = near >= 0 ? un[j] : wp[j] * inv;
}

// project_axis for a factor of rank r (its stored width (r + 7) & ~7; above
// 16 only the outer axis's, which the contraction reads row by row)
__device__ __forceinline__ void project(float x, const float* nodes, const float* bw,
                                        const float* u, int n, int r, int rows, float* wp_out) {
  if (r <= 8) {
    project_axis<8>(x, nodes, bw, u, n, rows, wp_out);
  } else if (r <= 16) {
    project_axis<16>(x, nodes, bw, u, n, rows, wp_out);
  } else {
    project_axis<MAX_RANK_OUTER>(x, nodes, bw, u, n, rows, wp_out);
  }
}

// the quads [q0, q0 + n) of the coefficient vector, QC at a time:
// a[q] = sum_jk (wp1[j] wp2[k]) core[j, k, q], the product of the two
// projections formed once per (j, k) and chunk (the core is [r1][r2][nq]
// float4s, so a chunk's loads lie together at compile-time offsets);
// consume(i, a[q0 + i]) then takes each quad of the chunk in order. wp1 and
// wp2 are the thread's slices of shared memory, at [j * S]. (The split
// grid's tail a = v^T tail: r2 = 1, S = VLD.)
template <int S, typename Consume>
__device__ __forceinline__ void contract_window(const float4* core, int nq, int q0, int n, int r1,
                                                int r2, const float* wp1, const float* wp2,
                                                Consume&& consume) {
  for (int c0 = 0; c0 < n; c0 += QC) {
    const int nc = min(QC, n - c0);
    float4 acc[QC];
#pragma unroll
    for (int c = 0; c < QC; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < r1; ++j) {
      const float w1 = wp1[j * S];
      const float4* row = core + j * r2 * nq + q0 + c0;
      for (int k = 0; k < r2; ++k, row += nq) {
        const float cw = w1 * wp2[k * S];
#pragma unroll
        for (int c = 0; c < QC; ++c) {
          if (c < nc) {
            const float4 v = row[c];
            acc[c].x = fmaf(cw, v.x, acc[c].x);
            acc[c].y = fmaf(cw, v.y, acc[c].y);
            acc[c].z = fmaf(cw, v.z, acc[c].z);
            acc[c].w = fmaf(cw, v.w, acc[c].w);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < QC; ++c)
      if (c < nc) consume(c0 + c, acc[c]);
  }
}

// the split grid's tail in the f64 sweep: contract_window's a = v^T tail
// (r2 = 1) with v and the sums in f64, each quad rounded to f32 for consume
// (as the plain version casts its f64 sweep's coefficients)
template <typename Consume>
__device__ __forceinline__ void tail_window_f64(const float4* tail, int nq, int q0, int n, int r,
                                                const double* v, Consume&& consume) {
  for (int c0 = 0; c0 < n; c0 += QC) {
    const int nc = min(QC, n - c0);
    double acc[QC][4];
#pragma unroll
    for (int c = 0; c < QC; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0;
    for (int j = 0; j < r; ++j) {
      const double vj = v[j * VLD_F64];
      const float4* row = tail + j * nq + q0 + c0;
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        if (c < nc) {
          const float4 u = row[c];
          acc[c][0] = fma(vj, static_cast<double>(u.x), acc[c][0]);
          acc[c][1] = fma(vj, static_cast<double>(u.y), acc[c][1]);
          acc[c][2] = fma(vj, static_cast<double>(u.z), acc[c][2]);
          acc[c][3] = fma(vj, static_cast<double>(u.w), acc[c][3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      if (c < nc) {
        consume(c0 + c, make_float4(static_cast<float>(acc[c][0]), static_cast<float>(acc[c][1]),
                                    static_cast<float>(acc[c][2]), static_cast<float>(acc[c][3])));
      }
    }
  }
}

// e (e - 2 v + 2 P g) of one (base, delta) pair of a linear form
__device__ __forceinline__ float pair_term(float bs, float base, float delta, float t,
                                           float4 row, float ga, float gb) {
  const float e = bs * fmaf(t, delta, base) - row.x;  // row: (P_BA, P_V, P_P0, P_P1)
  const float pg = row.z * ga + row.w * gb;
  return e * (e - 2.0f * row.y + 2.0f * pg);
}

template <bool SPLIT>
__device__ float cmb_chi2(const float* c, const float* th, float h0, float om, float o_r,
                          float w0, float wa, int model) {
  const float wb = th[static_cast<int>(c[C_I_OBH2])];
  const float hh = h0 / 100.0f;
  const float wm = om * (hh * hh);
  float zs;
  if (static_cast<int>(c[C_ZSTAR]) == 1) {  // Hu & Sugiyama 1996 eq 1
    const float g1 = 0.0783f * powf(wb, -0.238f) / (1.0f + 39.5f * powf(wb, 0.763f));
    const float g2 = 0.560f / (1.0f + 21.1f * powf(wb, 1.81f));
    zs = 1048.0f * (1.0f + 0.00124f * powf(wb, -0.738f)) * (1.0f + g1 * powf(wm, g2));
  } else {  // arXiv:2106.00428 eq A4
    zs = (391.672f * powf(wm, -0.372296f) + 937.422f * powf(wb, -0.97966f)) /
             (powf(wm, -0.0192951f) * powf(wb, -0.93681f)) +
         powf(wm, -0.731631f);
  }
  const int n_rs = static_cast<int>(c[C_NRS]);
  const int n_dc = static_cast<int>(c[C_NDC]);
  const float* t_rs = c + C_NODES;
  const float* w_rs = t_rs + n_rs;
  const float* t_dc = w_rs + n_rs;
  const float* w_dc = t_dc + n_dc;

  // r_s(z*) = int_0^{a*} c da / (a^2 H sqrt(3 (1 + Rb a))), GL in a, and
  // D_C(z*) = int_{ln a*}^0 c du / (a H), GL in ln a
  const float rb = 3.0f * wb / c[C_OG4];
  const float a_end = 1.0f / (1.0f + zs);
  float rs = 0.0f;
  float dm = 0.0f;
  if constexpr (SPLIT) {
    rs = rs_sum_cpl(t_rs, w_rs, n_rs, a_end, rb, om, o_r, w0, wa);
    const float u0 = logf(1.0f / (1.0f + zs));
    for (int i = 0; i < n_dc; ++i) {
      const float a = expf(u0 * (1.0f - t_dc[i]));
      const float ez = e_cpl(1.0f / a - 1.0f, om, o_r, w0, wa);
      dm += C_KM_S / (a * ez) * (-u0 * w_dc[i]);
    }
  } else {
    const float u0 = logf(1.0f / (1.0f + zs));
    if (model == 1) {
      cmb_integrals<1>(t_rs, w_rs, n_rs, t_dc, w_dc, n_dc, a_end, u0, rb, om, o_r, w0, rs, dm);
    } else if (model == 2) {
      cmb_integrals<2>(t_rs, w_rs, n_rs, t_dc, w_dc, n_dc, a_end, u0, rb, om, o_r, w0, rs, dm);
    } else {
      cmb_integrals<0>(t_rs, w_rs, n_rs, t_dc, w_dc, n_dc, a_end, u0, rb, om, o_r, w0, rs, dm);
    }
  }
  rs = rs / h0;
  dm = dm / h0;

  const int obs = static_cast<int>(c[C_OBS]);
  if (obs == OBS_THETA_100) {  // ((theta_100 - 100 r_s / D_C) / sigma)^2
    const float d = (c[C_PRIOR] - 100.0f * rs / dm) / c[C_SIGMA];
    return d * d;
  }
  float o0, o1, o2;
  if (obs == 1) {  // (theta*, wb, wm)
    o0 = rs / dm;
    o1 = wb;
    o2 = wm;
  } else {  // (R, lA, wb) or (R, 100 theta*, wb)
    o0 = sqrtf(om) * h0 * dm / C_KM_S;
    o1 = obs == 0 ? PI * dm / rs : 100.0f * rs / dm;
    o2 = wb;
  }
  const float d0 = c[C_PRIOR] - o0;
  const float d1 = c[C_PRIOR + 1] - o1;
  const float d2 = c[C_PRIOR + 2] - o2;
  const float* L = c + C_L;
  float chi2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float v = L[3 * i] * d0 + L[3 * i + 1] * d1 + L[3 * i + 2] * d2;
    chi2 += v * v;
  }
  return chi2;
}

// The split grid's sweep runs in T = float (the 3xTF32 instance) or T =
// double (the f64 instance, H_SWEEP_F64): its weights and vectors are T
// rows at a stride of sweep_ld<T>() in shared memory; the stored nodes,
// barycentric weights and cores are f32, read exactly into T.
template <bool F64>
struct Sweep {
  using type = float;
};
template <>
struct Sweep<true> {
  using type = double;
};

template <typename T>
__device__ __forceinline__ constexpr int sweep_ld() {
  return sizeof(T) == sizeof(double) ? VLD_F64 : VLD;
}

// fmaf / fabsf in float, fma / fabs in double
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// the barycentric sum of x on the n nodes, and how many nodes lie within
// 1e-14 of x (then the weights are a one-hot)
template <typename T>
__device__ __forceinline__ T bary_sum(float x, const float* nodes, const float* bw, int n,
                                      int& n_near) {
  T sum = 0;
  n_near = 0;
  for (int m = 0; m < n; ++m) {
    const T d = static_cast<T>(x) - static_cast<T>(nodes[m]);
    if (abs_t(d) < static_cast<T>(1e-14)) {
      ++n_near;
    } else {
      sum += bw[m] / d;
    }
  }
  return sum;
}

template <typename T>
__device__ __forceinline__ T bary_weight(float x, float node, float bw, T sum, int n_near) {
  const T d = static_cast<T>(x) - static_cast<T>(node);
  const bool near = abs_t(d) < static_cast<T>(1e-14);
  return n_near > 0 ? (near ? T(1) : T(0)) : (bw / d) / sum;
}

// the first tensor-train step of one walker: v[r] = sum_n w[n] G[n][r] for
// the nq output quads of r, the weights recomputed per chunk of RC quads so
// that they are never stored. G is [n][4 nq] in device memory, read as
// float4 through the read-only path; v is the walker's column of the
// block's sweep vectors, at [r * sweep_ld<T>()].
template <typename T>
__device__ __forceinline__ void tt_first(const float4* __restrict__ g, int nq, float x,
                                         const float* nodes, const float* bw, int n, T* v) {
  constexpr int LD = sweep_ld<T>();
  int n_near;
  const T sum = bary_sum<T>(x, nodes, bw, n, n_near);
  for (int q0 = 0; q0 < nq; q0 += RC) {
    const int nc = min(RC, nq - q0);
    T acc[RC][4];
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = T(0);
    for (int m = 0; m < n; ++m) {
      const T wm = bary_weight<T>(x, nodes[m], bw[m], sum, n_near);
      const float4* row = g + m * nq + q0;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        if (c < nc) {
          const float4 u = __ldg(row + c);
          acc[c][0] = fma_t(wm, static_cast<T>(u.x), acc[c][0]);
          acc[c][1] = fma_t(wm, static_cast<T>(u.y), acc[c][1]);
          acc[c][2] = fma_t(wm, static_cast<T>(u.z), acc[c][2]);
          acc[c][3] = fma_t(wm, static_cast<T>(u.w), acc[c][3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c < nc) {
        T* o = v + 4 * (q0 + c) * LD;
        o[0] = acc[c][0];
        o[LD] = acc[c][1];
        o[2 * LD] = acc[c][2];
        o[3 * LD] = acc[c][3];
      }
    }
  }
}

// the walker's barycentric weights of x on the n nodes, at w[m * sweep_ld<T>()]
template <typename T>
__device__ __forceinline__ void bary_weights(float x, const float* nodes, const float* bw, int n,
                                             T* w) {
  int n_near;
  const T sum = bary_sum<T>(x, nodes, bw, n, n_near);
  for (int m = 0; m < n; ++m) w[m * sweep_ld<T>()] = bary_weight<T>(x, nodes[m], bw[m], sum, n_near);
}

// 16 bytes from device memory into shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the operands of one later tensor-train step as a block product: the
// weights w [n + WPAD][VLD] and the sweep vector v_in [r_in][VLD] of A, and this
// lane's two columns of A in the current k-step of 8, k = m r_in + p at
// k0 + tg and k0 + tg + 4 (node m, input rank p)
struct StepA {
  const float* w;
  const float* v_in;
  int rin;
  int m0, p0, m1, p1;
  // the next k-step: each p moves 8 on and wraps at most once (r_in >= 8)
  __device__ __forceinline__ void advance() {
    p0 += 8;
    p1 += 8;
    const bool wrap0 = p0 >= rin;
    const bool wrap1 = p1 >= rin;
    p0 = wrap0 ? p0 - rin : p0;
    p1 = wrap1 ? p1 - rin : p1;
    m0 += wrap0;
    m1 += wrap1;
  }
};

// one staged slice of G (KSLICE rows) for a warp's MT m-tiles and NT
// n-tiles, both compile-time so that the slice is one straight-line block:
// A's fragments formed from w and v_in and split at once, B's read from the
// stage and split, then the three passes of 3xTF32 (small terms first);
// the code is straight-line, so the scheduler interleaves the tiles'
// independent mma. The tensor cores add in f32 with their operands aligned and truncated, not
// rounded: over a whole K of ~2,000 the bias reached 1e-4 of logp on
// bao.desi, so the slice's sums start from zero and are added to acc with
// rounding FADDs. st points at the stage's row tg, column gr; row0 is the
// lane's first row.
template <int MT, int NT>
__device__ __forceinline__ void mma_slice(const float* st, int row0, StepA& a,
                                          float (&acc)[MT_WARP][NCOL / 8][4]) {
  float part[MT][NT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j) part[t][j][0] = part[t][j][1] = part[t][j][2] = part[t][j][3] = 0.0f;
#pragma unroll KUNROLL
  for (int kk = 0; kk < KSLICE; kk += 8) {
    // A: rows row and row + 8, columns k = tg and tg + 4 (the rows of G
    // that pad it to whole slices meet the zero rows of w, m >= n)
    const float* w0 = a.w + a.m0 * VLD;
    const float* w1 = a.w + a.m1 * VLD;
    const float* v0 = a.v_in + a.p0 * VLD;
    const float* v1 = a.v_in + a.p1 * VLD;
    unsigned ahi[MT][4], alo[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int row = row0 + 16 * WARPS * t;
      split_tf32(w0[row] * v0[row], ahi[t][0], alo[t][0]);
      split_tf32(w0[row + 8] * v0[row + 8], ahi[t][1], alo[t][1]);
      split_tf32(w1[row] * v1[row], ahi[t][2], alo[t][2]);
      split_tf32(w1[row + 8] * v1[row + 8], ahi[t][3], alo[t][3]);
    }
    a.advance();
    // B: one n-tile at a time, its fragments live only for its own mma
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned bhi0, blo0, bhi1, blo1;
      split_tf32(st[kk * SLD + 8 * j], bhi0, blo0);
      split_tf32(st[(kk + 4) * SLD + 8 * j], bhi1, blo1);
#pragma unroll
      for (int t = 0; t < MT; ++t) mma_tf32(part[t][j], alo[t], bhi0, bhi1);
#pragma unroll
      for (int t = 0; t < MT; ++t) mma_tf32(part[t][j], ahi[t], blo0, blo1);
#pragma unroll
      for (int t = 0; t < MT; ++t) mma_tf32(part[t][j], ahi[t], bhi0, bhi1);
    }
  }
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] += part[t][j][e];
}

// mma_slice for the pass's n-tile count nt (1 to NCOL / 8)
template <int MT, int NT = 1>
__device__ __forceinline__ void mma_slice_nt(int nt, const float* st, int row0, StepA& a,
                                             float (&acc)[MT_WARP][NCOL / 8][4]) {
  if constexpr (NT < NCOL / 8) {
    if (nt != NT) {
      mma_slice_nt<MT, NT + 1>(nt, st, row0, a, acc);
      return;
    }
  }
  mma_slice<MT, NT>(st, row0, a, acc);
}

// the operands of one later tensor-train step in the f64 sweep, as StepA:
// this lane's one column of A in the current k-step of 4, k = m r_in + p at
// k0 + tg
struct StepA64 {
  const double* w;
  const double* v_in;
  int rin;
  int m0, p0;
  // the next k-step: p moves 4 on and wraps at most once (r_in >= 8)
  __device__ __forceinline__ void advance() {
    p0 += 4;
    const bool wrap = p0 >= rin;
    p0 = wrap ? p0 - rin : p0;
    m0 += wrap;
  }
};

// c += a b on the f64 tensor cores: a 8 x 4 (row-major fragment: row g,
// column t of lane 4 g + t), b 4 x 8 (column-major: row t, column g), c 8 x 8
// (row g, columns 2 t and 2 t + 1); IEEE double arithmetic
__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// mma_slice of the f64 sweep: each m-tile of 16 rows is two tiles of 8
// (rows row and row + 8, whose C takes acc[t][j][0, 1] and [2, 3] as the
// TF32 fragment's), A[b, (m, p)] = w_m(b) v_b[p] formed in f64, B read from
// the f32 stage and widened at fragment load. The f64 tensor cores round
// every step, so the sums run in the accumulators over the whole K.
template <int MT, int NT>
__device__ __forceinline__ void mma_slice(const float* st, int row0, StepA64& a,
                                          double (&acc)[MT_WARP][NCOL / 8][4]) {
#pragma unroll KUNROLL
  for (int kk = 0; kk < KSLICE; kk += 4) {
    const double* w0 = a.w + a.m0 * VLD_F64;
    const double* v0 = a.v_in + a.p0 * VLD_F64;
    double top[MT], bot[MT];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int row = row0 + 16 * WARPS * t;
      top[t] = w0[row] * v0[row];
      bot[t] = w0[row + 8] * v0[row + 8];
    }
    a.advance();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const double b = st[kk * SLD + 8 * j];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma_f64(acc[t][j][0], acc[t][j][1], top[t], b);
        mma_f64(acc[t][j][2], acc[t][j][3], bot[t], b);
      }
    }
  }
}

template <int MT, int NT = 1>
__device__ __forceinline__ void mma_slice_nt(int nt, const float* st, int row0, StepA64& a,
                                             double (&acc)[MT_WARP][NCOL / 8][4]) {
  if constexpr (NT < NCOL / 8) {
    if (nt != NT) {
      mma_slice_nt<MT, NT + 1>(nt, st, row0, a, acc);
      return;
    }
  }
  mma_slice<MT, NT>(st, row0, a, acc);
}

// the step's A operand and this lane's first columns: k = tg and tg + 4 in
// a k-step of 8 (3xTF32), k = tg in a k-step of 4 (f64)
__device__ __forceinline__ StepA step_a(const float* w, const float* v_in, int rin, int tg) {
  return StepA{w, v_in, rin, 0, tg, 0, tg + 4};
}

__device__ __forceinline__ StepA64 step_a(const double* w, const double* v_in, int rin, int tg) {
  return StepA64{w, v_in, rin, 0, tg};
}

// one column pass of the Tucker contraction for the warp's 32 walkers (row
// b = lane b), C[b][c] = sum_{j < ko} w1[j][b] D_j[b][c] with D_j[b][c] =
// sum_{p < ki} w2[p][b] core[j ki + p][c], for the pass's 8 NT columns c. Each
// D_j is a block product on the tensor cores in 3xTF32 as the split grid's
// sweep: A = w2 (the inner factor, its fragments read and split once a
// pass), B the core's rows j ki.. in shared memory (row stride ldb, 8 or 24
// mod 32, so that the fragments fall on 32 banks) split at load, summed from
// zero over its KS k-steps and added to C's registers by an FFMA with the
// row's w1[j] (rounded f32, as the sweep's per-slice flush). b points at the
// pass's first column of core row 0; C is the warp's buffer [column][CLD].
template <int NT, int KS>
__device__ __forceinline__ void tucker_tiles(const float* b, int ldb, int ko, const float* w1,
                                             const float* w2, float* c) {
  constexpr int ki = 8 * KS;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // the fragments' row (A, C) or column (B) in the tile
  const int tg = lane & 3;   // ... and column (A) or row (B)
  // A: w2 at rows gr, gr + 8 of m-tile t and columns tg, tg + 4 of each of
  // the inner axis's KS k-steps
  unsigned ahi[KS][2][4], alo[KS][2][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float* p = w2 + (8 * s + tg) * WLD + 16 * t + gr;
      split_tf32(p[0], ahi[s][t][0], alo[s][t][0]);
      split_tf32(p[8], ahi[s][t][1], alo[s][t][1]);
      split_tf32(p[4 * WLD], ahi[s][t][2], alo[s][t][2]);
      split_tf32(p[4 * WLD + 8], ahi[s][t][3], alo[s][t][3]);
    }
  }
    float acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
      acc[t][jj][0] = acc[t][jj][1] = acc[t][jj][2] = acc[t][jj][3] = 0.0f;
  for (int j = 0; j < ko; ++j) {
    float d[2][NT][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) d[t][jj][0] = d[t][jj][1] = d[t][jj][2] = d[t][jj][3] = 0.0f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const float* bk = b + (j * ki + 8 * s + tg) * ldb + gr;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        unsigned bhi0, blo0, bhi1, blo1;
        split_tf32(bk[8 * jj], bhi0, blo0);
        split_tf32(bk[4 * ldb + 8 * jj], bhi1, blo1);
#pragma unroll
        for (int t = 0; t < 2; ++t) mma_tf32(d[t][jj], alo[s][t], bhi0, bhi1);
#pragma unroll
        for (int t = 0; t < 2; ++t) mma_tf32(d[t][jj], ahi[s][t], blo0, blo1);
#pragma unroll
        for (int t = 0; t < 2; ++t) mma_tf32(d[t][jj], ahi[s][t], bhi0, bhi1);
      }
    }
    // C += w1[j] D_j: D's rows gr, gr + 8 of m-tile t
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float u0 = w1[j * WLD + 16 * t + gr];
      const float u8 = w1[j * WLD + 16 * t + gr + 8];
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        acc[t][jj][0] = fmaf(u0, d[t][jj][0], acc[t][jj][0]);
        acc[t][jj][1] = fmaf(u0, d[t][jj][1], acc[t][jj][1]);
        acc[t][jj][2] = fmaf(u8, d[t][jj][2], acc[t][jj][2]);
        acc[t][jj][3] = fmaf(u8, d[t][jj][3], acc[t][jj][3]);
      }
    }
  }
  // C: rows gr, gr + 8 of m-tile t, columns 2 tg, 2 tg + 1 of n-tile jj
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      float* cc = c + (8 * jj + 2 * tg) * CLD + 16 * t + gr;
      cc[0] = acc[t][jj][0];
      cc[CLD] = acc[t][jj][1];
      cc[8] = acc[t][jj][2];
      cc[CLD + 8] = acc[t][jj][3];
    }
  }
}

// tucker_tiles for the pass's n-tile count nt (1 to NCOLT / 8) and the
// inner axis's ki = 8 or 16 rows
template <int NT = 1>
__device__ __forceinline__ void tucker_tiles_nt(int nt, const float* b, int ldb, int ko, int ki,
                                                const float* w1, const float* w2, float* c) {
  if constexpr (NT < NCOLT / 8) {
    if (nt != NT) {
      tucker_tiles_nt<NT + 1>(nt, b, ldb, ko, ki, w1, w2, c);
      return;
    }
  }
  if (ki == 8) {
    tucker_tiles<NT, 1>(b, ldb, ko, w1, w2, c);
  } else {
    tucker_tiles<NT, 2>(b, ldb, ko, w1, w2, c);
  }
}

// one later tensor-train step as a block product over one half's rows
// [lo, hi) (lo = 0, or hi = THREADS), in m-tiles of 16 rows whose padding
// rows lie on the other half's rows: v_out[r][b] = sum_{m, p} (w[m][b] v_in[p][b])
// G[m r_in + p][r] for r < rout, in 3xTF32 on the tensor cores (T = float)
// or on the f64 tensor cores (T = double, mma.sync m8n8k4). G is
// [kp][np] in device memory (kp = n r_in padded to KSLICE rows of zeros, np
// = rout padded to 8), streamed through the ring by cp.async, NCOL columns
// a pass. A warp owns the m-tiles warp and warp + WARPS, or in a half of
// one or two m-tiles one m-tile and a share of the n-tiles. v_out may be
// v_in when np <= NCOL (one pass). Every thread of the block calls it (it
// holds the barriers).
template <typename T>
__device__ __forceinline__ void block_step(const float* __restrict__ g, int n, int rin, int rout,
                                           int lo, int hi, const T* w, const T* v_in,
                                           T* v_out, float* ring) {
  constexpr int LD = sweep_ld<T>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gr = (tid & 31) >> 2;  // the fragments' row (A, C) or column (B) in the tile
  const int tg = tid & 3;          // ... and column (A) or row (B)
  // m-tiles of 16 rows over [lo, hi), from row 0 up or from THREADS down
  const int mt = (hi - lo + 15) >> 4;
  const int base = lo == 0 ? 0 : THREADS - 16 * mt;
  // the warp's share: m-tiles warp and warp + WARPS, all n-tiles; a half of
  // one or two m-tiles is spread over every warp, each taking one m-tile
  // and a part of the n-tiles
  const int parts = mt > 2 ? 1 : WARPS / mt;
  const int part = mt > 2 ? 0 : warp / mt;
  const int row0 = base + (mt > 2 ? warp : warp % mt) * 16 + gr;
  const int mtiles = mt > 2 ? (warp < mt) + (warp + WARPS < mt) : 1;
  const int np = (rout + 7) & ~7;
  const int nslices = (n * rin + KSLICE - 1) / KSLICE;
  for (int c0 = 0; c0 < np; c0 += NCOL) {
    const int nt = min(NCOL, np - c0) >> 3;
    const int j0 = part * nt / parts;  // the warp's n-tiles [j0, j0 + ntw)
    const int ntw = (part + 1) * nt / parts - j0;
    const int tiles = ntw > 0 ? mtiles : 0;
    const int chunks = 2 * nt;  // 16-byte chunks of a slice row
    auto issue = [&](int sl) {
      float* dst = ring + (sl % STAGES) * (KSLICE * SLD);
      const float* src = g + static_cast<long long>(sl) * KSLICE * np + c0;
      for (int c = tid; c < KSLICE * chunks; c += THREADS) {
        const int r = c / chunks;
        const int q = c - r * chunks;
        cp_async16(dst + r * SLD + 4 * q, src + r * np + 4 * q);
      }
    };
#pragma unroll
    for (int sl = 0; sl < STAGES - 1; ++sl) {
      if (sl < nslices) issue(sl);
      cp_async_commit();
    }
    T acc[MT_WARP][NCOL / 8][4];
#pragma unroll
    for (int t = 0; t < MT_WARP; ++t)
#pragma unroll
      for (int j = 0; j < NCOL / 8; ++j)
        acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = T(0);
    // k = tg (and tg + 4) lie on node 0 (r_in >= 8)
    auto a = step_a(w, v_in, rin, tg);
    for (int sl = 0; sl < nslices; ++sl) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slice sl landed for all; slice sl - 1's stage is free
      if (sl + STAGES - 1 < nslices) issue(sl + STAGES - 1);
      cp_async_commit();
      const float* st = ring + (sl % STAGES) * (KSLICE * SLD) + tg * SLD + 8 * j0 + gr;
      if (tiles == 2) {
        mma_slice_nt<2>(ntw, st, row0, a, acc);
      } else if (tiles == 1) {
        mma_slice_nt<1>(ntw, st, row0, a, acc);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with v_in and w: v_out may be v_in
    // C: rows row and row + 8, columns 2 tg and 2 tg + 1; only the half's
    // own rows [lo, hi) are written
#pragma unroll
    for (int t = 0; t < MT_WARP; ++t) {
      const int row = row0 + 16 * WARPS * t;
      const bool in0 = lo <= row && row < hi;
      const bool in8 = lo <= row + 8 && row + 8 < hi;
#pragma unroll
      for (int j = 0; j < NCOL / 8; ++j) {
        const int col = c0 + 8 * (j0 + j) + 2 * tg;
        if (t < tiles && j < ntw && col < rout) {
          if (in0) v_out[col * LD + row] = acc[t][j][0];
          if (in8) v_out[col * LD + row + 8] = acc[t][j][2];
        }
        if (t < tiles && j < ntw && col + 1 < rout) {
          if (in0) v_out[(col + 1) * LD + row] = acc[t][j][1];
          if (in8) v_out[(col + 1) * LD + row + 8] = acc[t][j][3];
        }
      }
    }
    __syncthreads();  // v_out complete; the ring free again
  }
}

// the emulated terms: chi2 and log_norm of each form, its window of the
// coefficient vector contracted by window(q0, nq, consume); rd the walker's
// r_d
template <typename Window>
__device__ __forceinline__ void eval_forms(const float* s, const float* forms, int n_forms,
                                           const float* th, float h0, float t, float rd,
                                           float& chi2, float& log_norm, Window&& window) {
  for (int f = 0; f < n_forms; ++f) {
    const float* F = forms + f * FORM_STRIDE;
    const int kind = static_cast<int>(F[F_KIND]);
    const int q0 = static_cast<int>(F[F_Q0]);
    const int fnq = static_cast<int>(F[F_NQ]);
    const float* rows = s + static_cast<int>(F[F_ROWS]);
    float fchi = 0.0f;
    if (kind == KIND_LINEAR) {
      float beta = 1.0f;
      const int beta_kind = static_cast<int>(F[F_BETA]);
      if (beta_kind == BETA_BAO) {  // c / (H0 r_d)
        beta = C_KM_S / (h0 * rd);
      } else if (beta_kind == BETA_H0) {
        beta = h0;
      }
      const int J = static_cast<int>(F[F_J]);
      const float ga =
          J > 0 ? th[static_cast<int>(F[F_MAG_IDX])] - F[F_OFFSET] - F[F_GREF0] : 0.0f;
      const float gb = J > 1 ? -5.0f * log10f(h0 / F[F_H0REF]) - F[F_GREF1] : 0.0f;
      const float bs = beta * F[F_SCALE];
      fchi = F[F_CREF] + ga * (F[F_S00] * ga + F[F_S01] * gb) +
             gb * (F[F_S10] * ga + F[F_S11] * gb) - 2.0f * (ga * F[F_QREF0] + gb * F[F_QREF1]);
      const float4* prow = reinterpret_cast<const float4*>(rows);
      window(q0, fnq, [&](int q, float4 v) {
        fchi += pair_term(bs, v.x, v.y, t, prow[2 * q], ga, gb);
        fchi += pair_term(bs, v.z, v.w, t, prow[2 * q + 1], ga, gb);
      });
    } else if (kind == KIND_LIFT) {
      // rows: d_ref [K], sigma^2 [K], scale B_t [2 fnq][K]; the K values
      // in chunks of MAX_K, the window walked again for each chunk (its
      // dmu in registers; a lift of at most MAX_K values takes one)
      const int K = static_cast<int>(F[F_K]);
      const float sc = th[static_cast<int>(F[F_I_S])];
      const float s2 = sc * sc;
      const float off = th[static_cast<int>(F[F_I_OFF])];
      float log_sum = 0.0f;
#pragma unroll 1
      for (int k0 = 0; k0 < K; k0 += MAX_K) {
        const int kn = min(MAX_K, K - k0);
        const float* bt = rows + 2 * K + k0;
        float dmu[MAX_K];
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) dmu[k] = 0.0f;
        window(q0, fnq, [&](int q, float4 v) {
          const float a0 = fmaf(t, v.y, v.x);
          const float a1 = fmaf(t, v.w, v.z);
          const float* b0 = bt + 2 * q * K;
          const float* b1 = b0 + K;
#pragma unroll
          for (int k = 0; k < MAX_K; ++k)
            if (k < kn) dmu[k] = fmaf(a1, b1[k], fmaf(a0, b0[k], dmu[k]));
        });
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          if (k < kn) {
            const float var = rows[K + k0 + k] + s2;
            const float d = rows[k0 + k] - dmu[k] - off;
            fchi += d * d / var;
            log_sum += logf(var);
          }
        }
      }
      log_norm -= 0.5f * log_sum;
    } else {  // amp_pair: quads (u, du, v, dv)
      const float amp = th[static_cast<int>(F[F_I_AMP])];
      const float sc = F[F_SCALE];
      window(q0, fnq, [&](int, float4 v) {
        const float r = sc * (fmaf(t, v.y, v.x) - amp * fmaf(t, v.w, v.z));
        fchi = fmaf(r, r, fchi);
      });
    }
    const int f_idx = static_cast<int>(F[F_F_IDX]);
    if (f_idx >= 0) {  // chi2 f^-2 or f^2, log_norm + const + coef ln f
      const float fv = th[f_idx];
      fchi *= F[F_POW] < 0.0f ? 1.0f / (fv * fv) : fv * fv;
      log_norm += F[F_LN_CONST] + F[F_LN_COEF] * logf(fv);
    }
    chi2 += fchi;
  }
}

// the walker's row in the block's sweep, and each half's walker count:
// ballots per warp, the warps' counts through shared memory. Half 0's
// walkers take rows [0, count0), half 1's rows [THREADS - count1, THREADS).
// mine is the walker's half, or -1 for a thread past the last walker.
__device__ __forceinline__ int group_rows(int mine, int& count0, int& count1) {
  __shared__ int s_count[2][WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned in0 = __ballot_sync(0xffffffffu, mine == 0);
  const unsigned in1 = __ballot_sync(0xffffffffu, mine == 1);
  if (lane == 0) {
    s_count[0][warp] = __popc(in0);
    s_count[1][warp] = __popc(in1);
  }
  __syncthreads();
  int before = 0;
  count0 = count1 = 0;
  for (int k = 0; k < WARPS; ++k) {
    count0 += s_count[0][k];
    count1 += s_count[1][k];
    if (k < warp && mine >= 0) before += s_count[mine][k];
  }
  const int index = before + __popc((mine == 0 ? in0 : in1) & ((1u << lane) - 1u));
  return mine == 0 ? index : THREADS - count1 + index;
}

// SPLIT: the split w0wacdm grid, the TT sweep of each half as block
// products over ``tt`` (in f64 for F64, H_SWEEP_F64); otherwise the native
// grid's Tucker core in shared memory. ``stride``: on the native grid the
// rows of WLD floats of a warp's projections (H_KO + H_KI); on the split grid
// the rows of the sweep's weights and vectors (the node count, WPAD and
// H_VROWS), of VLD floats or VLD_F64 doubles.
template <bool SPLIT, bool F64 = false>
__device__ __forceinline__ void fused_log_prob(const float* __restrict__ consts, int n_consts,
                                               const float* __restrict__ tt, int stride,
                                               const float* __restrict__ theta,
                                               float* __restrict__ out, long long W, int D) {
  constexpr int BLOCK = SPLIT ? THREADS : TUCKER_THREADS;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  if constexpr (SPLIT) {
    for (int i = threadIdx.x; i < n_consts; i += THREADS) s[i] = consts[i];
  } else {  // 16 bytes a load (the buffer starts on 16 bytes, as the wrapper checks)
    const float4* c4 = reinterpret_cast<const float4*>(consts);
    for (int i = threadIdx.x; i < n_consts / 4; i += BLOCK) smem4[i] = c4[i];
    for (int i = (n_consts & ~3) + threadIdx.x; i < n_consts; i += BLOCK) s[i] = consts[i];
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const long long w = static_cast<long long>(blockIdx.x) * BLOCK + tid;
  // the ragged last block: a thread past the end takes part in its warp's
  // products (and on the split grid in the block's barriers) on a copy of
  // the last walker, and writes nothing
  const float* th = theta + min(w, W - 1) * D;
  // per warp [stride][WLD] projections and [NCOLT][CLD] C (native grid), or
  // the sweep's [stride][VLD] rows (split grid; [stride][VLD_F64] doubles in
  // the f64 sweep)
  float* scratch = s + ((n_consts + 3) & ~3);

  // 1. derived parameters
  const int model = static_cast<int>(s[H_MODEL]);
  // H0 sampled (or h), or one constant for every walker (0 where no term
  // reads it); w0 sampled, or as exp(w0)
  const int i_h0 = static_cast<int>(s[H_I_H0]);
  const float h0 = i_h0 >= 0 ? th[i_h0] * s[H_H0_SCALE] : s[H_H0_CONST];
  const float om = th[static_cast<int>(s[H_I_OM])];
  const int i_w0 = static_cast<int>(s[H_I_W0]);
  float w0 = i_w0 >= 0 ? th[i_w0] : 0.0f;
  if (s[H_W0_LOG] != 0.0f) w0 = logf(w0);
  const float wa = SPLIT ? th[static_cast<int>(s[H_I_WA])] : 0.0f;
  const float hh = h0 / 100.0f;
  const float o_r = s[H_ORH2] != 0.0f ? s[H_ORH2] / (hh * hh) : 0.0f;
  const float t = o_r / OR_REF;
  const float rd = walker_rd<SPLIT>(s, th, h0, om, o_r, w0, wa, model);
  const int n_forms = static_cast<int>(s[H_NFORMS]);
  float chi2 = 0.0f;
  float log_norm = 0.0f;

  if constexpr (SPLIT) {
    // 2. the walkers grouped by half (a NaN s takes half 1, as jnp.where)
    const float sv = w0 + wa;
    const int mine = w < W ? (sv <= 0.0f ? 0 : 1) : -1;
    const int n = static_cast<int>(s[H_N1]);  // every axis of the split grid
    const int vrows = stride - n - WPAD;
    const float* bw = s + static_cast<int>(s[H_OFF_BW1]);
    using T = typename Sweep<F64>::type;
    constexpr int LD = sweep_ld<T>();
    T* s_w = reinterpret_cast<T*>(scratch);  // [n + WPAD][LD] the weights of one step
    T* s_v = s_w + (n + WPAD) * LD;          // [vrows][LD] the sweep vectors
    float* ring = reinterpret_cast<float*>(s_w + stride * LD);  // [STAGES][KSLICE][SLD] slices of G
    for (int i = tid; i < WPAD * LD; i += THREADS) s_w[n * LD + i] = T(0);
    int count0, count1;
    const int pos = group_rows(mine, count0, count1);  // its barrier publishes the zeros
    const float* halves = s + static_cast<int>(s[H_OFF_HALVES]);
    const float* hm = halves + (mine > 0 ? HALF_STRIDE : 0);  // the walker's own half
    const bool live = mine >= 0;
    auto coord = [&](int i) {  // the walker's core i's axis: 0 Om, 1 wa, 2 s
      const int axis = static_cast<int>(hm[T_PERM0 + i]);
      return axis == 0 ? om : (axis == 1 ? wa : sv);
    };
    // the first step per walker, each in its own half, into the front of
    // s_v; then per later step each walker's weights, and each half's block
    // product over its rows: half 0 rows [0, count0), half 1 rows
    // [THREADS - count1, THREADS), a product's padding rows lying on the
    // other half's rows (read, never written). A product of one column
    // pass writes its output over its input, a wider one at the other end
    // of s_v.
    if (live) {
      tt_first(reinterpret_cast<const float4*>(tt + static_cast<int>(hm[T_G0])),
               ((static_cast<int>(hm[T_R1]) + 7) & ~7) >> 2, coord(0),
               s + static_cast<int>(hm[T_AX0]), bw, n, s_v + pos);
    }
    T* v0 = s_v;  // each half's sweep vectors
    T* v1 = s_v;
#pragma unroll 1
    for (int i = 1; i < 3; ++i) {
      if (live) bary_weights(coord(i), s + static_cast<int>(hm[T_AX0 + i]), bw, n, s_w + pos);
      __syncthreads();
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {  // one call site: the products' code is large
        const int count = h == 0 ? count0 : count1;
        if (count == 0) continue;
        const float* hb = halves + h * HALF_STRIDE;
        const int r = static_cast<int>(hb[T_R1 + i]);
        const int np = (r + 7) & ~7;
        T* v_in = h == 0 ? v0 : v1;
        T* v_out = np <= NCOL ? v_in : (v_in == s_v ? s_v + (vrows - np) * LD : s_v);
        block_step(tt + static_cast<int>(hb[T_G0 + i]), n, static_cast<int>(hb[T_R1 + i - 1]), r,
                   h == 0 ? 0 : THREADS - count, h == 0 ? count : THREADS, s_w, v_in, v_out,
                   ring);
        v0 = h == 0 ? v_out : v0;
        v1 = h == 0 ? v1 : v_out;
      }
    }
    // 3. the emulated terms, each window a = v^T tail over its quads
    if (live) {
      const float4* tail = reinterpret_cast<const float4*>(tt + static_cast<int>(hm[T_TAIL]));
      const int nq = static_cast<int>(hm[T_NQ]);
      const int r3 = static_cast<int>(hm[T_R3]);
      const float* one = hm + T_ONE;
      const T* v = (mine > 0 ? v1 : v0) + pos;
      eval_forms(s, s + static_cast<int>(hm[T_OFF_FORMS]), n_forms, th, h0, t, rd, chi2, log_norm,
                 [&](int q0, int nw, auto&& consume) {
                   if constexpr (F64) {
                     tail_window_f64(tail, nq, q0, nw, r3, v, consume);
                   } else {
                     contract_window<VLD>(tail, nq, q0, nw, r3, 1, v, one, consume);
                   }
                 });
    }
  } else if (n_forms > 0) {  // a fit with no emulated term (cmb.cmb) has no grid
    // 2. barycentric weights folded into the factor projections, each
    // walker's into its row of its warp's slices: the outer factor w1
    // [ko][WLD] and the inner one w2 [ki][WLD] (the axis H_INNER, its rank
    // padded with zeros to whole k-steps; one axis: w1 = 1)
    const int lane = tid & 31;
    const int ko = static_cast<int>(s[H_KO]);
    const int ki = static_cast<int>(s[H_KI]);
    float* w1 = scratch + (tid >> 5) * (stride * WLD + NCOLT * CLD);
    float* w2 = w1 + ko * WLD;
    float* cbuf = w1 + stride * WLD;
    const int r1 = static_cast<int>(s[H_R1]);
    const int r2 = static_cast<int>(s[H_R2]);
    const bool two = static_cast<int>(s[H_NAXES]) > 1;
    const bool inner1 = !two || static_cast<int>(s[H_INNER]) == 1;
    float* wp_om = (inner1 ? w2 : w1) + lane;
    float* wp_w0 = (inner1 ? w1 : w2) + lane;
    if (!two) w1[lane] = 1.0f;
    if constexpr (PROBE & 4) {
      for (int j = 0; j < (inner1 ? ki : r1); ++j) wp_om[j * WLD] = om;
      for (int j = 0; two && j < (inner1 ? r2 : ki); ++j) wp_w0[j * WLD] = w0;
    } else {
      project(om, s + static_cast<int>(s[H_OFF_AX1]), s + static_cast<int>(s[H_OFF_BW1]),
              s + static_cast<int>(s[H_OFF_U1]), static_cast<int>(s[H_N1]), r1,
              inner1 ? ki : r1, wp_om);
      if (two) {
        project(w0, s + static_cast<int>(s[H_OFF_AX2]), s + static_cast<int>(s[H_OFF_BW2]),
                s + static_cast<int>(s[H_OFF_U2]), static_cast<int>(s[H_N2]), r2,
                inner1 ? r2 : ki, wp_w0);
      }
    }
    __syncwarp();
    // 3. the emulated terms, each window contracted in column passes of at
    // most NCOLT columns by the warp's block product into C, each walker
    // then reducing the quads of its own row
    const float* core = s + static_cast<int>(s[H_OFF_CORE]);
    const int ldb = static_cast<int>(s[H_LDB]);
    eval_forms(s, s + static_cast<int>(s[H_OFF_FORMS]), n_forms, th, h0, t, rd, chi2, log_norm,
               [&](int q0, int nq, auto&& consume) {
                 const int end = 4 * (q0 + nq);
                 for (int c0 = 4 * q0; c0 < end; c0 += NCOLT) {
                   const int ncol = min(NCOLT, end - c0);
                   __syncwarp();  // the warp converged for its mma.sync
                   if constexpr (PROBE & 2) {
                     for (int i = 0; i < ncol; ++i) cbuf[i * CLD + lane] = w1[lane] * w2[lane];
                   } else {
                     tucker_tiles_nt((ncol + 7) >> 3, core + c0, ldb, ko, ki, w1, w2, cbuf);
                   }
                   __syncwarp();
                   for (int i = 0; i < ncol; i += 4) {
                     const float* ci = cbuf + i * CLD + lane;
                     consume((c0 - 4 * q0 + i) >> 2,
                             make_float4(ci[0], ci[CLD], ci[2 * CLD], ci[3 * CLD]));
                   }
                   __syncwarp();  // C free for the next pass
                 }
               });
  }

  // 4. the compressed CMB or the theta* prior, and the scalar prior: Om h^2
  // or a sampled parameter (IEEE division)
  if (s[H_HAS_CMB] != 0.0f && (SPLIT || !(PROBE & 1))) {
    chi2 += cmb_chi2<SPLIT>(s + static_cast<int>(s[H_OFF_CMB]), th, h0, om, o_r, w0, wa,
                            model);
  }
  const int prior = static_cast<int>(s[H_PRIOR]);
  if (prior != 0) {
    const float x = prior == PRIOR_OMH2 ? om * (hh * hh) : th[static_cast<int>(s[H_I_PRIOR])];
    const float d = (s[H_PRIOR_MEAN] - x) / s[H_PRIOR_SIGMA];
    chi2 += d * d;
  }

  // 5. strict-interior bounds and the finite guard
  const float ll = -0.5f * chi2 + log_norm;
  bool ok = isfinite(ll);
  const float* lo = s + static_cast<int>(s[H_OFF_BOUNDS]);
  for (int d = 0; d < D; ++d) {
    const float v = th[d];
    ok = ok && lo[d] < v && v < lo[D + d];
  }
  if (w >= W) return;
  out[w] = ok ? ll : -INFINITY;
}

// the instances as kernels: the split ones with their registers capped so
// that SPLIT_BLOCKS (3xTF32) or SPLIT_F64_BLOCKS (f64 sweep) blocks fit an SM
__global__ void __launch_bounds__(TUCKER_THREADS, TUCKER_SM_WARPS / TUCKER_WARPS)
fused_log_prob_kernel(const float* __restrict__ consts, int n_consts, int stride,
                      const float* __restrict__ theta, float* __restrict__ out, long long W,
                      int D) {
  fused_log_prob<false>(consts, n_consts, nullptr, stride, theta, out, W, D);
}

__global__ void __launch_bounds__(THREADS, SPLIT_BLOCKS)
fused_log_prob_split_kernel(const float* __restrict__ consts, int n_consts,
                            const float* __restrict__ tt, int stride,
                            const float* __restrict__ theta, float* __restrict__ out,
                            long long W, int D) {
  fused_log_prob<true>(consts, n_consts, tt, stride, theta, out, W, D);
}

__global__ void __launch_bounds__(THREADS, SPLIT_F64_BLOCKS)
fused_log_prob_split_f64_kernel(const float* __restrict__ consts, int n_consts,
                                const float* __restrict__ tt, int stride,
                                const float* __restrict__ theta, float* __restrict__ out,
                                long long W, int D) {
  fused_log_prob<true, true>(consts, n_consts, tt, stride, theta, out, W, D);
}

// the instance of a launch: 0 the native grid, 1 the split grid in 3xTF32,
// 2 the split grid with its sweep in f64
constexpr int INSTANCES = 3;

// dynamic shared memory of a launch: the constants, then per warp its
// projections and C (native grid) or the sweep's rows (floats, or doubles in
// the f64 sweep) and the ring of G (split grid)
size_t smem_bytes(int instance, int n_consts, int stride) {
  const size_t ld = instance == 2 ? 2 * VLD_F64 : VLD;  // a row's floats
  const size_t scratch = instance ? static_cast<size_t>(stride) * ld + STAGES * KSLICE * SLD
                                  : TUCKER_WARPS * (static_cast<size_t>(stride) * WLD + NCOLT * CLD);
  return (static_cast<size_t>((n_consts + 3) & ~3) + scratch) * sizeof(float);
}

// the instance's kernel and its dynamic shared memory, the kernel's limit
// raised where that exceeds 48 KB
cudaError_t prepare(int instance, int n_consts, int stride, size_t& smem, const void*& kernel) {
  smem = smem_bytes(instance, n_consts, stride);
  const void* kernels[INSTANCES] = {reinterpret_cast<const void*>(fused_log_prob_kernel),
                                    reinterpret_cast<const void*>(fused_log_prob_split_kernel),
                                    reinterpret_cast<const void*>(fused_log_prob_split_f64_kernel)};
  kernel = kernels[instance];
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int launch(int instance, const float* consts, int n_consts, const float* tt, int stride,
           const float* theta, float* out, long long W, int D, cudaStream_t stream) {
  size_t smem;
  const void* kernel;
  const cudaError_t err = prepare(instance, n_consts, stride, smem, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = instance ? THREADS : TUCKER_THREADS;
  const unsigned int blocks = static_cast<unsigned int>((W + block - 1) / block);
  if (instance == 2) {  // the f64 sweep (H_SWEEP_F64)
    fused_log_prob_split_f64_kernel<<<blocks, THREADS, smem, stream>>>(
        consts, n_consts, tt, stride, theta, out, W, D);
  } else if (instance == 1) {
    fused_log_prob_split_kernel<<<blocks, THREADS, smem, stream>>>(consts, n_consts, tt, stride,
                                                                   theta, out, W, D);
  } else {
    fused_log_prob_kernel<<<blocks, TUCKER_THREADS, smem, stream>>>(consts, n_consts, stride,
                                                                    theta, out, W, D);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int n_consts, int D, int instance, int stride) {
  return n_consts > MAX_FLOATS || D > MAX_DIM || D < 1 || instance < 0 || instance >= INSTANCES ||
         stride < (instance ? 1 : 0) ||
         stride > (instance ? MAX_NODES + WPAD + 2 * MAX_BOND : MAX_RANK_OUTER + MAX_RANK);
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `stream` is
// a cudaStream_t. `tt` is the split grid's TT buffer (null on a native
// grid), `split` the instance: 0 the native grid, 1 the split grid, 2 the
// split grid with its sweep in f64 (the packer's H_SWEEP_F64); `stride` the
// rows of WLD floats of a warp's projections on the native grid (H_KO +
// H_KI), or on the split grid the rows of the sweep's weights and vectors
// (H_N1 + WPAD + H_VROWS). Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for sizes above the compiled maxima.
// The caller guarantees W >= 1 and contiguous f32 inputs.
extern "C" int cosmax_fused_log_prob_f32(const float* consts, int n_consts, const float* tt,
                                         int split, int stride, const float* theta, float* out,
                                         long long W, int D, void* stream) {
  if (bad_args(n_consts, D, split, stride) || (split && tt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(split, consts, n_consts, tt, stride, theta, out, W, D,
                static_cast<cudaStream_t>(stream));
}

// For reports: the dynamic shared memory of one block (bytes) and the
// blocks an SM holds at once, of the launch that cosmax_fused_log_prob_f32
// makes with these arguments. Returns a cudaError_t (0 on success).
extern "C" int cosmax_fused_log_prob_occupancy(int n_consts, int split, int stride,
                                               int* smem_bytes_out, int* blocks_per_sm) {
  if (bad_args(n_consts, 1, split, stride)) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  const void* kernel;
  cudaError_t err = prepare(split, n_consts, stride, smem, kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        split ? THREADS : TUCKER_THREADS, smem);
  }
  *smem_bytes_out = static_cast<int>(smem);
  return static_cast<int>(err);
}
