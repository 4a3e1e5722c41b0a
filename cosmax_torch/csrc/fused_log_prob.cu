// Fused fast log-prob for Hopper (sm_90a): logp[W] for walkers theta[W, D]
// of a fast preset (get_preset(..., fast=True)), the whole joint in one
// launch.
//
// Replaces the TPU kernel cosmax/ops/pallas/megakernel.py::blocked_log_prob,
// which replays the traced log-prob of a walker block inside one
// pallas_call with every constant resident in VMEM. This kernel is not a
// replayer: it is the bundled fast log-prob written out by hand. Per walker:
//   1. H0 and Or from theta (Or = orh2 / h^2, or 0 without radiation; a
//      fit may sample no H0 at all, then nothing reads it);
//   2. barycentric weights on each Chebyshev axis (a one-hot within 1e-14
//      of a node), folded straight into the Tucker factor projections
//      wp_i = U_i^T w_i: a second pass recomputes bw/diff, so the node
//      weights are never stored. On the split w0wacdm grid (#1b) the
//      walker takes half 0 if s = w0 + wa <= 0, else half 1, and computes
//      that half only (a thread branches; the value is the reference's
//      jnp.where, cosmax/models/linear_chi2.py:575-587): the tensor-train
//      sweep v <- w_0^T G_0, then v'[r] = sum_p sum_n v[p] w[n] G[p, n, r]
//      for the two later cores, the weights of each (Om, wa, s) axis
//      recomputed from bw/diff as the sweep needs them; the coefficient
//      vector is then a = v^T tail;
//   3. the emulated terms, one form at a time. Each form owns a window of
//      the core's columns, whole quads (float4) in an order the packer
//      chose; the window is contracted a[q] = sum_jk wp1[j] wp2[k]
//      core[j, k, q] up to QC quads at a time and each quad reduced at
//      once, so only the chunk and the form's running sums stay live, never
//      the whole a[R_all]:
//      * linear (BAO, SN, CC): quads of two (base, Or-delta) pairs,
//        e = beta s (a + Or/OR_REF a_d) - ba_ref, chi2 = c_ref - 2 e.v_ref
//        + e.e, plus g.S g - 2 g.q_ref + 2 e.P g where the form has
//        nuisance columns (cosmax/models/linear_chi2.py:547-567); beta is
//        1, c / (H0 r_d) or H0;
//      * lift (quasars): dmu[K] += a_i (scale B_t)[i, :] pair by pair,
//        then d = (mu - mu_ref) - dmu - dM, chi2 = sum d^2 / (sigma^2 +
//        s^2), log_norm = -1/2 sum ln(sigma^2 + s^2);
//      * amp_pair (fs8): quads (u, du, v, dv) of one rank index, r = scale
//        ((u + t du) - amp (v + t dv)), chi2 = |r|^2
//        (cosmax/models/linear_chi2.py:679-689);
//      then a form's rescaling f: chi2 * f^-2 or f^2, log_norm += const +
//      coef ln f;
//   4. the compressed CMB: z* (Aizpuru A4, or Hu & Sugiyama), r_s by GL in
//      a and D_C by GL in ln a with the radiation-aware E(z), the three
//      observables and the 3 x 3 whitened chi^2;
//   5. -chi2/2 + log_norm, or -inf outside the strict interior of the f32
//      bounds or where the sum is not finite.
// The constants come packed by cosmax_torch/ops/kernels/fused_log_prob.py
// (pack): a header of sizes and offsets (the H_* slots below, the same in
// both files), 14 KB for the flagship, 45 KB for the multiprobe joint in
// wzcdm and 80 KB in wcdm. The split grid's TT cores and tails (620 KB for
// the w0wacdm flagship, more than a block's shared memory) stay in a
// second buffer in device memory.
//
// What bounds it on the card: per walker about 9.1k f32 operations for the
// flagship and 25k for the multiprobe joint (wzcdm; 20k of them in the
// core contraction), about 198k (half 0) or 107k (half 1) for the w0wacdm
// flagship, nearly all in the TT sweep, against 28-48 bytes of HBM
// traffic (theta in, logp out). It is bound by operations (FFMA issue,
// the loads that feed it, and the accurate transcendental sequences),
// never by memory.
//
// What the design does about it:
// * One thread per walker, 128 threads a block; the block first copies the
//   constant buffer into shared memory. Every contraction then reads one
//   shared address across the warp (a broadcast, no bank conflicts), and
//   the core as float4.
// * Register pressure stays flat in R_all: a form's window is contracted
//   QC quads at a time (acc[QC], float4) and each quad is consumed at
//   once, so the live state is the chunk and the form's sums (dmu[MAX_K]
//   for a lift). The weight wp1[j] wp2[k] is formed once per (j, k) and
//   chunk, so the contraction costs r1 r2 a chunk for the weights and
//   2 r1 r2 a column. Loops over those arrays unroll to
//   compile-time bounds with uniform guards. wp1 and wp2 stay in
//   per-thread slices of shared memory ([j][thread], conflict-free), read
//   back by the thread that wrote them.
// * The TT sweep (kernel instance SPLIT) reads its cores through the
//   read-only path (__ldg, float4): the threads of a warp on one half read
//   one address at each step, served by L1, and both halves' cores stay
//   resident in L2. Each step accumulates RC quads of output ranks at a
//   time in registers, so register use stays flat in the bond rank (up to
//   MAX_BOND); the sweep vectors live in per-thread slices of shared
//   memory sized by the largest padded bond of the packed fit. A warp
//   whose walkers straddle s = 0 runs both sweeps, masked.
// * Accurate libm functions and IEEE division and square root (no
//   --use_fast_math): the CMB term divides theta* by its sigma ~ 2.6e-6,
//   and the quasar term takes 22 logf a walker.
// * The ragged last block is masked; each thread reads and writes only its
//   own walker, so a NaN walker stays in its row.
// Maxima such as MAX_RANK are compile-time; the packer refuses larger fits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_DIM = 16;
constexpr int MAX_NODES = 64;
constexpr int MAX_RANK = 16;
constexpr int MAX_BOND = 128;
constexpr int MAX_RALL = 256;
constexpr int MAX_FORMS = 8;
constexpr int MAX_K = 32;
constexpr int MAX_GL = 64;
constexpr int MAX_FLOATS = 40960;
constexpr int THREADS = 128;
// quads contracted together (acc[QC] in registers): 5 takes the 5-quad
// windows of the rank-9/10 linear forms in one chunk; the fastest of 3-8
// on the flagship and the multiprobe joint (fused_ab.py, PERF.md)
constexpr int QC = 5;
// output-rank quads of a TT step accumulated together (acc[RC]): 8 was 7%
// faster than 4 and 10% faster than 2 on the w0wacdm flagship (fused_ab.py)
constexpr int RC = 8;

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
constexpr int H_BOND = 31;

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
constexpr int F_RD_IDX = 7;
constexpr int F_RD = 8;
constexpr int F_J = 9;
constexpr int F_MAG_IDX = 10;
constexpr int F_OFFSET = 11;
constexpr int F_H0REF = 12;
constexpr int F_GREF0 = 13;
constexpr int F_GREF1 = 14;
constexpr int F_QREF0 = 15;
constexpr int F_QREF1 = 16;
constexpr int F_S00 = 17;
constexpr int F_S01 = 18;
constexpr int F_S10 = 19;
constexpr int F_S11 = 20;
constexpr int F_F_IDX = 21;
constexpr int F_POW = 22;
constexpr int F_LN_CONST = 23;
constexpr int F_LN_COEF = 24;
constexpr int F_K = 25;
constexpr int F_I_AMP = 26;
constexpr int F_I_OFF = 27;
constexpr int F_I_S = 28;

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
constexpr int C_NODES = 20;

constexpr float C_KM_S = 299792.458f;
constexpr float OR_REF = 2e-4f;
constexpr float PI = 3.14159265358979f;

// E(z) with radiation; o_r = 0 gives the radiation-free E exactly. SPLIT:
// w0wacdm (CPL), else the flat lcdm (0), wcdm (1) and wzcdm (2) families
template <bool SPLIT>
__device__ __forceinline__ float e_of_z(float z, float om, float o_r, float w0, float wa,
                                        int model) {
  const float opz = 1.0f + z;
  const float cubed = opz * opz * opz;
  float rho = 1.0f;
  if constexpr (SPLIT) {  // up to ~1e27 at z* for s = w0 + wa near 2, inside f32
    rho = expf(3.0f * (1.0f + w0 + wa) * logf(opz) - 3.0f * wa * z / opz);
  } else if (model == 1) {
    rho = expf(3.0f * (1.0f + w0) * logf(opz));
  } else if (model == 2) {
    rho = expf(2.0f * (1.0f + w0) * logf(2.0f * cubed / (1.0f + cubed)));
  }
  const float ode = 1.0f - om - o_r;
  return sqrtf(o_r * cubed * opz + om * cubed + ode * rho);
}

// barycentric weights of x on one axis, projected on the Tucker factor
// u [n, r]: wp[j] = sum_m u[m, j] w_m, stored at wp_out[j * THREADS]
__device__ void project_axis(float x, const float* nodes, const float* bw, const float* u,
                             int n, int r, float* wp_out) {
  float sum = 0.0f;
  int n_near = 0;
  for (int m = 0; m < n; ++m) {
    const float d = x - nodes[m];
    if (fabsf(d) < 1e-14f) {
      ++n_near;
    } else {
      sum += bw[m] / d;
    }
  }
  float wp[MAX_RANK];
#pragma unroll
  for (int j = 0; j < MAX_RANK; ++j) wp[j] = 0.0f;
  for (int m = 0; m < n; ++m) {
    const float d = x - nodes[m];
    const bool near = fabsf(d) < 1e-14f;
    const float wm = n_near > 0 ? (near ? 1.0f : 0.0f) : (bw[m] / d) / sum;
    const float* um = u + m * r;
#pragma unroll
    for (int j = 0; j < MAX_RANK; ++j)
      if (j < r) wp[j] = fmaf(um[j], wm, wp[j]);
  }
#pragma unroll
  for (int j = 0; j < MAX_RANK; ++j)
    if (j < r) wp_out[j * THREADS] = wp[j];
}

// the quads [q0, q0 + n) of the coefficient vector, QC at a time:
// a[q] = sum_jk (wp1[j] wp2[k]) core[j, k, q], the product of the two
// projections formed once per (j, k) and chunk (the core is [r1][r2][nq]
// float4s, so a chunk's loads lie together at compile-time offsets);
// consume(i, a[q0 + i]) then takes each quad of the chunk in order. wp1 and
// wp2 are the thread's slices of shared memory, at [j * THREADS].
template <typename Consume>
__device__ __forceinline__ void contract_window(const float4* core, int nq, int q0, int n, int r1,
                                                int r2, const float* wp1, const float* wp2,
                                                Consume&& consume) {
  for (int c0 = 0; c0 < n; c0 += QC) {
    const int nc = min(QC, n - c0);
    float4 acc[QC];
#pragma unroll
    for (int c = 0; c < QC; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < r1; ++j) {
      const float w1 = wp1[j * THREADS];
      const float4* row = core + j * r2 * nq + q0 + c0;
      for (int k = 0; k < r2; ++k, row += nq) {
        const float cw = w1 * wp2[k * THREADS];
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

  // r_s(z*) = int_0^{a*} c da / (a^2 H sqrt(3 (1 + Rb a))), GL in a
  const float rb = 3.0f * wb / c[C_OG4];
  const float a_end = 1.0f / (1.0f + zs);
  float rs = 0.0f;
  for (int i = 0; i < n_rs; ++i) {
    const float a = a_end * t_rs[i];
    const float ez = e_of_z<SPLIT>(1.0f / a - 1.0f, om, o_r, w0, wa, model);
    const float integ = C_KM_S / (a * a * ez * sqrtf(3.0f * (1.0f + rb * a)));
    rs += integ * (a_end * w_rs[i]);
  }
  rs = rs / h0;

  // D_C(z*) = int_{ln a*}^0 c du / (a H), GL in ln a
  const float u0 = logf(1.0f / (1.0f + zs));
  float dm = 0.0f;
  for (int i = 0; i < n_dc; ++i) {
    const float a = expf(u0 * (1.0f - t_dc[i]));
    const float ez = e_of_z<SPLIT>(1.0f / a - 1.0f, om, o_r, w0, wa, model);
    dm += C_KM_S / (a * ez) * (-u0 * w_dc[i]);
  }
  dm = dm / h0;

  float o0, o1, o2;
  const int obs = static_cast<int>(c[C_OBS]);
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

// one tensor-train step: v_out[r] = sum_n w[n] sum_p v_in[p] G[n][p][r] for
// the nq output quads of r, where w are the barycentric weights of x on the
// n nodes (a one-hot within 1e-14 of a node), recomputed from bw/diff per
// chunk of RC quads so that they are never stored. G is [n][rin][4 nq] in
// device memory, read as float4 through the read-only path. v_in and v_out
// are the thread's slices of shared memory, at [p * THREADS].
__device__ __forceinline__ void tt_step(const float4* __restrict__ g, int nq, int rin, float x,
                                        const float* nodes, const float* bw, int n,
                                        const float* v_in, float* v_out) {
  float sum = 0.0f;
  int n_near = 0;
  for (int m = 0; m < n; ++m) {
    const float d = x - nodes[m];
    if (fabsf(d) < 1e-14f) {
      ++n_near;
    } else {
      sum += bw[m] / d;
    }
  }
  for (int q0 = 0; q0 < nq; q0 += RC) {
    const int nc = min(RC, nq - q0);
    float4 acc[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int m = 0; m < n; ++m) {
      const float d = x - nodes[m];
      const bool near = fabsf(d) < 1e-14f;
      const float wm = n_near > 0 ? (near ? 1.0f : 0.0f) : (bw[m] / d) / sum;
      const float4* row = g + m * rin * nq + q0;
      for (int p = 0; p < rin; ++p, row += nq) {
        const float cw = wm * v_in[p * THREADS];
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          if (c < nc) {
            const float4 v = __ldg(row + c);
            acc[c].x = fmaf(cw, v.x, acc[c].x);
            acc[c].y = fmaf(cw, v.y, acc[c].y);
            acc[c].z = fmaf(cw, v.z, acc[c].z);
            acc[c].w = fmaf(cw, v.w, acc[c].w);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c < nc) {
        float* o = v_out + 4 * (q0 + c) * THREADS;
        o[0] = acc[c].x;
        o[THREADS] = acc[c].y;
        o[2 * THREADS] = acc[c].z;
        o[3 * THREADS] = acc[c].w;
      }
    }
  }
}

// the emulated terms: chi2 and log_norm of each form, its window of the
// coefficient vector contracted by window(q0, nq, consume)
template <typename Window>
__device__ __forceinline__ void eval_forms(const float* s, const float* forms, int n_forms,
                                           const float* th, float h0, float t, float& chi2,
                                           float& log_norm, Window&& window) {
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
        const int rd_idx = static_cast<int>(F[F_RD_IDX]);
        const float rd = rd_idx >= 0 ? th[rd_idx] : F[F_RD];
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
      // rows: d_ref [K], sigma^2 [K], scale B_t [2 fnq][K]
      const int K = static_cast<int>(F[F_K]);
      const float* bt = rows + 2 * K;
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
          if (k < K) dmu[k] = fmaf(a1, b1[k], fmaf(a0, b0[k], dmu[k]));
      });
      const float sc = th[static_cast<int>(F[F_I_S])];
      const float s2 = sc * sc;
      const float off = th[static_cast<int>(F[F_I_OFF])];
      float log_sum = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (k < K) {
          const float var = rows[K + k] + s2;
          const float d = rows[k] - dmu[k] - off;
          fchi += d * d / var;
          log_sum += logf(var);
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

// SPLIT: the split w0wacdm grid, a TT sweep per walker over ``tt``;
// otherwise the native grid's Tucker core in shared memory. ``stride``:
// floats of each of the two per-thread scratch slices.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
fused_log_prob_kernel(const float* __restrict__ consts, int n_consts,
                      const float* __restrict__ tt, int stride,
                      const float* __restrict__ theta, float* __restrict__ out,
                      long long W, int D) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < n_consts; i += THREADS) s[i] = consts[i];
  __syncthreads();

  const int tid = threadIdx.x;
  const long long w = static_cast<long long>(blockIdx.x) * THREADS + tid;
  if (w >= W) return;  // the ragged last block; no barrier follows
  const float* th = theta + w * D;
  float* s_wp1 = s + ((n_consts + 3) & ~3);  // [stride][THREADS]
  float* s_wp2 = s_wp1 + (SPLIT ? stride : MAX_RANK) * THREADS;

  // 1. derived parameters
  const int model = static_cast<int>(s[H_MODEL]);
  const int i_h0 = static_cast<int>(s[H_I_H0]);
  const float h0 = i_h0 >= 0 ? th[i_h0] * s[H_H0_SCALE] : 0.0f;
  const float om = th[static_cast<int>(s[H_I_OM])];
  const int i_w0 = static_cast<int>(s[H_I_W0]);
  const float w0 = i_w0 >= 0 ? th[i_w0] : 0.0f;
  const float wa = SPLIT ? th[static_cast<int>(s[H_I_WA])] : 0.0f;
  const float hh = h0 / 100.0f;
  const float o_r = s[H_ORH2] != 0.0f ? s[H_ORH2] / (hh * hh) : 0.0f;
  const float t = o_r / OR_REF;
  const int n_forms = static_cast<int>(s[H_NFORMS]);
  float chi2 = 0.0f;
  float log_norm = 0.0f;

  if constexpr (SPLIT) {
    // 2. the walker's half, its TT sweep into the thread's slices
    const float sv = w0 + wa;
    const float* hb = s + static_cast<int>(s[H_OFF_HALVES]) + (sv <= 0.0f ? 0 : HALF_STRIDE);
    const float* bw = s + static_cast<int>(s[H_OFF_BW1]);
    float* va = s_wp1 + tid;
    float* vb = s_wp2 + tid;
    const float* v_in = hb + T_ONE;  // the first core's input: 1
    int rin = 1;
    for (int i = 0; i < 3; ++i) {
      const int r = static_cast<int>(hb[T_R1 + i]);
      const int axis = static_cast<int>(hb[T_PERM0 + i]);  // 0 Om, 1 wa, 2 s
      float* v_out = (i == 1) ? vb : va;
      tt_step(reinterpret_cast<const float4*>(tt + static_cast<int>(hb[T_G0 + i])),
              (r + 3) >> 2, rin, axis == 0 ? om : (axis == 1 ? wa : sv),
              s + static_cast<int>(hb[T_AX0 + i]), bw, static_cast<int>(hb[T_N0 + i]), v_in,
              v_out);
      v_in = v_out;
      rin = r;
    }
    // 3. the emulated terms, each window a = v^T tail over its quads
    const float4* tail = reinterpret_cast<const float4*>(tt + static_cast<int>(hb[T_TAIL]));
    const int nq = static_cast<int>(hb[T_NQ]);
    const int r3 = static_cast<int>(hb[T_R3]);
    const float* one = hb + T_ONE;
    eval_forms(s, s + static_cast<int>(hb[T_OFF_FORMS]), n_forms, th, h0, t, chi2, log_norm,
               [&](int q0, int n, auto&& consume) {
                 contract_window(tail, nq, q0, n, r3, 1, va, one, consume);
               });
  } else {
    // 2. barycentric weights folded into the factor projections
    const int r1 = static_cast<int>(s[H_R1]);
    const int r2 = static_cast<int>(s[H_R2]);
    project_axis(om, s + static_cast<int>(s[H_OFF_AX1]), s + static_cast<int>(s[H_OFF_BW1]),
                 s + static_cast<int>(s[H_OFF_U1]), static_cast<int>(s[H_N1]), r1, s_wp1 + tid);
    if (static_cast<int>(s[H_NAXES]) > 1) {
      project_axis(w0, s + static_cast<int>(s[H_OFF_AX2]), s + static_cast<int>(s[H_OFF_BW2]),
                   s + static_cast<int>(s[H_OFF_U2]), static_cast<int>(s[H_N2]), r2,
                   s_wp2 + tid);
    } else {
      s_wp2[tid] = 1.0f;  // one axis: core [r1, 1, R]
    }
    // 3. the emulated terms, each contracted and reduced over its own window
    const float4* core = reinterpret_cast<const float4*>(s + static_cast<int>(s[H_OFF_CORE]));
    const int nq = static_cast<int>(s[H_NQ]);
    const float* wp1 = s_wp1 + tid;
    const float* wp2 = s_wp2 + tid;
    eval_forms(s, s + static_cast<int>(s[H_OFF_FORMS]), n_forms, th, h0, t, chi2, log_norm,
               [&](int q0, int n, auto&& consume) {
                 contract_window(core, nq, q0, n, r1, r2, wp1, wp2, consume);
               });
  }

  // 4. the compressed CMB
  if (s[H_HAS_CMB] != 0.0f) {
    chi2 += cmb_chi2<SPLIT>(s + static_cast<int>(s[H_OFF_CMB]), th, h0, om, o_r, w0, wa,
                            model);
  }

  // 5. strict-interior bounds and the finite guard
  const float ll = -0.5f * chi2 + log_norm;
  bool ok = isfinite(ll);
  const float* lo = s + static_cast<int>(s[H_OFF_BOUNDS]);
  for (int d = 0; d < D; ++d) {
    const float v = th[d];
    ok = ok && lo[d] < v && v < lo[D + d];
  }
  out[w] = ok ? ll : -INFINITY;
}

template <bool SPLIT>
int launch(const float* consts, int n_consts, const float* tt, int stride, const float* theta,
           float* out, long long W, int D, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>((n_consts + 3) & ~3) * sizeof(float) +
                      2u * static_cast<size_t>(stride) * THREADS * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_log_prob_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (W + THREADS - 1) / THREADS;
  fused_log_prob_kernel<SPLIT><<<static_cast<unsigned int>(blocks), THREADS, smem, stream>>>(
      consts, n_consts, tt, stride, theta, out, W, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `stream` is
// a cudaStream_t. `tt` is the split grid's TT buffer (null on a native
// grid), `split` 1 for the split grid, `stride` the floats of each of the
// two per-thread scratch slices (MAX_RANK, or the largest padded bond).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for sizes above the compiled maxima. The caller
// guarantees W >= 1 and contiguous f32 inputs.
extern "C" int cosmax_fused_log_prob_f32(const float* consts, int n_consts, const float* tt,
                                         int split, int stride, const float* theta, float* out,
                                         long long W, int D, void* stream) {
  if (n_consts > MAX_FLOATS || D > MAX_DIM || D < 1 || (split != 0 && split != 1) ||
      stride < 1 || stride > (split ? MAX_BOND : MAX_RANK) || (split && tt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return split ? launch<true>(consts, n_consts, tt, stride, theta, out, W, D, st)
               : launch<false>(consts, n_consts, tt, stride, theta, out, W, D, st);
}
