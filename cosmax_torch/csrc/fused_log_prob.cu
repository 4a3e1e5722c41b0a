// Fused fast log-prob for Hopper (sm_90a): logp[W] for walkers theta[W, D]
// of a fast preset (get_preset(..., fast=True)), the whole joint in one
// launch.
//
// Replaces the TPU kernel cosmax/ops/pallas/megakernel.py::blocked_log_prob,
// which replays the traced log-prob of a walker block inside one
// pallas_call with every constant resident in VMEM. This kernel is not a
// replayer: it is the bundled fast log-prob written out by hand. Per walker:
//   1. H0 and Or from theta (Or = orh2 / h^2, or 0 without radiation);
//   2. barycentric weights on each Chebyshev axis (a one-hot within 1e-14
//      of a node), folded straight into the Tucker factor projections
//      wp_i = U_i^T w_i: a second pass recomputes bw/diff, so the node
//      weights are never stored;
//   3. the core contraction a[R] = sum_jk wp1[j] wp2[k] core[j, k, :];
//   4. each linear-chi^2 form over its (base, Or-delta) column pairs:
//      e = beta s (a + Or/OR_REF a_d) - ba_ref, chi2 = c_ref - 2 e.v_ref
//      + e.e, plus g.S g - 2 g.q_ref + 2 e.P g where the form has nuisance
//      columns (cosmax/models/linear_chi2.py:547-567);
//   5. the compressed CMB: z* (Aizpuru A4, or Hu & Sugiyama), r_s by GL in
//      a and D_C by GL in ln a with the radiation-aware E(z), the three
//      observables and the 3 x 3 whitened chi^2;
//   6. -chi2/2, or -inf outside the strict interior of the f32 bounds or
//      where the sum is not finite.
// The constants come packed by cosmax_torch/ops/kernels/fused_log_prob.py
// (pack): a header of sizes and offsets (the H_* slots below, the same in
// both files) and a few thousand floats, 14 KB for the flagship.
//
// What bounds it on the card: per walker about 8.5k f32 operations for the
// flagship (6.5k in the contraction and the factor projections, 2k in the
// CMB quadratures, ~150 logf/expf/powf/sqrtf), against 28 bytes of HBM
// traffic (theta in, logp out). At 65,536 walkers that is ~8 us of FP32
// work at 67 TFLOP/s and ~0.5 us of HBM: the kernel is bound by
// operations (FFMA issue, the shared-memory loads that feed it, and the
// accurate transcendental sequences), never by memory.
//
// What the design does about it:
// * One thread per walker, 128 threads a block; the block first copies the
//   constant buffer into shared memory. Every contraction then reads one
//   shared address across the warp (a broadcast, no bank conflicts), and
//   the core as float4 (rows padded to 4 columns by the packer).
// * The coefficient vector a[MAX_RALL] stays in registers: all loops that
//   index it are unrolled to compile-time bounds with uniform guards. The
//   packer orders the core's columns as (base, delta) pairs per form so
//   that the form pass can index a[] at compile time too. The factor
//   projections go to a per-thread slice of shared memory ([j][thread],
//   conflict-free), read back by the thread that wrote them.
// * Accurate libm functions and IEEE division and square root (no
//   --use_fast_math): the CMB term divides theta* by its sigma ~ 2.6e-6.
// * The ragged last block is masked; each thread reads and writes only its
//   own walker, so a NaN walker stays in its row.
// Maxima such as MAX_RANK are compile-time; the packer refuses larger fits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_DIM = 16;
constexpr int MAX_NODES = 64;
constexpr int MAX_RANK = 16;
constexpr int MAX_RALL = 64;
constexpr int MAX_FORMS = 4;
constexpr int MAX_GL = 64;
constexpr int MAX_FLOATS = 40960;
constexpr int THREADS = 128;

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
constexpr int H_NPAIRS = 15;
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
constexpr int H_OFF_PAIRS = 26;
constexpr int H_OFF_FORMS = 27;
constexpr int H_OFF_CMB = 28;

// one (base, delta) column pair (PAIR)
constexpr int PAIR_STRIDE = 8;
constexpr int P_FORM = 0;
constexpr int P_BA = 1;
constexpr int P_V = 2;
constexpr int P_P0 = 3;
constexpr int P_P1 = 4;

// one linear-chi^2 form (FORM)
constexpr int FORM_STRIDE = 20;
constexpr int F_SCALE = 0;
constexpr int F_CREF = 1;
constexpr int F_BETA = 2;
constexpr int F_RD_IDX = 3;
constexpr int F_RD = 4;
constexpr int F_J = 5;
constexpr int F_MAG_IDX = 6;
constexpr int F_OFFSET = 7;
constexpr int F_H0REF = 8;
constexpr int F_GREF0 = 9;
constexpr int F_GREF1 = 10;
constexpr int F_QREF0 = 11;
constexpr int F_QREF1 = 12;
constexpr int F_S00 = 13;
constexpr int F_S01 = 14;
constexpr int F_S10 = 15;
constexpr int F_S11 = 16;

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

// E(z) of the flat lcdm (0), wcdm (1) and wzcdm (2) families with
// radiation; o_r = 0 gives the radiation-free E exactly
__device__ __forceinline__ float e_of_z(float z, float om, float o_r, float w0, int model) {
  const float opz = 1.0f + z;
  const float cubed = opz * opz * opz;
  float rho = 1.0f;
  if (model == 1) {
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

__device__ float cmb_chi2(const float* c, const float* th, float h0, float om, float o_r,
                          float w0, int model) {
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
    const float ez = e_of_z(1.0f / a - 1.0f, om, o_r, w0, model);
    const float integ = C_KM_S / (a * a * ez * sqrtf(3.0f * (1.0f + rb * a)));
    rs += integ * (a_end * w_rs[i]);
  }
  rs = rs / h0;

  // D_C(z*) = int_{ln a*}^0 c du / (a H), GL in ln a
  const float u0 = logf(1.0f / (1.0f + zs));
  float dm = 0.0f;
  for (int i = 0; i < n_dc; ++i) {
    const float a = expf(u0 * (1.0f - t_dc[i]));
    const float ez = e_of_z(1.0f / a - 1.0f, om, o_r, w0, model);
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

__global__ void __launch_bounds__(THREADS)
fused_log_prob_kernel(const float* __restrict__ consts, int n_consts,
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
  float* s_wp1 = s + ((n_consts + 3) & ~3);  // [MAX_RANK][THREADS]
  float* s_wp2 = s_wp1 + MAX_RANK * THREADS;

  // 1. derived parameters
  const int model = static_cast<int>(s[H_MODEL]);
  const float h0 = th[static_cast<int>(s[H_I_H0])] * s[H_H0_SCALE];
  const float om = th[static_cast<int>(s[H_I_OM])];
  const int i_w0 = static_cast<int>(s[H_I_W0]);
  const float w0 = i_w0 >= 0 ? th[i_w0] : 0.0f;
  const float hh = h0 / 100.0f;
  const float o_r = s[H_ORH2] / (hh * hh);  // 0 without radiation

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

  // 3. core contraction into registers
  float a[MAX_RALL];
#pragma unroll
  for (int i = 0; i < MAX_RALL; ++i) a[i] = 0.0f;
  const int nq = static_cast<int>(s[H_NQ]);
  const float4* core = reinterpret_cast<const float4*>(s + static_cast<int>(s[H_OFF_CORE]));
  for (int j = 0; j < r1; ++j) {
    const float w1 = s_wp1[j * THREADS + tid];
    for (int k = 0; k < r2; ++k) {
      const float cw = w1 * s_wp2[k * THREADS + tid];
      const float4* row = core + (j * r2 + k) * nq;
#pragma unroll
      for (int q = 0; q < MAX_RALL / 4; ++q) {
        if (q < nq) {
          const float4 v = row[q];
          a[4 * q] = fmaf(cw, v.x, a[4 * q]);
          a[4 * q + 1] = fmaf(cw, v.y, a[4 * q + 1]);
          a[4 * q + 2] = fmaf(cw, v.z, a[4 * q + 2]);
          a[4 * q + 3] = fmaf(cw, v.w, a[4 * q + 3]);
        }
      }
    }
  }

  // 4. the linear-chi^2 forms: per-form constants, then the column pairs
  const int n_forms = static_cast<int>(s[H_NFORMS]);
  const float* forms = s + static_cast<int>(s[H_OFF_FORMS]);
  float bs[MAX_FORMS], g0[MAX_FORMS], g1[MAX_FORMS];
  float chi2 = 0.0f;
#pragma unroll
  for (int f = 0; f < MAX_FORMS; ++f) {
    bs[f] = 0.0f;
    g0[f] = 0.0f;
    g1[f] = 0.0f;
    if (f < n_forms) {
      const float* F = forms + f * FORM_STRIDE;
      float beta = 1.0f;
      if (F[F_BETA] != 0.0f) {  // BAO: beta = c / (H0 r_d)
        const int rd_idx = static_cast<int>(F[F_RD_IDX]);
        const float rd = rd_idx >= 0 ? th[rd_idx] : F[F_RD];
        beta = C_KM_S / (h0 * rd);
      }
      const int J = static_cast<int>(F[F_J]);
      const float ga =
          J > 0 ? th[static_cast<int>(F[F_MAG_IDX])] - F[F_OFFSET] - F[F_GREF0] : 0.0f;
      const float gb = J > 1 ? -5.0f * log10f(h0 / F[F_H0REF]) - F[F_GREF1] : 0.0f;
      bs[f] = beta * F[F_SCALE];
      g0[f] = ga;
      g1[f] = gb;
      chi2 += F[F_CREF] + ga * (F[F_S00] * ga + F[F_S01] * gb) +
              gb * (F[F_S10] * ga + F[F_S11] * gb) - 2.0f * (ga * F[F_QREF0] + gb * F[F_QREF1]);
    }
  }
  const float t = o_r / OR_REF;
  const int n_pairs = static_cast<int>(s[H_NPAIRS]);
  const float* pairs = s + static_cast<int>(s[H_OFF_PAIRS]);
#pragma unroll
  for (int p = 0; p < MAX_RALL / 2; ++p) {
    if (p < n_pairs) {
      const float* pr = pairs + p * PAIR_STRIDE;
      const int fid = static_cast<int>(pr[P_FORM]);
      float b = bs[0], ga = g0[0], gb = g1[0];
#pragma unroll
      for (int f = 1; f < MAX_FORMS; ++f) {
        if (fid == f) {
          b = bs[f];
          ga = g0[f];
          gb = g1[f];
        }
      }
      const float e = b * (a[2 * p] + t * a[2 * p + 1]) - pr[P_BA];
      const float pg = pr[P_P0] * ga + pr[P_P1] * gb;
      chi2 += e * (e - 2.0f * pr[P_V] + 2.0f * pg);
    }
  }

  // 5. the compressed CMB
  if (s[H_HAS_CMB] != 0.0f) {
    chi2 += cmb_chi2(s + static_cast<int>(s[H_OFF_CMB]), th, h0, om, o_r, w0, model);
  }

  // 6. strict-interior bounds and the finite guard
  const float ll = -0.5f * chi2;
  bool ok = isfinite(ll);
  const float* lo = s + static_cast<int>(s[H_OFF_BOUNDS]);
  for (int d = 0; d < D; ++d) {
    const float v = th[d];
    ok = ok && lo[d] < v && v < lo[D + d];
  }
  out[w] = ok ? ll : -INFINITY;
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `stream` is
// a cudaStream_t. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for sizes above the compiled maxima.
// The caller guarantees W >= 1 and contiguous f32 inputs.
extern "C" int cosmax_fused_log_prob_f32(const float* consts, int n_consts, const float* theta,
                                         float* out, long long W, int D, void* stream) {
  if (n_consts > MAX_FLOATS || D > MAX_DIM || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>((n_consts + 3) & ~3) * sizeof(float) +
                      2u * MAX_RANK * THREADS * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_log_prob_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (W + THREADS - 1) / THREADS;
  fused_log_prob_kernel<<<static_cast<unsigned int>(blocks), THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(consts, n_consts, theta, out,
                                                               W, D);
  return static_cast<int>(cudaGetLastError());
}
