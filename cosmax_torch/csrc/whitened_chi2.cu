// Fused whitened-residual chi^2 for Hopper (sm_90a):
//
//     chi2[w] = || Linv @ delta[w] ||^2,   delta [W, N] f32, Linv [N, N] f32
//
// Replaces the TPU kernel cosmax/ops/pallas/chi2.py::whitened_chi2_pallas
// (the hot op of every dense Gaussian likelihood: DES-SN5YR at N = 1829,
// DESI BAO at N = 13).
//
// What bounds it on the card: per walker the product costs 2 N^2 FLOP
// (6.7 MFLOP at N = 1829), about half that once the zero upper triangle
// of Linv is skipped. Linv is 13.4 MB in f32 and stays resident in the
// 50 MB L2; delta is streamed from HBM once (7.3 KB per walker). So the
// kernel is bound by f32 FMA issue (67 TFLOP/s on an H100 SXM) and by
// the shared-memory reads that feed it, not by HBM.
//
// What the design does about it:
// * One block owns BW = 128 walkers across ALL output rows. It loops
//   over row tiles of Linv (BR = 128 rows) and, inside, over K stages
//   (BK = 16) of delta and Linv staged in shared memory. Each thread keeps
//   an 8 x 8 register tile of the whitened product and reads its
//   operands as float4: 64 FMA per 4 shared loads. The next stage's
//   global loads are issued into registers before the current stage's
//   FMAs (two shared buffers, one barrier per stage). Two blocks fit an
//   SM (128 registers a thread, 33 KB of shared memory a block); with one
//   block per SM the same tiles ran 1.25-1.33x slower on an H100.
// * The whitened [W, N] array is never written: each finished row tile
//   is squared in registers and folded into per-walker partial sums, and
//   the block reduces those with a fixed warp-shuffle tree. No atomics
//   and no cross-block pass, so results are bitwise reproducible.
// * Linv is lower-triangular (the whitening operator is an inverted
//   Cholesky factor), so K stages wholly above the diagonal of a row
//   tile are skipped: ~N^2/2 instead of N^2 MACs per walker. Columns
//   past the diagonal inside a stage multiply Linv's exact zeros.
// * Accumulation is plain IEEE f32 FFMA (no tensor cores, no TF32).
// * 64-bit offsets (W * N may exceed 2^31); walker tiles on blockIdx.x,
//   whose limit is 2^31 - 1 (gridDim.y stops at 65,535).
// * Ragged W and N edges are masked in the loads (zeros) and the store,
//   instead of padding in memory. A NaN in delta[w] stays in chi2[w]:
//   each accumulator only ever mixes one walker's residuals.

#include <cuda_runtime.h>

namespace {

constexpr int BW = 128;       // walkers per block
constexpr int BR = 128;       // Linv rows per row tile
constexpr int BK = 16;        // reduction depth per shared-memory stage
constexpr int KPT = BK / 2;   // k values each thread stages per operand
constexpr int THREADS = 256;  // 16 x 16 threads, each an 8 x 8 micro-tile
constexpr int PAD = 4;        // keeps rows 16-byte aligned, stores conflict-free
constexpr int HALF = 64;      // micro-tile = two 4-wide strips, 64 apart

__device__ __forceinline__ void load_stage(const float* __restrict__ drow, bool w_ok,
                                           const float* __restrict__ lrow, bool r_ok,
                                           long long k, long long N, float pd[KPT],
                                           float pl[KPT]) {
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const bool k_ok = k + i < N;
    pd[i] = (w_ok && k_ok) ? drow[k + i] : 0.0f;
    pl[i] = (r_ok && k_ok) ? lrow[k + i] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
whitened_chi2_kernel(const float* __restrict__ linv,
                     const float* __restrict__ delta,
                     float* __restrict__ out,
                     long long W, long long N) {
  // k-major (transposed) tiles: s_d[buf][k][walker], s_l[buf][k][row]
  __shared__ __align__(16) float s_d[2][BK][BW + PAD];
  __shared__ __align__(16) float s_l[2][BK][BR + PAD];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // rows    tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid >> 4;  // walkers ty*4 + {0..3} and 64 + ty*4 + {0..3}
  // load mapping: each thread stages KPT consecutive k of one walker row
  // and of one Linv row (a warp covers 16 rows x BK contiguous floats)
  const int lr = tid >> 1;
  const int lk = (tid & 1) * KPT;
  const long long w0 = static_cast<long long>(blockIdx.x) * BW;
  const long long gw = w0 + lr;
  const bool w_ok = gw < W;
  const float* drow = delta + (w_ok ? gw : 0) * N;

  float chi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) chi[i] = 0.0f;

  for (long long r0 = 0; r0 < N; r0 += BR) {
    const long long gr = r0 + lr;
    const bool r_ok = gr < N;
    const float* lrow = linv + (r_ok ? gr : 0) * N;
    // Linv[r, k] == 0 for k > r: this row tile needs k < r0 + BR only
    const long long k_end = (r0 + BR < N) ? (r0 + BR) : N;
    const int n_stages = static_cast<int>((k_end + BK - 1) / BK);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float pd[KPT], pl[KPT];
    load_stage(drow, w_ok, lrow, r_ok, lk, N, pd, pl);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      s_d[0][lk + i][lr] = pd[i];
      s_l[0][lk + i][lr] = pl[i];
    }
    __syncthreads();

    for (int s = 0; s < n_stages; ++s) {
      const int cur = s & 1;
      const bool more = s + 1 < n_stages;
      if (more) load_stage(drow, w_ok, lrow, r_ok, (s + 1) * BK + lk, N, pd, pl);

#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&s_d[cur][k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&s_d[cur][k][HALF + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&s_l[cur][k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&s_l[cur][k][HALF + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }

      if (more) {
        // the other buffer was last read before the previous barrier
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          s_d[cur ^ 1][lk + i][lr] = pd[i];
          s_l[cur ^ 1][lk + i][lr] = pl[i];
        }
      }
      __syncthreads();
    }

    // square-and-reduce epilogue in registers; rows >= N hold exact zeros
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) chi[i] = fmaf(acc[i][j], acc[i][j], chi[i]);
  }

  // The 16 threads that share a walker strip are lanes tx = 0..15 of one
  // half-warp: a fixed xor tree sums them in the same order every run.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = chi[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const long long w = w0 + (i < 4 ? ty * 4 + i : HALF + ty * 4 + (i - 4));
    if (tx == 0 && w < W) out[w] = v;
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `stream`
// is a cudaStream_t. Returns cudaGetLastError() after the launch (0 on
// success). The caller guarantees W >= 1, N >= 1, contiguous f32 inputs.
extern "C" int cosmax_whitened_chi2_f32(const float* linv, const float* delta,
                                        float* out, long long W, long long N,
                                        void* stream) {
  const long long blocks = (W + BW - 1) / BW;
  whitened_chi2_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(linv, delta, out, W, N);
  return static_cast<int>(cudaGetLastError());
}
