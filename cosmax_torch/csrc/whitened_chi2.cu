// Fused whitened-residual chi^2 for Hopper (sm_90a):
//
//     chi2[w] = || Linv @ delta[w] ||^2,   delta [W, N] f32, Linv [N, N] f32
//
// A row block of Linv's share of it (the data-sharded chi^2) is
// whitened_chi2_rows.cu's kernel.
//
// Replaces the TPU kernel cosmax/ops/pallas/chi2.py::whitened_chi2_pallas
// (the hot op of every dense Gaussian likelihood on the parity path:
// DES-SN5YR at N = 1829, the SN family at N = 580-1657, DESI BAO at N = 13).
//
// What bounds it on the card: Y = delta Linv^T on the lower triangle is
// W N (N + 1) useful flop (2.19e11 at (65,536, 1829)). In f32 FFMA that is
// 3.27 ms at 67 TFLOP/s; on the tensor cores in 3xTF32, three TF32
// products at 495 TFLOP/s, 1.33 ms. The bytes the function must move are
// delta once (480 MB at (65,536, 1829), 0.14 ms at 3.35 TB/s), Linv once
// and chi2. But a block that owns its walkers across all row tiles of Linv
// reads its delta tile once per row tile up to the diagonal: sum k_end / N
// = 8.35 passes at N = 1829 with row tiles of 128, ~4 GB, ~1.2 ms of HBM,
// next to the 3xTF32 bound; Linv (13.4 MB) stays in the 50 MB L2 and is
// read from there once per block, ~4 GB of L2 traffic. And each product
// costs instructions beside it: the two operands' hi/lo splits (5 integer
// and float operations a value), the loads that feed the fragments, the
// per-stage sums; with one 256-thread block an SM (the accumulators take
// ~230 registers), the instruction stream, not the tensor cores' rate,
// sets the pace (PERF.md).
//
// What the design does about it:
// * The product runs on the tensor cores, mma.sync m16n8k8 TF32 in 3xTF32
//   (tf32.cuh: x = hi + lo, a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
//   first), which keeps f32 accuracy where one TF32 pass keeps ~3 digits.
//   A is delta row-major (walkers x k) and B[k][r] = Linv[r][k], Linv
//   row-major read as the .col operand: both are k-contiguous. Each
//   fragment value is read from shared memory and split into hi/lo at
//   fragment load, in the k-step's registers, so the splits interleave
//   with the products (a separate pass over a stage into hi and lo tiles
//   for ldmatrix, behind its own barrier, was slower: the tensor cores
//   idled through it). Per k-step of 8 a warp forms its 16 tiles'
//   fragments, then runs the three passes over all 16 tiles, so that a
//   tile's next mma comes 16 mma after its last.
// * The tensor cores add in f32 with their addends aligned and truncated,
//   not rounded; over a whole K that bias grows with the cancellation
//   inside Linv delta, which correlated residuals bring (a single
//   accumulator over K ~ 2,000 put bao.desi at 1.4e-4 of max|logp| in the
//   fused kernel). So each stage of BK = 32 k is summed from zero in the
//   mma accumulators and added to f32 running sums by rounding FADDs.
// * One block owns BW = 128 walkers across all row tiles of Linv (BR = 128
//   rows), so chi2 never leaves the block: 8 warps, each a 64 x 32 tile of
//   Y (4 x 4 mma tiles) in registers. A finished row tile is squared and
//   summed in registers; at the end the 4 lanes and then the 4 warps that
//   share a walker are reduced by a fixed shuffle tree and a fixed order in
//   shared memory: no atomics, results bitwise the same from run to run.
// * Stages of delta and Linv come from global memory by cp.async into a
//   ring of STAGES slots, the next stages' loads in flight while one is
//   multiplied. N need not be a multiple of 4, so a row's k0 need not be
//   16-byte aligned: each row takes the 9 aligned 16-byte chunks that hold
//   its 32 values (a row's k0 then lies start & 3 floats into its first
//   chunk, a shift the fragment loads add), the bytes past the row's N-th
//   value and a missing row's zero-filled. Each thread's copies are set
//   up once per row tile: 4-byte copies, or 16-byte ones with their
//   addresses recomputed per stage, took more of the instruction stream.
// * Linv is lower-triangular (an inverted Cholesky factor), so a row tile
//   at row r0 reads k < min(r0 + BR, N) only: the stages wholly above the
//   diagonal are skipped; inside a stage the columns past the diagonal
//   multiply Linv's exact zeros.
// * Against delta's passes: successive row tiles run their stages in
//   opposite orders (k up, then k down), so the stages a row tile reads
//   first are the ones its block read last, while they are still in L2:
//   the L2 serves part of each pass, HBM the rest.
// * 64-bit offsets (W * N may exceed 2^31); walker tiles on blockIdx.x,
//   whose limit is 2^31 - 1. A NaN in delta[w] stays in chi2[w]: a row of
//   A only ever meets its own row of Y.

#include <cuda_runtime.h>

#include "tf32.cuh"  // split_tf32, mma_tf32

namespace {

constexpr int BW = 128;       // walkers a block (rows of A)
constexpr int BR = 128;       // Linv rows a row tile (columns of Y)
constexpr int BK = 32;        // k a stage: one slice of sums from zero
constexpr int STAGES = 3;     // slots of the cp.async ring
constexpr int THREADS = 256;  // 8 warps: 2 along the walkers x 4 along the rows
constexpr int WARPS = THREADS / 32;
constexpr int WM = 64;        // a warp's walkers
constexpr int WN = 32;        // a warp's rows of Y
constexpr int MT = WM / 16;   // its m-tiles of 16 walkers
constexpr int NT = WN / 8;    // its n-tiles of 8 rows
constexpr int ROWS = BW + BR;  // a stage's rows: delta's, then Linv's
// a staged row: the 9 aligned 16-byte chunks that hold a row's BK values
// wherever the row starts (N need not be a multiple of 4); its k0 lies
// start & 3 floats into the first
constexpr int CHUNKS = BK / 4 + 1;
constexpr int LDS = 4 * CHUNKS;
constexpr int SLOT_FLOATS = ROWS * LDS;  // a slot of the ring
static_assert(BW == 2 * WM && BR == 4 * WN && WARPS == 8, "warp grid");
static_assert(BK == 32 && ROWS == 32 * WARPS && BR % BK == 0, "a warp's 32 rows of a stage");

// 16 bytes from device memory into shared memory, asynchronously (L2 only);
// the bytes past `bytes` (0 to 16) zero-filled and not read
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the slice's sums into the running sums (rounding FADDs), and from zero again
__device__ __forceinline__ void fold(float (&acc)[MT][NT][4], float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] += part[i][j][e];
        part[i][j][e] = 0.0f;
      }
}

// The operands' shapes: delta [W, N], Linv [N, N]
struct Shape {
  long long W, N;
};

// where row `row` of a stage (delta's walker w0 + row, or Linv's row r0 +
// row - BW) starts, as a flat float index from its operand's pointer
// rounded down to 16 bytes, its length, and whether the row exists
struct StageRow {
  const float* base;  // the operand's pointer rounded down to 16 bytes
  long long start;    // the flat index of (row, k = 0)
  long long len;      // the row's values: N
  bool ok;
};

__device__ __forceinline__ StageRow stage_row(int row, const float* __restrict__ delta,
                                              const float* __restrict__ linv, const Shape& sh,
                                              long long w0, long long r0) {
  const bool is_a = row < BW;
  const float* p = is_a ? delta : linv;
  const int p0 = static_cast<int>((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
  const long long r = is_a ? w0 + row : r0 + row - BW;
  return StageRow{p - p0, p0 + r * sh.N, sh.N, r < (is_a ? sh.W : sh.N)};
}

// A thread's share of staging, set once per row tile: chunk lane % 8 of
// rows 32 warp + 4 j + lane / 8 (j < 8: a row's first 128 bytes from 8
// lanes together) and chunk 8 of row 32 warp + lane (warps 0-3 delta's rows,
// 4-7 Linv's), each row's aligned chunks counted from the one below its
// k = 0. Rows 4 apart lie 4 len floats apart, so the 8 rows share their
// offset into the first chunk. A stage at k0 copies from src + k0, the
// bytes past a row's len-th value (and a missing row's) zero-filled.
struct Copies {
  const float* src;   // row 32 warp + lane / 8, chunk lane % 8, at k = 0
  const float* src8;  // row 32 warp + lane, chunk 8
  long long step;     // 4 len
  int left, left8;    // a row's floats from its chunk on at k = 0: len + offset - 4 chunk
  int rows;           // how many of the 8 rows exist
};

__device__ __forceinline__ Copies prepare_copies(const float* __restrict__ delta,
                                                 const float* __restrict__ linv, const Shape& sh,
                                                 long long w0, long long r0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = lane & 7;
  const int row = 32 * warp + (lane >> 3);
  const StageRow sr = stage_row(row, delta, linv, sh, w0, r0);
  const StageRow s8 = stage_row(32 * warp + lane, delta, linv, sh, w0, r0);
  const long long first = row < BW ? w0 + row : r0 + row - BW;
  const long long last = row < BW ? sh.W : sh.N;
  const long long rows = min(max((last - first + 3) / 4, 0LL), 8LL);
  // N < 2^31 values a row
  return Copies{sr.base + (sr.start & ~3LL) + 4 * q, s8.base + (s8.start & ~3LL) + 4 * (CHUNKS - 1),
                4 * sr.len, static_cast<int>(sr.len + (sr.start & 3)) - 4 * q,
                s8.ok ? static_cast<int>(s8.len + (s8.start & 3)) - 4 * (CHUNKS - 1) : 0,
                static_cast<int>(rows)};
}

__device__ __forceinline__ void issue_stage(float* slot, const Copies& c, int k0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bytes = 4 * min(max(c.left - k0, 0), 4);
#pragma unroll
  for (int j = 0; j < CHUNKS - 1; ++j) {
    const int b = j < c.rows ? bytes : 0;
    cp_async16(slot + (32 * warp + 4 * j + (lane >> 3)) * LDS + 4 * (lane & 7),
               b > 0 ? c.src + j * c.step + k0 : c.src, b);
  }
  const int b8 = 4 * min(max(c.left8 - k0, 0), 4);
  cp_async16(slot + (32 * warp + lane) * LDS + 4 * (CHUNKS - 1), b8 > 0 ? c.src8 + k0 : c.src8,
             b8);
}

// the stages of row tile i, at rows from i BR: k < min((i + 1) BR, N)
__device__ __forceinline__ int tile_stages(int i, const Shape& sh) {
  const long long k_end = min(static_cast<long long>(i + 1) * BR, sh.N);
  return static_cast<int>((k_end + BK - 1) / BK);
}

// row tile i's s-th stage in its order (k up in even tiles, down in odd ones)
__device__ __forceinline__ int stage_k0(int i, int s, const Shape& sh) {
  return ((i & 1) ? tile_stages(i, sh) - 1 - s : s) * BK;
}

__global__ void __launch_bounds__(THREADS, 1)
whitened_chi2_kernel(const float* __restrict__ linv, const float* __restrict__ delta,
                     float* __restrict__ out, const Shape sh) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [STAGES][ROWS][LDS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the fragments' row (A, C) or column (B)
  const int t = lane & 3;   // ... and column (A) or row (B)
  const int wm0 = (warp & 1) * WM;   // the warp's walkers in the block
  const int wn0 = (warp >> 1) * WN;  // its rows in the row tile
  const long long w0 = static_cast<long long>(blockIdx.x) * BW;
  const int n_tiles = static_cast<int>((sh.N + BR - 1) / BR);
  // where this lane's fragment rows start in a slot, with their k0's offset
  // into the first chunk: A's rows g and g + 8 of each m-tile (delta's: the
  // same in every stage), B's row g of each n-tile (Linv's: set per tile)
  auto offset = [&](int row, long long r0) {
    return row * LDS + static_cast<int>(stage_row(row, delta, linv, sh, w0, r0).start & 3) + t;
  };
  int a_at[MT][2], b_at[NT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) a_at[i][h] = offset(wm0 + 16 * i + 8 * h + g, 0);

  // the producer's next stage: row tile p_tile, its p_s-th stage
  int p_tile = 0, p_s = 0;
  Copies copies;
  auto load_next = [&](int slot) {
    if (p_tile < n_tiles) {
      if (p_s == 0)
        copies = prepare_copies(delta, linv, sh, w0, static_cast<long long>(p_tile) * BR);
      issue_stage(ring + slot * SLOT_FLOATS, copies, stage_k0(p_tile, p_s, sh));
      if (++p_s == tile_stages(p_tile, sh)) {
        ++p_tile;
        p_s = 0;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_next(i);

  float acc[MT][NT][4], part[MT][NT][4], chi[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    chi[i][0] = chi[i][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = part[i][n][e] = 0.0f;
  }

  int slot = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int ns = tile_stages(tile, sh);
#pragma unroll
    for (int n = 0; n < NT; ++n) b_at[n] = offset(BW + wn0 + 8 * n + g, static_cast<long long>(tile) * BR);
    for (int s = 0; s < ns; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // this slot landed for all; the slot refilled next was read before
      load_next((slot + STAGES - 1) % STAGES);
      const float* st = ring + slot * SLOT_FLOATS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        // the k-step's fragments, split at load: B for the warp's 4
        // n-tiles (rows g, columns t and t + 4), A for its 4 m-tiles (rows
        // g and g + 8, columns t and t + 4)
        unsigned bhi[NT][2], blo[NT][2], ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          split_tf32(st[b_at[n] + kk], bhi[n][0], blo[n][0]);
          split_tf32(st[b_at[n] + kk + 4], bhi[n][1], blo[n][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          split_tf32(st[a_at[i][0] + kk], ahi[i][0], alo[i][0]);
          split_tf32(st[a_at[i][1] + kk], ahi[i][1], alo[i][1]);
          split_tf32(st[a_at[i][0] + kk + 4], ahi[i][2], alo[i][2]);
          split_tf32(st[a_at[i][1] + kk + 4], ahi[i][3], alo[i][3]);
        }
        // the three passes of 3xTF32, small terms first, each over the
        // warp's 16 tiles: an mma's next pass on its tile is 16 mma later
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(part[i][n], alo[i], bhi[n][0], bhi[n][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(part[i][n], ahi[i], blo[n][0], blo[n][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(part[i][n], ahi[i], bhi[n][0], bhi[n][1]);
      }
  const bool last = s == ns - 1;
      fold(acc, part);
      if (last) {
        // the row tile's Y squared into the walkers' sums; rows past N are 0
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            chi[i][0] = fmaf(acc[i][n][0], acc[i][n][0], chi[i][0]);
            chi[i][0] = fmaf(acc[i][n][1], acc[i][n][1], chi[i][0]);
            chi[i][1] = fmaf(acc[i][n][2], acc[i][n][2], chi[i][1]);
            chi[i][1] = fmaf(acc[i][n][3], acc[i][n][3], chi[i][1]);
            acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.0f;
          }
      }
      slot = (slot + 1) % STAGES;
    }
  }

  // the 4 lanes of a row (t = 0..3) by a fixed xor tree, then the 4 warps
  // along the rows in a fixed order through shared memory
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = ring;  // [BR / WN][BW]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = chi[i][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) red[(warp >> 1) * BW + wm0 + 16 * i + 8 * h + g] = v;
    }
  __syncthreads();
  if (tid < BW && w0 + tid < sh.W) {
    float v = red[tid];
#pragma unroll
    for (int k = 1; k < BR / WN; ++k) v += red[k * BW + tid];
    out[w0 + tid] = v;
  }
}

constexpr size_t SMEM_BYTES = STAGES * SLOT_FLOATS * sizeof(float);
static_assert((BR / WN) * BW <= STAGES * SLOT_FLOATS, "the reduction reuses the ring");


}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `stream`
// is a cudaStream_t. Returns cudaGetLastError() after the launch (0 on
// success). The caller guarantees W >= 1, N >= 1, contiguous f32 inputs.
extern "C" int cosmax_whitened_chi2_f32(const float* linv, const float* delta,
                                        float* out, long long W, long long N,
                                        void* stream) {
  const Shape sh{W, N};
  const cudaError_t err = cudaFuncSetAttribute(
      whitened_chi2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (sh.W + BW - 1) / BW;
  whitened_chi2_kernel<<<static_cast<unsigned int>(blocks), THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(linv, delta, out, sh);
  return static_cast<int>(cudaGetLastError());
}
