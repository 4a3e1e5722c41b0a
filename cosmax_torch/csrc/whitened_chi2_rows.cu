// The row-block entry of the whitened-residual chi^2, for Hopper (sm_90a):
//
//     chi2_b[w] = sum_{r in [row0, row0 + rows)} (Linv[r, :ld] . delta[w, :ld])^2,
//
// ld = row0 + rows, the share of the rows [row0, row0 + rows) of Linv in
// chi2[w] = || Linv delta[w] ||^2. Each rank of a mesh that splits Linv's
// rows keeps its slab Linv[row0 : ld, : ld] (a lower-triangular row has no
// value past its diagonal) and the blocks' shares add up to chi^2 (the
// data-sharded chi^2 of cosmax_torch/parallel/mesh.py). The kernel reads
// the slab pre-split into TF32 halves (ops/kernels/whitened_chi2.py,
// ``split_rows``): [2][rows][ldp] f32, hi = tf32(x) and lo = x - hi, the row
// stride ldp padded to a multiple of LD_PAD floats.
//
// Replaces the TPU kernel cosmax/ops/pallas/chi2.py::whitened_chi2_pallas
// cut at a row boundary: each j step of its grid handles one row block of
// Linv and adds its share to the output, and cosmax/parallel/mesh.py's
// data-sharded chi^2 is that product split over the mesh's 'd' axis. The
// square chi^2 stays in whitened_chi2.cu.
//
// What bounds it on the card: the block's triangle is W (ld (ld + 1) -
// row0 (row0 + 1)) useful flop, three TF32 products at 495 TFLOP/s in
// 3xTF32 (0.33 ms for the last of four blocks at (65,536, 1829)); the
// bytes it must move are delta's first ld columns once (at most 0.14 ms).
// But a block that owns its walkers across the slab's row tiles reads its
// delta tile once a row tile, up to the diagonal (~1.9 passes on the last
// of four blocks, ~4.9 on the first), partly from the 50 MB L2.
//
// What the design does about it:
// * The products run on wgmma (m64n128k8 TF32), the only way to the tensor
//   cores' full rate, in 3xTF32: A is delta, taken from registers and split
//   into hi and lo there (tf32.cuh); B is the slab, read from shared memory
//   as its two pre-split halves, so no instruction splits it. The three
//   products a_lo b_hi, a_hi b_lo, a_hi b_hi run small terms first. The
//   tensor cores read lo's top 19 bits (its low 13 bits are not zero: lo =
//   x - hi exactly, so that hi + lo == x in the stored slab).
// * B comes by TMA: one thread of the producer warpgroup keeps a ring of
//   STAGES slots in flight, each a stage of BK = 32 k of a row tile's hi
//   and lo (one 3-D box of [2][BN][32] f32, a 128-byte row a tile row in
//   the 128-byte swizzle that wgmma's descriptor reads K-major); the slot
//   completes on its mbarrier. The tensor map is built once per split slab
//   by the host entry below and cached with it.
// * delta comes by cp.async, not TMA: its row stride (N floats; N = 1829,
//   1657, 1590) is no multiple of 16 bytes, which TMA refuses. The
//   producer warpgroup copies each row's 9 aligned 16-byte chunks that hold
//   its 32 values (the row's k0 lies start & 3 floats into the first), the
//   bytes past column ld and a missing walker's zero-filled, and arrives on
//   the same mbarrier when its copies land.
// * The tensor cores add in f32 with truncation: each stage of 32 k starts
//   from zero (scale-d = 0 on its first wgmma) and is added to f32 running
//   sums by rounding FADDs (sums from zero over half a stage erred no less
//   and ran slower). That is two accumulator sets of BN / 2
//   floats a thread; setmaxnreg gives the consumers CONSUMER_REGS
//   registers and the producer PRODUCER_REGS (ptxas allocates 168 a
//   thread, the most for 384 threads, and spills none).
// * Every row tile runs the one wgmma width n = BN: a block's trailing
//   tile of fewer rows reads the rows past the slab as the TMA's zeros,
//   which add nothing to chi^2. A wgmma as narrow as the trailing rows
//   (their count rounded up to 8) ran no faster: a block's time follows
//   its passes over delta, not the wgmma's n. The stages wholly above the
//   diagonal are skipped, counted from the tile's global row row0 + its
//   local row.
// * One block owns BW = 128 walkers (64 a consumer warpgroup) across all
//   the slab's row tiles, so chi^2 never leaves the block: a finished row
//   tile is squared and summed in registers, in f64 (a lane's long f32 sum
//   of squares was the kernel's largest error against f64 chi^2), then
//   the 4 lanes that share a walker by a fixed shuffle tree. No atomics:
//   the same bits from run to run. Successive row tiles run their stages
//   in opposite orders (k up, then down), so a tile first reads the delta
//   stages its block read last.
// * 64-bit offsets (W * N may exceed 2^31). A NaN in delta[w] stays in
//   chi2_b[w]: a row of A only ever meets its own row of Y.

#include <cuda.h>  // CUtensorMap and the encoder's types (the driver is reached through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tf32.cuh"  // split_tf32

namespace {

constexpr int BW = 128;        // walkers a block
constexpr int BN = 128;        // slab rows a row tile: the wgmma's n
constexpr int BK = 32;         // k a stage: one 128-byte swizzle row of f32 a tile row
constexpr int KSTEPS = BK / 8;  // wgmma k-steps of 8 a stage
constexpr int LD_PAD = 4;      // the split slab's row stride, a multiple of this many floats
constexpr int STAGES = 4;      // slots of the ring
constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 walkers each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int CONSUMER_REGS = 224;
constexpr int PRODUCER_REGS = 56;
constexpr int CHUNKS = BK / 4 + 1;  // a staged delta row: 9 aligned 16-byte chunks
constexpr int LDS = 4 * CHUNKS;
constexpr int B_TILE_BYTES = BN * BK * 4;           // hi or lo of a stage
constexpr int B_SLOT_BYTES = 2 * B_TILE_BYTES;      // the TMA box [2][BN][BK]
constexpr int A_SLOT_FLOATS = BW * LDS;
constexpr int SMEM_BYTES = 1024 + STAGES * (B_SLOT_BYTES + 4 * A_SLOT_FLOATS) + 2 * STAGES * 8;
static_assert(BK * 4 == 128, "a stage's row is one 128-byte swizzle row");
static_assert(LD_PAD * 4 == 16, "the TMA's row strides are multiples of 16 bytes");
static_assert(BW == 64 * CONSUMERS && BW == 128, "the producer's 4 warps copy 32 delta rows each");
static_assert(CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "the SM's registers");
static_assert(SMEM_BYTES <= 232448, "shared memory a block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// -- copies --------------------------------------------------------------------

// 16 bytes from device memory into shared memory, asynchronously (L2 only);
// the bytes past `bytes` (0 to 16) zero-filled and not read
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// the mbarrier's pending count drops by one when this thread's cp.async
// copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the box [2][BN][BK] of the split slab at (k0, local row r0) into `dst`,
// completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0,
                                         int r0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(r0), "r"(0)
      : "memory");
}

// -- wgmma -----------------------------------------------------------------------

// the descriptor of a K-major B tile in the 128-byte swizzle at `smem` (1024-
// byte aligned): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused (1); a k-step of 8 f32 further is +32 bytes (+2)
__device__ __forceinline__ uint64_t b_desc(const void* smem) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving a register's reads or writes across the
// asynchronous wgmma that owns it
__device__ __forceinline__ void fence_reg(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_reg(unsigned& x) { asm volatile("" : "+r"(x)::"memory"); }

// d (+)= A B on the tensor cores, m64n128k8 TF32: A 64 x 8 from registers
// (a thread's rows g and g + 8 of its warp's 16, columns t and t + 4), B
// 8 x 128 K-major in shared memory; `accumulate` 0 starts from zero
__device__ __forceinline__ void wgmma_n128(float (&d)[BN / 2], const unsigned (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// one stage's products on a row tile: the three of 3xTF32 over the stage's
// k-steps, small terms first, the first starting the stage's sums from
// zero; the wait; the stage's sums into the running sums (rounding FADDs)
__device__ __forceinline__ void stage_products(float (&acc)[BN / 2], float (&part)[BN / 2],
                                               unsigned (&ahi)[KSTEPS][4],
                                               unsigned (&alo)[KSTEPS][4], uint64_t bhi,
                                               uint64_t blo) {
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) fence_reg(part[e]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_n128(part, alo[kk], bhi + 2 * kk, kk > 0);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_n128(part, ahi[kk], blo + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_n128(part, ahi[kk], bhi + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    fence_reg(part[e]);
    acc[e] += part[e];
  }
}

// a consumer thread's view of the ring, and the slot it reads next
struct Ring {
  const unsigned char* b;  // [STAGES][2][BN][BK], the slab's hi and lo
  const float* a;          // [STAGES][BW][LDS], delta
  uint64_t* full;
  uint64_t* empty;
  int slot;
  unsigned phase;
};

// a consumer warpgroup's walk over the ns stages of a row tile, its
// products summed into acc; a_at0 and a_at1 are where the thread's A values
// start in a slot
__device__ __forceinline__ void tile_products(Ring& ring, int ns, int a_at0, int a_at1, int lane,
                                              float (&acc)[BN / 2], float (&part)[BN / 2]) {
  for (int s = 0; s < ns; ++s) {
    mbar_wait(ring.full + ring.slot, ring.phase);
    const float* st = ring.a + ring.slot * A_SLOT_FLOATS;
    unsigned ahi[KSTEPS][4], alo[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      split_tf32(st[a_at0 + 8 * kk], ahi[kk][0], alo[kk][0]);
      split_tf32(st[a_at1 + 8 * kk], ahi[kk][1], alo[kk][1]);
      split_tf32(st[a_at0 + 8 * kk + 4], ahi[kk][2], alo[kk][2]);
      split_tf32(st[a_at1 + 8 * kk + 4], ahi[kk][3], alo[kk][3]);
    }
    const uint64_t bhi = b_desc(ring.b + ring.slot * B_SLOT_BYTES);
    stage_products(acc, part, ahi, alo, bhi, bhi + (B_TILE_BYTES >> 4));
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_reg(ahi[kk][e]);
        fence_reg(alo[kk][e]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + ring.slot);  // this warp is done with the slot
    if (++ring.slot == STAGES) {
      ring.slot = 0;
      ring.phase ^= 1;
    }
  }
}

// -- the block's schedule ----------------------------------------------------------

// delta [W, N]; the slab: Linv's rows [row0, row0 + rows), columns [0, row0 + rows)
struct Shape {
  long long W, N, row0, rows;
};

// the stages of row tile i: its last row is global row g1 - 1, so k < g1
__device__ __forceinline__ int tile_stages(int i, const Shape& sh) {
  const long long g1 = sh.row0 + min(static_cast<long long>(i + 1) * BN, sh.rows);
  return static_cast<int>((g1 + BK - 1) / BK);
}

// row tile i's s-th stage of ns in its order (k up in even tiles, down in odd ones)
__device__ __forceinline__ int stage_k0(int i, int s, int ns) {
  return ((i & 1) ? ns - 1 - s : s) * BK;
}

// the float offset of delta's 16-byte-aligned base below delta
__device__ __forceinline__ int delta_p0(const float* delta) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(delta) >> 2) & 3);
}

// A producer thread's share of a stage's delta rows, set once: chunk
// lane % 8 of rows 32 warp + 4 j + lane / 8 (j < 8: a row's first 128 bytes
// from 8 lanes together) and chunk 8 of row 32 warp + lane, each row's
// aligned chunks counted from the one below its k = 0. Rows 4 apart lie 4 N
// floats apart, so the 8 rows share their offset into the first chunk. A
// stage at k0 copies from src + k0; the bytes past column ld of a row, and a
// missing walker's, are zero-filled.
struct Copies {
  const float* src;   // row 32 warp + lane / 8, chunk lane % 8, at k = 0
  const float* src8;  // row 32 warp + lane, chunk 8
  long long step;     // 4 N
  int left, left8;    // a row's floats from its chunk on to column ld, at k = 0
  int rows;           // how many of the 8 rows exist
};

__device__ __forceinline__ Copies prepare_copies(const float* __restrict__ delta, const Shape& sh,
                                                 long long w0, int p) {
  const int warp = p >> 5;
  const int lane = p & 31;
  const int q = lane & 7;
  const int p0 = delta_p0(delta);
  const float* base = delta - p0;
  const long long ld = sh.row0 + sh.rows;
  const long long w = w0 + 32 * warp + (lane >> 3);
  const long long w8 = w0 + 32 * warp + lane;
  const long long start = p0 + w * sh.N, start8 = p0 + w8 * sh.N;
  const long long rows = min(max((sh.W - w + 3) / 4, 0LL), 8LL);
  // ld < 2^31 values a row
  return Copies{base + (start & ~3LL) + 4 * q, base + (start8 & ~3LL) + 4 * (CHUNKS - 1), 4 * sh.N,
                static_cast<int>(ld + (start & 3)) - 4 * q,
                w8 < sh.W ? static_cast<int>(ld + (start8 & 3)) - 4 * (CHUNKS - 1) : 0,
                static_cast<int>(rows)};
}

__device__ __forceinline__ void issue_stage(float* slot, const Copies& c, int p, int k0) {
  const int warp = p >> 5;
  const int lane = p & 31;
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

// -- the kernel ----------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
whitened_chi2_rows_kernel(const __grid_constant__ CUtensorMap slab_map,
                          const float* __restrict__ delta, float* __restrict__ out,
                          const Shape sh) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled B tiles want 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* b_ring = smem;                                              // [STAGES][2][BN][BK]
  float* a_ring = reinterpret_cast<float*>(smem + STAGES * B_SLOT_BYTES);    // [STAGES][BW][LDS]
  uint64_t* full = reinterpret_cast<uint64_t*>(a_ring + STAGES * A_SLOT_FLOATS);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x >> 7;
  const long long w0 = static_cast<long long>(blockIdx.x) * BW;
  const int n_tiles = static_cast<int>((sh.rows + BN - 1) / BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 128 + 1);         // the producers' copies and the TMA's bytes
      mbar_init(empty + s, 4 * CONSUMERS);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // the producer warpgroup: each thread copies its delta rows' chunks, one
    // thread issues the slab's TMA box
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int p = threadIdx.x - 128 * CONSUMERS;
    const Copies copies = prepare_copies(delta, sh, w0, p);
    int slot = 0;
    unsigned phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int ns = tile_stages(i, sh);
      for (int s = 0; s < ns; ++s) {
        const int k0 = stage_k0(i, s, ns);
        mbar_wait(empty + slot, phase ^ 1);  // passes at once on the ring's first round
        if (p == 0) {
          mbar_expect_tx(full + slot, B_SLOT_BYTES);
          tma_load(b_ring + slot * B_SLOT_BYTES, &slab_map, full + slot, k0, i * BN);
        }
        issue_stage(a_ring + slot * A_SLOT_FLOATS, copies, p, k0);
        cp_async_arrive(full + slot);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // a consumer warpgroup: walkers 64 wg + [0, 64) of the block, each warp 16
  // of them, a thread's rows g and g + 8 of its warp's
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;
  const int p0 = delta_p0(delta);
  // where the thread's A values start in a slot: the row, its k0's offset
  // into the first chunk, column t
  const int a_at0 = r * LDS + static_cast<int>((p0 + (w0 + r) * sh.N) & 3) + t;
  const int a_at1 = (r + 8) * LDS + static_cast<int>((p0 + (w0 + r + 8) * sh.N) & 3) + t;

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = part[e] = 0.0f;
  double chi0 = 0.0, chi1 = 0.0;  // the walkers' sums of squares, in f64
  Ring ring{b_ring, a_ring, full, empty, 0, 0};
  for (int i = 0; i < n_tiles; ++i) {
    tile_products(ring, tile_stages(i, sh), a_at0, a_at1, lane, acc, part);
    // the row tile's Y squared into the walkers' sums: row g from
    // acc[4 j], acc[4 j + 1], row g + 8 from acc[4 j + 2], acc[4 j + 3]
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const double y0 = acc[4 * j], y1 = acc[4 * j + 1], y2 = acc[4 * j + 2], y3 = acc[4 * j + 3];
      chi0 = __fma_rn(y0, y0, chi0);
      chi0 = __fma_rn(y1, y1, chi0);
      chi1 = __fma_rn(y2, y2, chi1);
      chi1 = __fma_rn(y3, y3, chi1);
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
  }
  // the 4 lanes of a row (t = 0..3) by a fixed xor tree
  chi0 += __shfl_xor_sync(0xffffffffu, chi0, 1);
  chi0 += __shfl_xor_sync(0xffffffffu, chi0, 2);
  chi1 += __shfl_xor_sync(0xffffffffu, chi1, 1);
  chi1 += __shfl_xor_sync(0xffffffffu, chi1, 2);
  if (t == 0) {
    if (w0 + r < sh.W) out[w0 + r] = static_cast<float>(chi0);
    if (w0 + r + 8 < sh.W) out[w0 + r + 8] = static_cast<float>(chi1);
  }
}

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers unless
// said; `stream` is a cudaStream_t.

// The tensor map of a split slab `split` [2][rows][ldp] f32 (hi, lo; ldp a
// multiple of LD_PAD, the columns past ld zero): a box of [2][BN][BK] at
// (k0, row), the columns past ld and the rows past `rows` read as zeros,
// written to `map` (128 bytes of host memory). Returns 0, -1 when the
// driver has no cuTensorMapEncodeTiled, else its CUresult.
extern "C" int cosmax_chi2_rows_tensor_map(void* map, const float* split, long long rows,
                                           long long ld, long long ldp) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  CUtensorMap m;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldp) * 4,
                                 static_cast<cuuint64_t>(rows * ldp) * 4};
  const cuuint32_t box[3] = {BK, BN, 2};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(&m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(split),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(res);
  memcpy(map, &m, sizeof m);
  return 0;
}

// The row block [row0, row0 + rows) of Linv's share of chi^2: `map` (host
// memory) the tensor map of its split slab from cosmax_chi2_rows_tensor_map;
// delta [W, N] f32 contiguous, out [W]. Returns cudaGetLastError() after the
// launch (0 on success). The caller guarantees W >= 1, rows >= 1, row0 >= 0,
// row0 + rows <= N.
extern "C" int cosmax_whitened_chi2_rows_f32(const void* map, const float* delta, float* out,
                                             long long W, long long N, long long row0,
                                             long long rows, void* stream) {
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  const cudaError_t err = cudaFuncSetAttribute(
      whitened_chi2_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (W + BW - 1) / BW;
  whitened_chi2_rows_kernel<<<static_cast<unsigned int>(blocks), THREADS, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(m, delta, out,
                                                                   Shape{W, N, row0, rows});
  return static_cast<int>(cudaGetLastError());
}
