// 3xTF32 on the tensor cores, shared by the port's kernels
// (fused_log_prob.cu, whitened_chi2.cu): an f32 operand x is split into
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and a product a b is
// taken as a_hi b_hi + a_hi b_lo + a_lo b_hi, which keeps f32 accuracy (one
// pass of TF32 keeps ~3 digits). The library's name hashes this header with
// each source that includes it (ops/kernels/build.py).
#pragma once

#include <cuda_runtime.h>

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits of cvt.rna.tf32.f32 for a finite x, in two integer
// operations (sm_90 has no such cvt; ptxas expands it into a sequence
// that also keeps infinities)
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to f32 accuracy: hi = tf32(x), lo = tf32(x - hi), as TF32
// bit patterns
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b on the tensor cores: a 16 x 8 (row-major fragment), b 8 x 8
// (column-major), c 16 x 8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
