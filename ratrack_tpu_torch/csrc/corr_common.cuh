// Shared pieces of the correlator kernels (correlator.cu, eval and train
// forward; correlator_train.cu, backward): the block shape of the
// backward's per-query launches, the WeightNet hidden layers, and the
// 3xTF32 tensor-core products with the cp.async copies that feed them.
#pragma once

#include "common.cuh"

namespace ratrack {
namespace corr {

constexpr int kC = 256;        // channel width of both stages
constexpr int kK = 16;         // neighbours per query
constexpr int kQ = 4;          // queries per block (backward head and tail)
constexpr int kRows = kQ * kK; // pair rows per block (backward head and tail)
constexpr int kThreads = 256;  // kQ * (kC / 4)
constexpr int kMaxMlp = 2;
constexpr int kWnHidden = 8;

__device__ __forceinline__ float leaky(float x) { return x > 0.0f ? x : 0.1f * x; }

// WeightNet hidden layers of one direction d: h1 = relu(d @ w0 + b0),
// h2 = relu(h1 @ w1 + b1), 3 -> 8 -> 8. The forward and the backward
// call the same code, so both see the same values.
__device__ __forceinline__ void weightnet_hidden(
    const float (&d)[3], const float* w0, const float* b0, const float* w1,
    const float* b1, float (&h1)[kWnHidden], float (&h2)[kWnHidden]) {
#pragma unroll
  for (int o = 0; o < kWnHidden; ++o) {
    float a = 0.0f;
#pragma unroll
    for (int t = 0; t < 3; ++t) a = fmaf(d[t], w0[t * kWnHidden + o], a);
    h1[o] = fmaxf(a + b0[o], 0.0f);
  }
#pragma unroll
  for (int o = 0; o < kWnHidden; ++o) {
    float a = 0.0f;
#pragma unroll
    for (int t = 0; t < kWnHidden; ++t) a = fmaf(h1[t], w1[t * kWnHidden + o], a);
    h2[o] = fmaxf(a + b1[o], 0.0f);
  }
}

// ---- 3xTF32 on the tensor cores ----
// A float32 operand x is split into x = hi + lo, both TF32; a product is
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b (the small terms first),
// accumulated in float32 by mma.sync m16n8k8: float32's accuracy, not
// TF32's three digits. Fragment layout of m16n8k8 (lane = 4 g + t):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4);
//   B (8 x 8): b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//     c3 (g + 8, 2t + 1).

__device__ __forceinline__ unsigned tf32_of(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo: the rounding remainder, exact in float32).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace corr
}  // namespace ratrack
