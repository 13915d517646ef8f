// Shared helpers of the ratrack_tpu_torch kernels (sm_90a, float32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace ratrack {

constexpr unsigned kFullMask = 0xffffffffu;

// Operand types of the eval kernels' products (the JAX kernels'
// compute_dtype): float, or __nv_bfloat16, whose operands are rounded to
// bfloat16 (to nearest even) and held as float. A product of two such
// operands is exact in float32 (8-bit significands), and so in TF32.
template <typename Op>
constexpr bool kBf16 = std::is_same<Op, __nv_bfloat16>::value;

// x as an Op operand: itself for float, rounded to bfloat16 for bfloat16.
template <typename Op>
__device__ __forceinline__ float as_operand(float x) {
  if constexpr (kBf16<Op>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <typename Op>
__device__ __forceinline__ float4 as_operand(float4 v) {
  return make_float4(as_operand<Op>(v.x), as_operand<Op>(v.y),
                     as_operand<Op>(v.z), as_operand<Op>(v.w));
}
// Distance of a masked-out candidate, as in the JAX kernels (_BIG).
constexpr float kBig = 1e10f;

// |x|^2 as ((x0*x0 + x1*x1) + x2*x2), each op rounded on its own.
__device__ __forceinline__ float sq_norm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// The JAX kernels' expanded squared distance
//   max((|c|^2 + |x|^2) - 2 (c0 x0 + c1 x1 + c2 x2), 0)
// with every multiply and add rounded separately (no FMA contraction), so
// it equals, bit for bit, the plain torch version
// (ops/neighborhood.py::point_distance) that does the same elementwise ops.
__device__ __forceinline__ float sq_dist(float cx, float cy, float cz,
                                         float sqc, float x, float y,
                                         float z, float sqx) {
  const float prod = __fadd_rn(__fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)),
                               __fmul_rn(cz, z));
  const float d = __fsub_rn(__fadd_rn(sqc, sqx), __fmul_rn(2.0f, prod));
  return fmaxf(d, 0.0f);
}

// Lexicographic (distance, index) minimum across each aligned group of
// kG lanes (kG a power of two up to 32); every lane of the group ends with
// the group's winner. Lowest index wins ties, like a stable top_k.
template <int kG>
__device__ __forceinline__ void group_argmin(float& d, int& j) {
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, d, off);
    const int oj = __shfl_xor_sync(kFullMask, j, off);
    if (od < d || (od == d && oj < j)) {
      d = od;
      j = oj;
    }
  }
}

// Stage points [p0, p0 + cnt) of one stream's cloud xyz (M x 3, mask or
// null) into shared memory as float4 (x, y, z, |x|^2, or w = -1 for a
// masked point), and (0, 0, 0, -1) on to `padded`, by the kThreads
// threads of a block (tid = threadIdx.x): four points a thread a round,
// their loads issued before their stores, so a round waits for memory
// once. The caller synchronises the block before reading `cloud`.
template <int kThreads>
__device__ __forceinline__ void stage_cloud(float4* cloud, const float* xyz,
                                            const unsigned char* mask,
                                            int p0, int cnt, int padded,
                                            int tid) {
  constexpr int kPer = 4;
  for (int base = tid; base < padded; base += kPer * kThreads) {
    float x[kPer], y[kPer], z[kPer];
    bool valid[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = base + u * kThreads;
      x[u] = y[u] = z[u] = 0.0f;
      valid[u] = false;
      if (e < cnt) {
        const float* pj = xyz + (size_t)(p0 + e) * 3;
        x[u] = pj[0];
        y[u] = pj[1];
        z[u] = pj[2];
        valid[u] = mask == nullptr || mask[p0 + e] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = base + u * kThreads;
      if (e < padded)
        cloud[e] = make_float4(x[u], y[u], z[u],
                               valid[u] ? sq_norm3(x[u], y[u], z[u]) : -1.0f);
    }
  }
}

// Ball query of one center at two radii, by one warp: the first nsa (nsb)
// valid points of the stream's cloud xb (n x 3, mask mb or null) with
// d^2 < r2a (r2b), in index order, go to the warp's slots_a (slots_b).
// The cloud is scanned 32 points a step; one ballot per radius ranks
// every hit with __popc, and the scan stops once both lists are full.
// On return *hits_a / *hits_b hold the filled slot counts.
__device__ __forceinline__ void ball_query_pair(
    const float* xb, const unsigned char* mb, int n, float cx, float cy,
    float cz, float r2a, int nsa, float r2b, int nsb, int* slots_a,
    int* slots_b, int lane, int* hits_a, int* hits_b) {
  const float sqc = sq_norm3(cx, cy, cz);
  int cnt_a = 0, cnt_b = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    bool ha = false, hb = false;
    if (j < n && (mb == nullptr || mb[j] != 0)) {
      const float x = xb[3 * j], y = xb[3 * j + 1], z = xb[3 * j + 2];
      const float d = sq_dist(cx, cy, cz, sqc, x, y, z, sq_norm3(x, y, z));
      ha = d < r2a;
      hb = d < r2b;
    }
    const unsigned bal_a = __ballot_sync(kFullMask, ha);
    const unsigned bal_b = __ballot_sync(kFullMask, hb);
    if (ha) {
      const int r = cnt_a + __popc(bal_a & below);
      if (r < nsa) slots_a[r] = j;
    }
    if (hb) {
      const int r = cnt_b + __popc(bal_b & below);
      if (r < nsb) slots_b[r] = j;
    }
    cnt_a += __popc(bal_a);
    cnt_b += __popc(bal_b);
    if (cnt_a >= nsa && cnt_b >= nsb) break;
  }
  __syncwarp();
  *hits_a = min(cnt_a, nsa);
  *hits_b = min(cnt_b, nsb);
}

}  // namespace ratrack
