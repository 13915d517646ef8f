// Shared helpers of the ratrack_tpu_torch kernels (sm_90a, float32).
#pragma once

#include <cuda_runtime.h>

namespace ratrack {

constexpr unsigned kFullMask = 0xffffffffu;
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

// Lexicographic (distance, index) minimum across the warp; every lane
// ends with the winner. Lowest index wins ties, like a stable top_k.
__device__ __forceinline__ void warp_argmin(float& d, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, d, off);
    const int oj = __shfl_xor_sync(kFullMask, j, off);
    if (od < d || (od == d && oj < j)) {
      d = od;
      j = oj;
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
