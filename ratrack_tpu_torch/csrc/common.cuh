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

}  // namespace ratrack
