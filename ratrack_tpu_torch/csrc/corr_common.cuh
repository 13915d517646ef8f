// Shared pieces of the correlator kernels (correlator.cu, eval and train
// forward; correlator_train.cu, backward): the block shape and the
// register-tiled 256x256 float32 layer.
#pragma once

#include "common.cuh"

namespace ratrack {
namespace corr {

constexpr int kC = 256;        // channel width of both stages
constexpr int kK = 16;         // neighbours per query
constexpr int kQ = 4;          // queries per block
constexpr int kRows = kQ * kK; // pair rows per block
constexpr int kKT = 32;        // weight rows per streamed K-tile
constexpr int kThreads = 256;  // kQ * (kC / 4)
constexpr int kMaxMlp = 2;
constexpr int kWnHidden = 8;

__device__ __forceinline__ float leaky(float x) { return x > 0.0f ? x : 0.1f * x; }

// acc[s][cc] = sum_k hs[qq * kK + s][k] * w[k][4 * col4 + cc] for a
// (kC, kC) row-major w in global memory. hs (kRows, kC) is resident in
// shared memory; w streams through the shared buffer wt (kKT, kC) in
// K-tiles. Each thread owns one query's kK slots x 4 output channels, so
// every shared read (a 4-wide activation broadcast to the query's two
// warps, a conflict-free 4-wide piece of a weight row) feeds 16 FMAs.
// Contains __syncthreads(): every thread of the block calls it.
__device__ __forceinline__ void tile_layer(const float* __restrict__ w,
                                           const float4* hs4, float* wt,
                                           float (&acc)[kK][4], int tid,
                                           int qq, int col4) {
  const float4* wt4 = reinterpret_cast<const float4*>(wt);
#pragma unroll
  for (int s = 0; s < kK; ++s)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[s][cc] = 0.0f;
  for (int kt = 0; kt < kC; kt += kKT) {
    __syncthreads();   // previous tile fully read
    for (int e = tid; e < kKT * (kC / 4); e += kThreads)
      reinterpret_cast<float4*>(wt)[e] =
          reinterpret_cast<const float4*>(w + (size_t)kt * kC)[e];
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKT; kk += 4) {
      const float4 w0 = wt4[(kk + 0) * (kC / 4) + col4];
      const float4 w1 = wt4[(kk + 1) * (kC / 4) + col4];
      const float4 w2 = wt4[(kk + 2) * (kC / 4) + col4];
      const float4 w3 = wt4[(kk + 3) * (kC / 4) + col4];
#pragma unroll
      for (int s = 0; s < kK; ++s) {
        const float4 h = hs4[(qq * kK + s) * (kC / 4) + (kt + kk) / 4];
        acc[s][0] = fmaf(h.w, w3.x, fmaf(h.z, w2.x, fmaf(h.y, w1.x, fmaf(h.x, w0.x, acc[s][0]))));
        acc[s][1] = fmaf(h.w, w3.y, fmaf(h.z, w2.y, fmaf(h.y, w1.y, fmaf(h.x, w0.y, acc[s][1]))));
        acc[s][2] = fmaf(h.w, w3.z, fmaf(h.z, w2.z, fmaf(h.y, w1.z, fmaf(h.x, w0.z, acc[s][2]))));
        acc[s][3] = fmaf(h.w, w3.w, fmaf(h.z, w2.w, fmaf(h.y, w1.w, fmaf(h.x, w0.w, acc[s][3]))));
      }
    }
  }
}

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

}  // namespace corr
}  // namespace ratrack
