// Tiled kNN selection for large clouds (kernel B5).
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_knn.py::_knn_kernel
// (knn_indices_tiled). For each query: the k <= 16 nearest valid
// candidates in ascending order of the expanded-form distance
// (common.cuh::sq_dist, bit for bit ops.neighborhood.point_distance),
// equal distances to the lowest candidate index. Outputs
//   idx  (B, N, k) int32: slots past the valid count repeat slot 0's
//        index, or 0 when no candidate is valid (the first-hit padding of
//        pallas_knn.py:298-305);
//   keys (B, N, k) float32: -d^2 of a selected candidate, -1e10 for a slot
//        that selected none.
//
// What bounds it on the H100: neither bytes (two clouds of 16384 x 3
// floats) nor arithmetic (N x M distances of ~10 operations, 2.7 GFLOP at
// 16384^2) but the selection: every one of the N x M distances is compared
// with its query's current k-th best, and a hit costs a 16-deep sorted
// insertion. Design: ONE pass over the candidates, unlike knn_kernel of
// correlator.cu, which makes k passes. A block owns 32 queries; the
// candidates stream through shared memory in chunks of 1024 (x, y, z,
// |x|^2 and the mask); 4 threads share a query, each scanning every 4th
// candidate of a chunk with its own sorted top-16 of (d^2, index) in
// registers, ordered lexicographically, so a tie falls to the lowest
// index whatever the scan order. At the end the 4 lists of a query are
// merged through shared memory by the same order. A query's 4 threads
// read 4 neighbouring shared-memory words and the 8 queries of a warp
// read the same 4: broadcasts, no bank conflicts.
// The TPU kernel's chunk gates (bounding spheres, "no row improves") only
// skip work and change no result; this kernel has none.

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kK = 16;                       // depth of a running list
constexpr int kSplit = 4;                    // threads per query
constexpr int kQueries = 32;                 // queries per block
constexpr int kThreads = kQueries * kSplit;  // 128
constexpr int kChunk = 1024;                 // candidates staged per step

// (d, j) sorts before (od, oj): nearer, or as near with the lower index.
__device__ __forceinline__ bool before(float d, int j, float od, int oj) {
  return d < od || (d == od && j < oj);
}

__global__ void __launch_bounds__(kThreads)
knn_tiled_kernel(const float* __restrict__ query,
                 const float* __restrict__ points,
                 const unsigned char* __restrict__ mask, int n, int m, int k,
                 int* __restrict__ idx, float* __restrict__ keys) {
  __shared__ float4 cand[kChunk];             // x, y, z, |x|^2
  __shared__ unsigned char cvalid[kChunk];
  __shared__ float md[kQueries][kSplit][kK];  // the lists, for the merge
  __shared__ int mj[kQueries][kSplit][kK];

  const int tid = threadIdx.x;
  const int ql = tid / kSplit, part = tid % kSplit;
  const int bi = blockIdx.y;
  const int qi = blockIdx.x * kQueries + ql;
  const bool active = qi < n;
  const float* pb = points + (size_t)bi * m * 3;
  const unsigned char* mb = mask != nullptr ? mask + (size_t)bi * m : nullptr;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* q = query + ((size_t)bi * n + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float sqq = ratrack::sq_norm3(qx, qy, qz);

  float hd[kK];
  int hj[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    hd[s] = CUDART_INF_F;
    hj[s] = INT_MAX;
  }

  for (int c0 = 0; c0 < m; c0 += kChunk) {
    __syncthreads();   // the previous chunk is fully read
    for (int e = tid; e < kChunk; e += kThreads) {
      const int j = c0 + e;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      unsigned char ok = 0;
      if (j < m) {
        v.x = pb[3 * (size_t)j];
        v.y = pb[3 * (size_t)j + 1];
        v.z = pb[3 * (size_t)j + 2];
        v.w = ratrack::sq_norm3(v.x, v.y, v.z);
        ok = mb != nullptr ? mb[j] : (unsigned char)1;
      }
      cand[e] = v;
      cvalid[e] = ok;
    }
    __syncthreads();
    if (!active) continue;
    const int cnt = min(kChunk, m - c0);
    for (int e = part; e < cnt; e += kSplit) {
      if (cvalid[e] == 0) continue;
      const float4 p = cand[e];
      const float d = ratrack::sq_dist(qx, qy, qz, sqq, p.x, p.y, p.z, p.w);
      const int j = c0 + e;
      if (before(d, j, hd[kK - 1], hj[kK - 1])) {
        hd[kK - 1] = d;
        hj[kK - 1] = j;
#pragma unroll
        for (int s = kK - 1; s > 0; --s) {
          if (before(hd[s], hj[s], hd[s - 1], hj[s - 1])) {
            const float td = hd[s];
            hd[s] = hd[s - 1];
            hd[s - 1] = td;
            const int tj = hj[s];
            hj[s] = hj[s - 1];
            hj[s - 1] = tj;
          }
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kK; ++s) {
    md[ql][part][s] = hd[s];
    mj[ql][part][s] = hj[s];
  }
  __syncthreads();
  if (!active || part != 0) return;

  // merge the query's kSplit sorted lists; unfilled entries (inf, INT_MAX)
  // sort last
  int head[kSplit];
#pragma unroll
  for (int p = 0; p < kSplit; ++p) head[p] = 0;
  int* io = idx + ((size_t)bi * n + qi) * k;
  float* ko = keys + ((size_t)bi * n + qi) * k;
  int first = 0;
  for (int s = 0; s < k; ++s) {
    float bd = CUDART_INF_F;
    int bj = INT_MAX, bp = 0;
#pragma unroll
    for (int p = 0; p < kSplit; ++p) {
      if (head[p] < kK) {
        const float d = md[ql][p][head[p]];
        const int j = mj[ql][p][head[p]];
        if (before(d, j, bd, bj)) {
          bd = d;
          bj = j;
          bp = p;
        }
      }
    }
    const bool filled = bj != INT_MAX;
#pragma unroll
    for (int p = 0; p < kSplit; ++p)
      if (filled && p == bp) ++head[p];
    if (s == 0) first = filled ? bj : 0;
    io[s] = filled ? bj : first;
    ko[s] = filled ? -bd : -ratrack::kBig;
  }
}

}  // namespace

extern "C" int ratrack_knn_tiled(const float* query, const float* points,
                                 const unsigned char* mask, int nb, int n,
                                 int m, int k, int* idx, float* keys,
                                 void* stream) {
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 || k < 1 || k > kK)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kQueries - 1) / kQueries, nb);
  knn_tiled_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, points, mask, n, m, k, idx, keys);
  return (int)cudaGetLastError();
}
