// Tiled kNN selection for large clouds (kernel B5).
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_knn.py::_knn_kernel
// (knn_indices_tiled). For each query: the k <= 32 nearest valid
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
// floats) nor arithmetic (N x M distances of ~10 operations, 0.01 ms at
// 8192^2) but latency: the selection is a chain of compares, ballots and
// shuffles a query. Measured (kernels/tune.py --knn): the chunk gate
// below takes 18% off a Z-sorted call and costs 11% on an unsorted one
// (B10's selection), so it always runs; neither a warp a query with
// 32-candidate boxes nor a warm start from the query's own place in the
// list took more off; what holds the rest is not measured yet (PERF.md,
// open questions). The stretch path's clouds are Z-sorted
// (models/correlator.py), so a query's neighbours sit in a few candidate
// chunks near its own place in the cloud. Design, two launches a call:
//   knn_prep_kernel   one block a (chunk, stream), a thread a candidate:
//                 packs the candidates as float4 (x, y, z, |x|^2, or -1 for
//                 an invalid one) into scratch and writes the chunk's box
//                 over its VALID points (exact min / max, the count, sum
//                 of max squares);
//   knn_select_kernel a block owns a tile of Q queries, 16 lanes (half a
//                 warp) a query for k <= 16, a warp a query for 16 < k <=
//                 32: the top-k list of knn_common.cuh (WarpList<16> or
//                 <32>: insertion, a bitonic merge for a batch that many
//                 candidates beat), which B3's selection launch
//                 (correlator.cu) shares at depth 16. Depth 32 (FLOT's
//                 kNN graph, k = 32) is instantiated at 8 queries a block
//                 only, the one launch shape the port uses at that depth,
//                 so that the build grows by one kernel.
//                 Chunks of P candidates (128-512) come through cp.async,
//                 double-buffered. The TPU kernel's gate 1, with boxes for
//                 its spheres: the chunks are visited locality first (from
//                 the chunk at the tile's own fraction of the cloud, then
//                 wrapping, pallas_knn.py:88-97), and a chunk is skipped,
//                 not loaded, when it holds no valid candidate or when the
//                 lower bound of d^2 between the tile's query box and its
//                 box exceeds the largest k-th d^2 of the tile's queries.
// The bound is conservative against every rounding: the box gaps are
// exact differences of exact minima and maxima, rounded once; the
// expanded-form d^2 differs from the true one by at most ~9 ulp of
// |q|^2 + |x|^2; the gate keeps a margin of 4e-6 (67 ulp) of
// lb^2 + |q|^2_max + |x|^2_max and skips only on a strict inequality.
// A skipped chunk holds no candidate that a query of the tile would keep,
// and the list orders by (d^2, index) whatever the visit order, so the
// result is the plain version's index for index, ties included.
// Measuring builds (kernels/build.py): RATRACK_KNN_NO_GATE visits every
// chunk that holds a valid candidate; RATRACK_SKELETON does and inserts
// nothing, the scan's floor.

#include "common.cuh"
#include "corr_common.cuh"
#include "knn_common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

using ratrack::knn::kK;
using ratrack::knn::kKWarp;
constexpr int kBox = 8;       // lo xyz, hi xyz, valid count, sum max(lo^2, hi^2)
constexpr int kMaxChunk = 512;
constexpr float kMargin = 4e-6f;
#ifdef RATRACK_KNN_NO_GATE
constexpr bool kGate = false;      // a measuring build: every valid chunk
#else
constexpr bool kGate = true;
#endif

// A box of points from per-lane extremes and counts, warp-reduced; every
// lane returns it.
__device__ __forceinline__ void warp_box(float (&lo)[3], float (&hi)[3],
                                         float& cnt) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(ratrack::kFullMask, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(ratrack::kFullMask, hi[a], off));
    }
    cnt += __shfl_xor_sync(ratrack::kFullMask, cnt, off);
  }
}

__device__ __forceinline__ void write_box(float* out, const float (&lo)[3],
                                          const float (&hi)[3], float cnt) {
  float sq = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[a] = cnt > 0.0f ? lo[a] : 0.0f;
    out[3 + a] = cnt > 0.0f ? hi[a] : 0.0f;
    sq += cnt > 0.0f ? fmaxf(lo[a] * lo[a], hi[a] * hi[a]) : 0.0f;
  }
  out[6] = cnt;
  out[7] = sq;
}

// Block = one chunk of one stream, a thread a candidate (blockDim = chunk).
__global__ void __launch_bounds__(kMaxChunk)
knn_prep_kernel(const float* __restrict__ points,
                const unsigned char* __restrict__ mask, int m, int m_pad,
                int chunk, int n_chunks, float4* __restrict__ packed,
                float* __restrict__ boxes) {
  __shared__ float red[kMaxChunk / 32][7];
  const int c = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int j = c * chunk + tid;
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  float cnt = 0.0f;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
  if (j < m) {
    const float* pj = points + ((size_t)bi * m + j) * 3;
    v.x = pj[0];
    v.y = pj[1];
    v.z = pj[2];
    if (mask == nullptr || mask[(size_t)bi * m + j] != 0) {
      v.w = ratrack::sq_norm3(v.x, v.y, v.z);
      lo[0] = hi[0] = v.x;
      lo[1] = hi[1] = v.y;
      lo[2] = hi[2] = v.z;
      cnt = 1.0f;
    }
  }
  packed[(size_t)bi * m_pad + j] = v;
  warp_box(lo, hi, cnt);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      red[warp][a] = lo[a];
      red[warp][3 + a] = hi[a];
    }
    red[warp][6] = cnt;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool has = lane < chunk / 32;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = has ? red[lane][a] : CUDART_INF_F;
    hi[a] = has ? red[lane][3 + a] : -CUDART_INF_F;
  }
  cnt = has ? red[lane][6] : 0.0f;
  warp_box(lo, hi, cnt);
  if (lane == 0)
    write_box(boxes + ((size_t)bi * n_chunks + c) * kBox, lo, hi, cnt);
}

// Whether a box of candidates may hold one that a query of the box qlo /
// qhi (sum of max squares sq) keeps, given the largest k-th d^2 of those
// queries: false only when a lower bound of d^2, less the rounding margin,
// exceeds it.
__device__ __forceinline__ bool box_needed(const float* box,
                                           const float (&qlo)[3],
                                           const float (&qhi)[3], float sq,
                                           float kth) {
  float lb2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float gap =
        fmaxf(fmaxf(__fsub_rn(box[a], qhi[a]), __fsub_rn(qlo[a], box[3 + a])),
              0.0f);
    lb2 = __fadd_rn(lb2, __fmul_rn(gap, gap));
  }
  const float bound = __fsub_rn(
      __fmul_rn(lb2, 1.0f - kMargin),
      __fmul_rn(kMargin, __fadd_rn(lb2, __fadd_rn(sq, box[7]))));
  return !(bound > kth);
}

template <int kQ, int kW>
__global__ void __launch_bounds__(kQ * kW)
knn_select_kernel(const float* __restrict__ query,
                  const float4* __restrict__ packed,
                  const float* __restrict__ boxes, int n, int m_pad, int k,
                  int chunk, int n_chunks, int* __restrict__ idx,
                  float* __restrict__ keys) {
  extern __shared__ float4 buf[];            // 2 x chunk candidates
  __shared__ float qc[kQ][3];
  __shared__ float kq[kQ];
  using List = ratrack::knn::WarpList<kW>;
  constexpr int kThreads = kQ * kW;
  const int tid = threadIdx.x;
  const int ql = tid / kW, l16 = tid % kW;
  const int bi = blockIdx.y;
  const int qi = blockIdx.x * kQ + ql;
  const bool active = qi < n;
  const float4* pk = packed + (size_t)bi * m_pad;
  const float* bx = boxes + (size_t)bi * n_chunks * kBox;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* q = query + ((size_t)bi * n + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float sqq = ratrack::sq_norm3(qx, qy, qz);
  if (l16 == 0) {
    qc[ql][0] = qx;
    qc[ql][1] = qy;
    qc[ql][2] = qz;
  }
  __syncthreads();
  // the tile's query box, over its active queries
  float qlo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float qhi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  const int nq = min(kQ, n - (int)blockIdx.x * kQ);
  for (int t = 0; t < nq; ++t) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      qlo[a] = fminf(qlo[a], qc[t][a]);
      qhi[a] = fmaxf(qhi[a], qc[t][a]);
    }
  }
  float sq = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    sq = __fadd_rn(sq, fmaxf(__fmul_rn(qlo[a], qlo[a]),
                             __fmul_rn(qhi[a], qhi[a])));

  auto list = List::empty(k, tid & 31);
  float tile_kth = CUDART_INF_F;

  auto chunk_needed = [&](int c) {
    const float* b = bx + (size_t)c * kBox;
    return b[6] > 0.0f &&
           (!kGate || box_needed(b, qlo, qhi, sq, tile_kth));
  };
  // locality first: start at the chunk at the tile's fraction of the cloud
  const int c0 =
      (int)(((long long)blockIdx.x * kQ * n_chunks) / (long long)n);
  auto next_needed = [&](int p) {
    while (p < n_chunks && !chunk_needed((c0 + p) % n_chunks)) ++p;
    return p;
  };
  auto load = [&](int p, float4* dst) {
    const float4* src = pk + (size_t)((c0 + p) % n_chunks) * chunk;
    for (int e = tid; e < chunk; e += kThreads)
      ratrack::corr::cp16(reinterpret_cast<float*>(dst + e),
                          reinterpret_cast<const float*>(src + e), true);
    ratrack::corr::cp_commit();
  };

  int p_cur = next_needed(0);
  if (p_cur < n_chunks) load(p_cur, buf);
  int b = 0;
  while (p_cur < n_chunks) {
    const int p_nxt = next_needed(p_cur + 1);
    if (p_nxt < n_chunks) {
      load(p_nxt, buf + (b ^ 1) * chunk);
      ratrack::corr::cp_wait<1>();
    } else {
      ratrack::corr::cp_wait<0>();
    }
    __syncthreads();
    const int c = (c0 + p_cur) % n_chunks;
    if (chunk_needed(c)) {
      const float4* cb = buf + b * chunk;
      for (int s = 0; s < chunk; s += List::kStep)
        list.step(cb + s, c * chunk + s, qx, qy, qz, sqq, active);
    }
    if (l16 == 0) kq[ql] = list.kd;
    __syncthreads();   // the buffer is read; every query's k-th is posted
    tile_kth = -CUDART_INF_F;
    for (int t = 0; t < nq; ++t) tile_kth = fmaxf(tile_kth, kq[t]);
    p_cur = p_nxt;
    b ^= 1;
  }

  const int first = __shfl_sync(ratrack::kFullMask, list.sj, 0, kW);
  if (!active || l16 >= k) return;
  const bool filled = list.sj != INT_MAX;
  const size_t o = ((size_t)bi * n + qi) * k + l16;
  idx[o] = filled ? list.sj : (first != INT_MAX ? first : 0);
  keys[o] = filled ? -list.sd : -ratrack::kBig;
}

template <int kQ, int kW = 16>
int launch_select(const float* query, const float4* packed,
                  const float* boxes, int nb, int n, int m_pad, int k,
                  int chunk, int n_chunks, int* idx, float* keys,
                  cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float4) * chunk;
  const dim3 grid((n + kQ - 1) / kQ, nb);
  knn_select_kernel<kQ, kW><<<grid, kQ * kW, smem, stream>>>(
      query, packed, boxes, n, m_pad, k, chunk, n_chunks, idx, keys);
  return (int)cudaGetLastError();
}

}  // namespace

// queries: queries a block (8, 16 or 32; 8 where k > 16); chunk:
// candidates a chunk (128, 256 or 512).
// scratch: nb * n_chunks * (4 * chunk + 8) floats, 16-byte aligned, with
// n_chunks = ceil(m / chunk).
extern "C" int ratrack_knn_tiled(const float* query, const float* points,
                                 const unsigned char* mask, int nb, int n,
                                 int m, int k, int queries, int chunk,
                                 float* scratch, int* idx, float* keys,
                                 void* stream) {
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 || k < 1 || k > kKWarp ||
      (k > kK && queries != 8) ||
      (chunk != 128 && chunk != 256 && chunk != kMaxChunk) ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (m + chunk - 1) / chunk;
  const int m_pad = n_chunks * chunk;
  float4* packed = reinterpret_cast<float4*>(scratch);
  float* boxes = scratch + (size_t)nb * m_pad * 4;
  cudaStream_t st = (cudaStream_t)stream;
  knn_prep_kernel<<<dim3(n_chunks, nb), chunk, 0, st>>>(
      points, mask, m, m_pad, chunk, n_chunks, packed, boxes);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (k > kK)
    return launch_select<8, kKWarp>(query, packed, boxes, nb, n, m_pad, k,
                                    chunk, n_chunks, idx, keys, st);
  switch (queries) {
    case 8:
      return launch_select<8>(query, packed, boxes, nb, n, m_pad, k, chunk,
                              n_chunks, idx, keys, st);
    case 16:
      return launch_select<16>(query, packed, boxes, nb, n, m_pad, k, chunk,
                               n_chunks, idx, keys, st);
    case 32:
      return launch_select<32>(query, packed, boxes, nb, n, m_pad, k, chunk,
                               n_chunks, idx, keys, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
