// Correlator stage: kNN-16 + gather + pair MLP + WeightNet + slot sum.
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_correlator.py::_corr_kernel
// (fused_knn_weight_aggregate), as two launches:
//
//   knn_kernel: the k nearest valid candidates of each query, lowest index
//     on ties; fewer than k valid repeat the nearest, none valid gives
//     index 0 (ops.neighborhood.knn's rules) -> idx (B, N, k) int32.
//   aggregate_kernel, for each query i and slot s with j = idx[i, s]:
//     h = leaky(feats_p[j] + add_q[i])         stage 1 (layer 1 hoisted)
//     h = feats_p[j]                           stage 2
//     h = leaky(h @ W_l + b_l), l = 1..n_mlp   the 256x256 pair MLP
//     w = WeightNet(points[j] - query[i])      3 -> 8 -> 8 -> 256, ReLU
//     out[i] = sum_s w * h                     unnormalised
//
// What bounds it on the H100: the pair MLP, 2 x 256 x 256 multiply-adds
// for each of the k = 16 slots of every query: about 17 GFLOP per stage-1
// call at B = 8, N = M = 512, in float32 on the CUDA cores. A 256x256
// float32 layer is 256 KB, above the 227 KB of shared memory a block may
// have, so the weights stream through shared memory in 32-row K-tiles.
// Design: a block holds the 64 pair rows of 4 queries (64 KB) in shared
// memory; each of its 256 threads owns one query's 16 slots x 4 output
// channels in registers, so every shared read (a 4-wide activation
// broadcast to the query's two warps, a conflict-free 4-wide weight row
// piece) feeds 16 multiply-adds. The last layer's epilogue applies the
// WeightNet and sums the 16 slots in registers: nothing of the
// (B, N, 16, 256) pair tensor reaches device memory.
// The kNN selection costs 16 warp passes over the candidates per query:
// the k-th pass takes the (distance, index) minimum strictly after the
// (k-1)-th winner, which needs no per-query list in memory.

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kKnnWarps = 8;
constexpr int kC = 256;        // channel width of both stages
constexpr int kK = 16;         // neighbours per query
constexpr int kQ = 4;          // queries per aggregate block
constexpr int kRows = kQ * kK;
constexpr int kKT = 32;        // weight rows per streamed K-tile
constexpr int kThreads = 256;  // kQ * (kC / 4)
constexpr int kMaxMlp = 2;
constexpr int kWnHidden = 8;

__global__ void __launch_bounds__(kKnnWarps * 32)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           const unsigned char* __restrict__ mask, int nb, int n, int m, int k,
           int* __restrict__ idx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kKnnWarps + warp;
  if (g >= (long long)nb * n) return;
  const int bi = (int)(g / n);
  const float* q = query + (size_t)g * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float sqq = ratrack::sq_norm3(qx, qy, qz);
  const float* pb = points + (size_t)bi * m * 3;
  const unsigned char* mb = mask != nullptr ? mask + (size_t)bi * m : nullptr;

  float prev_d = -CUDART_INF_F;
  int prev_j = -1, first = 0;
  for (int s = 0; s < k; ++s) {
    float bd = CUDART_INF_F;
    int bj = INT_MAX;
    for (int j = lane; j < m; j += 32) {
      float d = ratrack::kBig;
      if (mb == nullptr || mb[j] != 0) {
        const float x = pb[3 * j], y = pb[3 * j + 1], z = pb[3 * j + 2];
        d = ratrack::sq_dist(qx, qy, qz, sqq, x, y, z,
                             ratrack::sq_norm3(x, y, z));
      }
      const bool after = d > prev_d || (d == prev_d && j > prev_j);
      if (after && d < bd) {   // a lane sees j ascending: first wins ties
        bd = d;
        bj = j;
      }
    }
    ratrack::warp_argmin(bd, bj);
    if (s == 0) first = bj;
    if (lane == 0) idx[(size_t)g * k + s] = bd >= ratrack::kBig ? first : bj;
    prev_d = bd;
    prev_j = bj;
  }
}

struct Mlp {
  const float* w[kMaxMlp];   // (kC, kC), x @ W layout
  const float* b[kMaxMlp];
  int n;
};

struct WeightNet {
  const float* w0;   // (3, 8)
  const float* b0;
  const float* w1;   // (8, 8)
  const float* b1;
  const float* w2;   // (8, kC)
  const float* b2;
};

__device__ __forceinline__ float leaky(float x) { return x > 0.0f ? x : 0.1f * x; }

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const float* __restrict__ query,
                 const float* __restrict__ points, const int* __restrict__ idx,
                 int nb, int n, int m, const float* __restrict__ feats_p,
                 const float* __restrict__ add_q, Mlp mlp, WeightNet wn,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);   // (kRows, kC)
  float* wt = hs + kRows * kC;                   // (kKT, kC)
  float* gs = wt + kKT * kC;                     // (kRows, kWnHidden)
  int* sj = reinterpret_cast<int*>(gs + kRows * kWnHidden);
  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  const float4* wt4 = reinterpret_cast<const float4*>(wt);

  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kQ;
  const long long total = (long long)nb * n;

  // neighbour ids and the WeightNet hidden layers, one pair row a thread
  if (tid < kRows) {
    const long long g = q0 + tid / kK;
    float h2[kWnHidden];
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) h2[o] = 0.0f;
    int j = 0;
    if (g < total) {
      const int bi = (int)(g / n);
      j = idx[(size_t)g * kK + tid % kK];
      const float* q = query + (size_t)g * 3;
      const float* p = points + ((size_t)bi * m + j) * 3;
      const float d[3] = {p[0] - q[0], p[1] - q[1], p[2] - q[2]};
      float h1[kWnHidden];
#pragma unroll
      for (int o = 0; o < kWnHidden; ++o) {
        float a = 0.0f;
#pragma unroll
        for (int t = 0; t < 3; ++t) a = fmaf(d[t], wn.w0[t * kWnHidden + o], a);
        h1[o] = fmaxf(a + wn.b0[o], 0.0f);
      }
#pragma unroll
      for (int o = 0; o < kWnHidden; ++o) {
        float a = 0.0f;
#pragma unroll
        for (int t = 0; t < kWnHidden; ++t)
          a = fmaf(h1[t], wn.w1[t * kWnHidden + o], a);
        h2[o] = fmaxf(a + wn.b1[o], 0.0f);
      }
    }
    sj[tid] = j;
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) gs[tid * kWnHidden + o] = h2[o];
  }
  __syncthreads();

  // gathered pair rows: stage 1 finishes the factorised layer 1
  for (int e = tid; e < kRows * (kC / 4); e += kThreads) {
    const int r = e / (kC / 4), c4 = e % (kC / 4);
    const long long g = q0 + r / kK;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < total) {
      const int bi = (int)(g / n);
      v = reinterpret_cast<const float4*>(feats_p + ((size_t)bi * m + sj[r]) * kC)[c4];
      if (add_q != nullptr) {
        const float4 a = reinterpret_cast<const float4*>(add_q + (size_t)g * kC)[c4];
        v = make_float4(leaky(v.x + a.x), leaky(v.y + a.y), leaky(v.z + a.z),
                        leaky(v.w + a.w));
      }
    }
    reinterpret_cast<float4*>(hs)[e] = v;
  }
  __syncthreads();

  const int qq = tid / (kC / 4);        // local query
  const int col4 = tid % (kC / 4);      // owns channels 4*col4 .. 4*col4+3
  float acc[kK][4];
  for (int l = 0; l < mlp.n; ++l) {
#pragma unroll
    for (int s = 0; s < kK; ++s)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[s][cc] = 0.0f;
    const float* w = mlp.w[l];
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
    const float4 b = reinterpret_cast<const float4*>(mlp.b[l])[col4];
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      acc[s][0] = leaky(acc[s][0] + b.x);
      acc[s][1] = leaky(acc[s][1] + b.y);
      acc[s][2] = leaky(acc[s][2] + b.z);
      acc[s][3] = leaky(acc[s][3] + b.w);
    }
    if (l + 1 < mlp.n) {   // next layer reads this one's output
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kK; ++s)
        reinterpret_cast<float4*>(hs)[(qq * kK + s) * (kC / 4) + col4] =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
      __syncthreads();
    }
  }
  if (mlp.n == 0) {
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      const float4 h = hs4[(qq * kK + s) * (kC / 4) + col4];
      acc[s][0] = h.x;
      acc[s][1] = h.y;
      acc[s][2] = h.z;
      acc[s][3] = h.w;
    }
  }

  // epilogue: WeightNet output layer x pair features, summed over slots
  const long long g = q0 + qq;
  if (g >= total) return;
  float res[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float4 bo = reinterpret_cast<const float4*>(wn.b2)[col4];
  const float bov[4] = {bo.x, bo.y, bo.z, bo.w};
  float4 wo[kWnHidden];
#pragma unroll
  for (int t = 0; t < kWnHidden; ++t)
    wo[t] = reinterpret_cast<const float4*>(wn.w2 + (size_t)t * kC)[col4];
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    const float* gr = gs + (qq * kK + s) * kWnHidden;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < kWnHidden; ++t) {
      const float gv = gr[t];
      a[0] = fmaf(gv, wo[t].x, a[0]);
      a[1] = fmaf(gv, wo[t].y, a[1]);
      a[2] = fmaf(gv, wo[t].z, a[2]);
      a[3] = fmaf(gv, wo[t].w, a[3]);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      res[cc] = fmaf(fmaxf(a[cc] + bov[cc], 0.0f), acc[s][cc], res[cc]);
  }
  reinterpret_cast<float4*>(out + (size_t)g * kC)[col4] =
      make_float4(res[0], res[1], res[2], res[3]);
}

}  // namespace

extern "C" int ratrack_knn(const float* query, const float* points,
                           const unsigned char* mask, int nb, int n, int m,
                           int k, int* idx, void* stream) {
  if (nb < 1 || n < 1 || m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * n;
  const int grid = (int)((total + kKnnWarps - 1) / kKnnWarps);
  knn_kernel<<<grid, kKnnWarps * 32, 0, (cudaStream_t)stream>>>(
      query, points, mask, nb, n, m, k, idx);
  return (int)cudaGetLastError();
}

// Channel width and neighbour count are fixed at 256 and 16 (the model's
// FeatureCorrelator); the Python wrapper rejects anything else.
extern "C" int ratrack_corr_aggregate(
    const float* query, const float* points, const int* idx, int nb, int n,
    int m, const float* feats_p, const float* add_q,
    const float* const* mlp_w, const float* const* mlp_b, int n_mlp,
    const float* wn_w0, const float* wn_b0, const float* wn_w1,
    const float* wn_b1, const float* wn_w2, const float* wn_b2, float* out,
    void* stream) {
  if (nb < 1 || n < 1 || m < 1 || n_mlp < 0 || n_mlp > kMaxMlp)
    return (int)cudaErrorInvalidValue;
  Mlp mlp;
  mlp.n = n_mlp;
  for (int l = 0; l < kMaxMlp; ++l) {
    mlp.w[l] = l < n_mlp ? mlp_w[l] : nullptr;
    mlp.b[l] = l < n_mlp ? mlp_b[l] : nullptr;
  }
  const WeightNet wn = {wn_w0, wn_b0, wn_w1, wn_b1, wn_w2, wn_b2};
  const size_t smem = sizeof(float) * (kRows * kC + kKT * kC + kRows * kWnHidden) +
                      sizeof(int) * kRows;
  cudaError_t err = cudaFuncSetAttribute(
      aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)nb * n;
  const int grid = (int)((total + kQ - 1) / kQ);
  aggregate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      query, points, idx, nb, n, m, feats_p, add_q, mlp, wn, out);
  return (int)cudaGetLastError();
}
