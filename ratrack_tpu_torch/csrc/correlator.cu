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
//
// The aggregate kernel alone, over indices its caller selected, is kernel
// B4 (entry ratrack_corr_apply), which replaces the TPU kernel
// pallas_correlator.py::_apply_kernel (knn_gather_apply), the split
// formulation for clouds above 4096 points: there the selection is the
// tiled kNN of knn_tiled.cu. The TPU kernel is fed rows that XLA gathered
// outside it; here the gather by index stays inside the kernel, so no
// (N, 16, 259) table reaches device memory. At 8192 queries stage 1 is
// 34.4 GFLOP of float32 on the CUDA cores: bound by operations. Row
// offsets are 64-bit; N need not equal M.
//
// The same aggregate kernel is the forward of the train kernel B10
// (replacing ratrack_tpu/ops/pallas_correlator_train.py::_fwd_kernel,
// entry ratrack_corr_train_fwd): stage 1 then adds dir @ W_dir to layer 1
// from the exact directions, h = leaky(feats_p[j] + add_q[i] + dir @
// W_dir), and the activations entering each pair layer and leaving the
// last are stashed (three (B*N*16, 256) float32 tensors, ~200 MB at the
// main-path shape) for the backward in correlator_train.cu. Eval passes
// no W_dir and no stash. The 256x256 layer lives in corr_common.cuh,
// shared with the backward.

#include "corr_common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

using namespace ratrack::corr;

constexpr int kKnnWarps = 8;

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

// Train-mode extras of the aggregate kernel (all null in eval):
//   w_dir  (3, kC): stage 1 adds dir @ W_dir to layer 1 in the kernel, from
//          the exact directions (the train hoists leave it out);
//   h[l]   (B * N * kK, kC): the activations entering pair layer l + 1
//          (h[0]: the activated layer-1 rows) and h[n]: the last layer's,
//          stashed for the backward (correlator_train.cu).
struct TrainExtras {
  const float* w_dir;
  float* h[kMaxMlp + 1];
};

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const float* __restrict__ query,
                 const float* __restrict__ points, const int* __restrict__ idx,
                 int nb, int n, int m, const float* __restrict__ feats_p,
                 const float* __restrict__ add_q, Mlp mlp, WeightNet wn,
                 TrainExtras tx, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);   // (kRows, kC)
  float* wt = hs + kRows * kC;                   // (kKT, kC)
  float* gs = wt + kKT * kC;                     // (kRows, kWnHidden)
  float* ds = gs + kRows * kWnHidden;            // (kRows, 4) directions
  int* sj = reinterpret_cast<int*>(ds + kRows * 4);
  const float4* hs4 = reinterpret_cast<const float4*>(hs);

  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kQ;
  const long long total = (long long)nb * n;

  // neighbour ids, directions and the WeightNet hidden layers, one pair
  // row a thread
  if (tid < kRows) {
    const long long g = q0 + tid / kK;
    float d[3] = {0.0f, 0.0f, 0.0f};
    float h1[kWnHidden], h2[kWnHidden];
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) h2[o] = 0.0f;
    int j = 0;
    if (g < total) {
      const int bi = (int)(g / n);
      j = idx[(size_t)g * kK + tid % kK];
      const float* q = query + (size_t)g * 3;
      const float* p = points + ((size_t)bi * m + j) * 3;
      d[0] = p[0] - q[0];
      d[1] = p[1] - q[1];
      d[2] = p[2] - q[2];
      ratrack::corr::weightnet_hidden(d, wn.w0, wn.b0, wn.w1, wn.b1, h1, h2);
    }
    sj[tid] = j;
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) gs[tid * kWnHidden + o] = h2[o];
#pragma unroll
    for (int t = 0; t < 3; ++t) ds[tid * 4 + t] = d[t];
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
        v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
        if (tx.w_dir != nullptr) {
          const float d0 = ds[r * 4], d1 = ds[r * 4 + 1], d2 = ds[r * 4 + 2];
          const float4 w0 = reinterpret_cast<const float4*>(tx.w_dir)[c4];
          const float4 w1 = reinterpret_cast<const float4*>(tx.w_dir + kC)[c4];
          const float4 w2 = reinterpret_cast<const float4*>(tx.w_dir + 2 * kC)[c4];
          v = make_float4(v.x + fmaf(d2, w2.x, fmaf(d1, w1.x, d0 * w0.x)),
                          v.y + fmaf(d2, w2.y, fmaf(d1, w1.y, d0 * w0.y)),
                          v.z + fmaf(d2, w2.z, fmaf(d1, w1.z, d0 * w0.z)),
                          v.w + fmaf(d2, w2.w, fmaf(d1, w1.w, d0 * w0.w)));
        }
        v = make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
      }
      if (tx.h[0] != nullptr)
        reinterpret_cast<float4*>(tx.h[0] + ((size_t)g * kK + r % kK) * kC)[c4] = v;
    }
    reinterpret_cast<float4*>(hs)[e] = v;
  }
  __syncthreads();

  const int qq = tid / (kC / 4);        // local query
  const int col4 = tid % (kC / 4);      // owns channels 4*col4 .. 4*col4+3
  const long long g = q0 + qq;
  float acc[kK][4];
  for (int l = 0; l < mlp.n; ++l) {
    ratrack::corr::tile_layer(mlp.w[l], hs4, wt, acc, tid, qq, col4);
    const float4 b = reinterpret_cast<const float4*>(mlp.b[l])[col4];
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      acc[s][0] = leaky(acc[s][0] + b.x);
      acc[s][1] = leaky(acc[s][1] + b.y);
      acc[s][2] = leaky(acc[s][2] + b.z);
      acc[s][3] = leaky(acc[s][3] + b.w);
    }
    float* stash = tx.h[l + 1];
    if (stash != nullptr && g < total) {
#pragma unroll
      for (int s = 0; s < kK; ++s)
        reinterpret_cast<float4*>(stash + ((size_t)g * kK + s) * kC)[col4] =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
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

int launch_aggregate(const float* query, const float* points, const int* idx,
                     int nb, int n, int m, const float* feats_p,
                     const float* add_q, const float* const* mlp_w,
                     const float* const* mlp_b, int n_mlp, const float* wn_w0,
                     const float* wn_b0, const float* wn_w1, const float* wn_b1,
                     const float* wn_w2, const float* wn_b2,
                     const TrainExtras& tx, float* out, void* stream) {
  if (nb < 1 || n < 1 || m < 1 || n_mlp < 0 || n_mlp > kMaxMlp)
    return (int)cudaErrorInvalidValue;
  Mlp mlp;
  mlp.n = n_mlp;
  for (int l = 0; l < kMaxMlp; ++l) {
    mlp.w[l] = l < n_mlp ? mlp_w[l] : nullptr;
    mlp.b[l] = l < n_mlp ? mlp_b[l] : nullptr;
  }
  const WeightNet wn = {wn_w0, wn_b0, wn_w1, wn_b1, wn_w2, wn_b2};
  const size_t smem = sizeof(float) * (kRows * kC + kKT * kC + kRows * kWnHidden +
                                       kRows * 4) +
                      sizeof(int) * kRows;
  cudaError_t err = cudaFuncSetAttribute(
      aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)nb * n;
  const int grid = (int)((total + kQ - 1) / kQ);
  aggregate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      query, points, idx, nb, n, m, feats_p, add_q, mlp, wn, tx, out);
  return (int)cudaGetLastError();
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
  const TrainExtras none = {nullptr, {nullptr, nullptr, nullptr}};
  return launch_aggregate(query, points, idx, nb, n, m, feats_p, add_q, mlp_w,
                          mlp_b, n_mlp, wn_w0, wn_b0, wn_w1, wn_b1, wn_w2,
                          wn_b2, none, out, stream);
}

// Kernel B4: one stage over the caller's neighbour indices idx (B, N, 16),
// each in [0, M); no selection launch.
extern "C" int ratrack_corr_apply(
    const float* query, const float* points, const int* idx, int nb, int n,
    int m, const float* feats_p, const float* add_q,
    const float* const* mlp_w, const float* const* mlp_b, int n_mlp,
    const float* wn_w0, const float* wn_b0, const float* wn_w1,
    const float* wn_b1, const float* wn_w2, const float* wn_b2, float* out,
    void* stream) {
  return ratrack_corr_aggregate(query, points, idx, nb, n, m, feats_p, add_q,
                                mlp_w, mlp_b, n_mlp, wn_w0, wn_b0, wn_w1,
                                wn_b1, wn_w2, wn_b2, out, stream);
}

// Train forward of one stage (kernel B10, with correlator_train.cu): the
// aggregate with dir @ w_dir added to layer 1 (w_dir may be null) and the
// activations stashed into stash[0..n_mlp] (entries may be null).
extern "C" int ratrack_corr_train_fwd(
    const float* query, const float* points, const int* idx, int nb, int n,
    int m, const float* feats_p, const float* add_q, const float* w_dir,
    const float* const* mlp_w, const float* const* mlp_b, int n_mlp,
    const float* wn_w0, const float* wn_b0, const float* wn_w1,
    const float* wn_b1, const float* wn_w2, const float* wn_b2,
    float* const* stash, float* out, void* stream) {
  if (n_mlp < 0 || n_mlp > kMaxMlp) return (int)cudaErrorInvalidValue;
  TrainExtras tx = {w_dir, {nullptr, nullptr, nullptr}};
  for (int l = 0; l <= n_mlp; ++l) tx.h[l] = stash[l];
  return launch_aggregate(query, points, idx, nb, n, m, feats_p, add_q, mlp_w,
                          mlp_b, n_mlp, wn_w0, wn_b0, wn_w1, wn_b1, wn_w2,
                          wn_b2, tx, out, stream);
}
