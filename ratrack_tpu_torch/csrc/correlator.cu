// Correlator stage: kNN-16 + gather + pair MLP + WeightNet + slot sum.
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_correlator.py::_corr_kernel
// (fused_knn_weight_aggregate), as two launches:
//
//   knn_staged_kernel: the k <= 16 nearest valid candidates of each query,
//     ascending by (d^2, index) with common.cuh::sq_dist distances, lowest
//     index on ties; a candidate at d^2 >= 1e10 counts as invalid; fewer
//     than k valid repeat the nearest, none valid gives index 0
//     (ops.neighborhood.knn's rules) -> idx (B, N, k) int32.
//   aggregate_kernel, for each query i and slot s with j = idx[i, s]:
//     h = leaky(feats_p[j] + add_q[i])         stage 1 (layer 1 hoisted)
//     h = feats_p[j]                           stage 2
//     h = leaky(h @ W_l + b_l), l = 1..n_mlp   the 256x256 pair MLP
//     w = WeightNet(points[j] - query[i])      3 -> 8 -> 8 -> 256, ReLU
//     out[i] = sum_s w * h                     unnormalised
//
// What bounds it on the H100: the pair MLP, 2 x 256 x 256 multiply-adds
// for each of the k = 16 slots of every query: 17 GFLOP per stage-1 call
// at B = 8, N = M = 512, 34 GFLOP at 8192 queries. Design: the products
// run on the tensor cores as 3xTF32 (corr_common.cuh: each float32 operand
// split into TF32 hi and lo, three mma.sync m16n8k8 products; each k8
// step's products added into the sum by a float32 add, so float32's
// accuracy: see mma_ktile). A block holds the pair rows of 8
// queries (128 rows) as the A operand in shared memory and computes all 256 output columns of every
// layer, 8 warps of 64 rows x 64 columns (32 x 64), so each 256 KB weight
// matrix is read from L2 once per 128 rows. The weights stream through
// a cp.async ring of 16-row K-tiles that runs on across both layers (its
// first tiles load while the block gathers its rows), and a layer's
// output, bias and leaky ReLU applied in registers, is written back over
// the activation tile as the next layer's A operand. The last layer's
// epilogue stays in registers: an m16 tile is one query's 16 slots, so
// the WeightNet x h slot sum is two rows in a lane and shuffles across
// the tile's 8 row groups; nothing of the (B, N, 16, 256) pair tensor
// reaches device memory. The gather, the layer-1 terms, the WeightNet
// hidden layers and every operation outside the products run per pair
// row on the CUDA cores. The 64-row shape (16 warps an SM, two blocks)
// serves the stage without a pair MLP (default_block_rows).
// The kNN selection is bound by latency: N x M distances (2.1 M at 8
// streams x 512 points, 0.003 ms of float32 operations) through a chain
// of compares and shuffles a query. Design: one pass. A block owns a tile
// of Q = 8 or 32 queries of one stream (default_knn_queries) and stages
// the stream's candidates once in shared memory as float4 (x, y, z,
// |x|^2, or -1 for a masked point), read coalesced from the raw (B, M, 3)
// cloud and mask, kPiece = 4096 at a time (64 KB; every path's clouds fit
// in one piece: dense eval at n <= SPLIT_ABOVE = 4096 and train at n m <=
// KNN_DENSE_LIMIT); each query's sorted top-k lives across half a warp
// and takes the candidates through the list B5 shares (knn_common.cuh):
// insertion, and a bitonic merge for a batch that more than three
// candidates of a query beat (the first batches, as the list fills). No chunk gate: B3's
// clouds are not Z-sorted, where B5's gate costs more than it skips.
//
// The aggregate kernel alone, over indices its caller selected, is kernel
// B4 (entry ratrack_corr_apply), which replaces the TPU kernel
// pallas_correlator.py::_apply_kernel (knn_gather_apply), the split
// formulation for clouds above 4096 points: there the selection is the
// tiled kNN of knn_tiled.cu. The TPU kernel is fed rows that XLA gathered
// outside it; here the gather by index stays inside the kernel, so no
// (N, 16, 259) table reaches device memory. Row offsets are 64-bit; N
// need not equal M.
//
// The same aggregate kernel is the forward of the train kernel B10
// (replacing ratrack_tpu/ops/pallas_correlator_train.py::_fwd_kernel,
// entry ratrack_corr_train_fwd): stage 1 then adds dir @ W_dir to layer 1
// from the exact directions, h = leaky(feats_p[j] + add_q[i] + dir @
// W_dir), and the activations entering each pair layer and leaving the
// last are stashed (three (B*N*16, 256) float32 tensors, ~200 MB at the
// main-path shape) for the backward in correlator_train.cu, which uses
// the same 3xTF32 products. Eval passes no W_dir and no stash.

#include "corr_common.cuh"
#include "knn_common.cuh"

namespace {

using namespace ratrack::corr;

namespace knn = ratrack::knn;

constexpr int kPiece = 4096;   // candidates staged at a time (64 KB)

// Dynamic shared memory of a launch over m candidates: one piece, padded
// to whole steps.
size_t knn_smem(int m) {
  const int piece = m < kPiece ? m : kPiece;
  return sizeof(float4) *
         (size_t)((piece + knn::kStep - 1) / knn::kStep * knn::kStep);
}

// Block = a tile of kQ queries of one stream (blockIdx.y), 16 lanes a
// query.
template <int kQ>
__global__ void __launch_bounds__(kQ * knn::kLanes)
knn_staged_kernel(const float* __restrict__ query,
                  const float* __restrict__ points,
                  const unsigned char* __restrict__ mask, int n, int m, int k,
                  int* __restrict__ idx) {
  extern __shared__ float4 cloud[];
  constexpr int kThreads = kQ * knn::kLanes;
  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int qi = blockIdx.x * kQ + tid / knn::kLanes;
  const bool active = qi < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* q = query + ((size_t)bi * n + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float sqq = ratrack::sq_norm3(qx, qy, qz);
  const float* pb = points + (size_t)bi * m * 3;
  const unsigned char* mb = mask != nullptr ? mask + (size_t)bi * m : nullptr;

  auto list = knn::HalfWarpList::empty(k, tid & 31);
  for (int p0 = 0; p0 < m; p0 += kPiece) {
    const int cnt = min(kPiece, m - p0);
    const int padded = (cnt + knn::kStep - 1) / knn::kStep * knn::kStep;
    if (p0 > 0) __syncthreads();   // every query has read the last piece
    ratrack::stage_cloud<kThreads>(cloud, pb, mb, p0, cnt, padded, tid);
    __syncthreads();
    for (int s = 0; s < padded; s += knn::kStep)
      list.step(cloud + s, p0 + s, qx, qy, qz, sqq, active);
  }

  // a slot at d^2 >= kBig is padding, as masked candidates are in the plain
  // version: it repeats slot 0, or index 0 when slot 0 is padding too
  const float first_d = __shfl_sync(ratrack::kFullMask, list.sd, 0,
                                    knn::kLanes);
  const int first = __shfl_sync(ratrack::kFullMask, list.sj, 0, knn::kLanes);
  if (!active || list.l16 >= k) return;
  idx[((size_t)bi * n + qi) * k + list.l16] =
      list.sd < ratrack::kBig ? list.sj
                              : (first_d < ratrack::kBig ? first : 0);
}

template <int kQ>
int launch_knn_tile(const float* query, const float* points,
                    const unsigned char* mask, int nb, int n, int m, int k,
                    int* idx, cudaStream_t st) {
  const size_t smem = knn_smem(m);
  const cudaError_t err = cudaFuncSetAttribute(
      knn_staged_kernel<kQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kQ - 1) / kQ, nb);
  knn_staged_kernel<kQ><<<grid, kQ * knn::kLanes, smem, st>>>(
      query, points, mask, n, m, k, idx);
  return (int)cudaGetLastError();
}

// Queries a block, read off kernels/tune.py --select (NVIDIA H100 80GB
// HBM3, 700 W): 8 up to 1,024 queries a launch (1 x 512: 0.0155 ms
// against 0.0162 at 16 and 0.0186 at 32), 32 above (8 x 512: 0.0197
// against 0.0202 and 0.0209; 1 x 4096: 0.0551 against 0.0574 and 0.0885,
// where every block stages the whole cloud).
int default_knn_queries(int nb, int n) {
  return (long long)nb * n <= 1024 ? 8 : 32;
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

constexpr int kAggThreads = 256;      // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpCols = kC / 4;     // output columns of a warp: 8 n-tiles
constexpr int kWBK = 16;              // weight rows of a staged K-tile
constexpr int kKTiles = kC / kWBK;    // K-tiles a layer
constexpr int kLdH = kC + 4;          // activation row stride: an A fragment
                                      // load hits 32 banks
constexpr int kLdW = kC + 8;          // weight row stride: a B fragment too

// The block shape by kMt, the m16 tiles of a warp's rows: 32 kMt pair rows
// (2 kMt queries) a block. 128 rows take a 3-stage ring, one block an SM;
// 64 rows a 2-stage ring, two blocks an SM.
template <int kMt>
struct Agg {
  static constexpr int kRowsB = 32 * kMt;
  static constexpr int kQB = kRowsB / kK;
  static constexpr int kStages = kMt == 4 ? 3 : 2;
  static constexpr int kMinBlocks = kMt == 4 ? 1 : 2;
  static size_t smem(int n_mlp) {
    return sizeof(float) * ((size_t)kRowsB * kLdH +
                            (n_mlp > 0 ? kStages * kWBK * kLdW : 0) +
                            kRowsB * kWnHidden + kRowsB * 4) +
           sizeof(int) * kRowsB;
  }
};

// acc (a warp's 16 kMt rows x 64 columns) += A B over one staged K-tile:
// as, the warp's first activation row at the tile's first depth (stride
// kLdH); bs, the staged weight rows at the warp's first column (stride
// kLdW). Every A and B element is split into hi and lo as it is loaded.
// The tensor cores add a product into their accumulator with truncation,
// not rounding to nearest, so a 256-deep sum kept in the mma accumulator
// drifts several times further from the exact one than float32 sums do
// (enough to flip the sign of near-zero activations, whose leaky' the
// backward takes from the stash); each k8 step's three products start
// from zero and are added into the accumulator by a float32 add instead.
template <int kMt>
__device__ __forceinline__ void mma_ktile(float (&acc)[kMt][8][4],
                                          const float* as, const float* bs,
                                          int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kWBK; kk += 8) {
    unsigned ah[kMt][4], al[kMt][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32(as[(mt * 16 + g + (q & 1) * 8) * kLdH + kk + t + (q >> 1) * 4],
                   ah[mt][q], al[mt][q]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      unsigned bh[2], bl[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split_tf32(bs[(kk + t + q * 4) * kLdW + nt * 8 + g], bh[q], bl[q]);
      // a k8 step's three products (the small terms first) from zero,
      // then one float32 add into the accumulator, rounded to nearest
      float d[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[mt][q] = 0.0f;
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) mma_tf32(d[mt], al[mt], bh);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) mma_tf32(d[mt], ah[mt], bl);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) mma_tf32(d[mt], ah[mt], bh);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mt][nt][q] = __fadd_rn(acc[mt][nt][q], d[mt][q]);
    }
  }
}

template <int kMt>
__global__ void __launch_bounds__(kAggThreads, Agg<kMt>::kMinBlocks)
aggregate_kernel(const float* __restrict__ query,
                 const float* __restrict__ points, const int* __restrict__ idx,
                 int nb, int n, int m, const float* __restrict__ feats_p,
                 const float* __restrict__ add_q, Mlp mlp, WeightNet wn,
                 TrainExtras tx, float* __restrict__ out) {
  constexpr int kRowsB = Agg<kMt>::kRowsB, kQB = Agg<kMt>::kQB;
  constexpr int kStages = Agg<kMt>::kStages;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);       // (kRowsB, kLdH)
  float* ring = hs + kRowsB * kLdH;                  // kStages x (kWBK, kLdW)
  float* gs = ring + (mlp.n > 0 ? kStages * kWBK * kLdW : 0);  // (kRowsB, 8)
  float* ds = gs + kRowsB * kWnHidden;               // (kRowsB, 4) directions
  int* sj = reinterpret_cast<int*>(ds + kRowsB * 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 16 * kMt;   // the warp's first pair row
  const int wc = (warp & 3) * kWarpCols;   // and first output column
  const long long q0 = (long long)blockIdx.x * kQB;
  const long long total = (long long)nb * n;
  const int ntiles = mlp.n * kKTiles;

  // weight K-tile T: kWBK rows of W_{T / kKTiles + 1} from row (T %
  // kKTiles) * kWBK, 1,024 float4, 4 a thread
  auto load_w = [&](int T) {
    float* ws = ring + (T % kStages) * kWBK * kLdW;
    const float* w = (T < kKTiles ? mlp.w[0] : mlp.w[1]) +
                     (size_t)(T % kKTiles) * kWBK * kC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kAggThreads, r = e >> 6, c4 = (e & 63) * 4;
      cp16(ws + r * kLdW + c4, w + r * kC + c4, true);
    }
  };
  // the ring's first tiles load while the block gathers its rows
#pragma unroll
  for (int T = 0; T < kStages - 1; ++T) {
    if (T < ntiles) load_w(T);
    cp_commit();
  }

  // neighbour ids, directions and the WeightNet hidden layers, one pair
  // row a thread
  if (tid < kRowsB) {
    const long long gq = q0 + tid / kK;
    float d[3] = {0.0f, 0.0f, 0.0f};
    float h1[kWnHidden], h2[kWnHidden];
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) h2[o] = 0.0f;
    int j = 0;
    if (gq < total) {
      const int bi = (int)(gq / n);
      j = idx[(size_t)gq * kK + tid % kK];
      const float* q = query + (size_t)gq * 3;
      const float* p = points + ((size_t)bi * m + j) * 3;
      d[0] = p[0] - q[0];
      d[1] = p[1] - q[1];
      d[2] = p[2] - q[2];
      weightnet_hidden(d, wn.w0, wn.b0, wn.w1, wn.b1, h1, h2);
    }
    sj[tid] = j;
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) gs[tid * kWnHidden + o] = h2[o];
#pragma unroll
    for (int i = 0; i < 3; ++i) ds[tid * 4 + i] = d[i];
  }
  __syncthreads();

  // gathered pair rows: stage 1 finishes the factorised layer 1
#pragma unroll 4
  for (int e = tid; e < kRowsB * (kC / 4); e += kAggThreads) {
    const int r = e / (kC / 4), c4 = e % (kC / 4);
    const long long gq = q0 + r / kK;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gq < total) {
      const int bi = (int)(gq / n);
      v = reinterpret_cast<const float4*>(feats_p + ((size_t)bi * m + sj[r]) * kC)[c4];
      if (add_q != nullptr) {
        const float4 a = reinterpret_cast<const float4*>(add_q + (size_t)gq * kC)[c4];
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
        reinterpret_cast<float4*>(tx.h[0] + ((size_t)gq * kK + r % kK) * kC)[c4] = v;
    }
    reinterpret_cast<float4*>(hs + r * kLdH)[c4] = v;
  }
  __syncthreads();

  // the pair layers; accumulator (mt, nt) holds rows wm + 16 mt + g (+ 8)
  // and columns wc + 8 nt + 2 t (+ 1), of query q0 + wm / 16 + mt
  float acc[kMt][8][4];
  for (int l = 0; l < mlp.n; ++l) {
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
    for (int kt = 0; kt < kKTiles; ++kt) {
      const int T = l * kKTiles + kt;
      cp_wait<kStages - 2>();
      __syncthreads();   // K-tile T has landed; T - 1 is consumed
      if (T + kStages - 1 < ntiles) load_w(T + kStages - 1);
      cp_commit();
      mma_ktile<kMt>(acc, hs + wm * kLdH + kt * kWBK,
                     ring + (T % kStages) * kWBK * kLdW + wc, g, t);
    }
    const float* bias = l == 0 ? mlp.b[0] : mlp.b[1];
    float* stash = l == 0 ? tx.h[1] : tx.h[2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(bias + wc + nt * 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        acc[mt][nt][0] = leaky(acc[mt][nt][0] + b.x);
        acc[mt][nt][1] = leaky(acc[mt][nt][1] + b.y);
        acc[mt][nt][2] = leaky(acc[mt][nt][2] + b.x);
        acc[mt][nt][3] = leaky(acc[mt][nt][3] + b.y);
      }
    }
    if (stash != nullptr) {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const long long gq = q0 + wm / kK + mt;
        if (gq >= total) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* row = stash + ((size_t)gq * kK + g + 8 * h) * kC + wc + 2 * t;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<float2*>(row + nt * 8) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
    if (l + 1 < mlp.n) {   // the next layer's A operand, over this one's
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<float2*>(
                hs + (wm + mt * 16 + g + 8 * h) * kLdH + wc + nt * 8 + 2 * t) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      __syncthreads();
    }
  }
  if (mlp.n == 0) {
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 v = *reinterpret_cast<const float2*>(
              hs + (wm + mt * 16 + g + 8 * h) * kLdH + wc + nt * 8 + 2 * t);
          acc[mt][nt][2 * h] = v.x;
          acc[mt][nt][2 * h + 1] = v.y;
        }
  }

  // epilogue: WeightNet output layer x pair features, summed over a
  // query's slots: rows g and g + 8 in the lane, then the 8 row groups by
  // shuffles; lanes 0-3 write the query's columns
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    const long long gq = q0 + wm / kK + mt;
    float gr[2][kWnHidden];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < kWnHidden; ++u)
        gr[h][u] = gs[(wm + mt * 16 + g + 8 * h) * kWnHidden + u];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = wc + nt * 8 + 2 * t;
      const float2 bo = *reinterpret_cast<const float2*>(wn.b2 + c);
      float a[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int u = 0; u < kWnHidden; ++u) {
        const float2 wo = *reinterpret_cast<const float2*>(wn.w2 + u * kC + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[h][0] = fmaf(gr[h][u], wo.x, a[h][0]);
          a[h][1] = fmaf(gr[h][u], wo.y, a[h][1]);
        }
      }
      float s0 = fmaxf(a[0][0] + bo.x, 0.0f) * acc[mt][nt][0];
      float s1 = fmaxf(a[0][1] + bo.y, 0.0f) * acc[mt][nt][1];
      s0 = fmaf(fmaxf(a[1][0] + bo.x, 0.0f), acc[mt][nt][2], s0);
      s1 = fmaf(fmaxf(a[1][1] + bo.y, 0.0f), acc[mt][nt][3], s1);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(ratrack::kFullMask, s0, off);
        s1 += __shfl_xor_sync(ratrack::kFullMask, s1, off);
      }
      if (g == 0 && gq < total)
        *reinterpret_cast<float2*>(out + (size_t)gq * kC + c) = make_float2(s0, s1);
    }
  }
}

struct AggArgs {
  const float* query;
  const float* points;
  const int* idx;
  int nb, n, m;
  const float* feats_p;
  const float* add_q;
  Mlp mlp;
  WeightNet wn;
  TrainExtras tx;
  float* out;
};

template <int kMt>
int launch_shape(const AggArgs& a, cudaStream_t st) {
  const size_t smem = Agg<kMt>::smem(a.mlp.n);
  const cudaError_t err = cudaFuncSetAttribute(
      aggregate_kernel<kMt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)a.nb * a.n;
  const int grid = (int)((total + Agg<kMt>::kQB - 1) / Agg<kMt>::kQB);
  aggregate_kernel<kMt><<<grid, kAggThreads, smem, st>>>(
      a.query, a.points, a.idx, a.nb, a.n, a.m, a.feats_p, a.add_q, a.mlp,
      a.wn, a.tx, a.out);
  return (int)cudaGetLastError();
}

// Pair rows a block by stage, read off kernels/tune.py --apply (NVIDIA
// H100 80GB HBM3, 700 W): with the pair MLP 128 (0.807 ms at 8192 queries,
// 0.412 at 4096) against 64 (0.850, 0.432); without it 64 (0.097, 0.053)
// against 128 (0.136, 0.079), two blocks an SM hiding each other's gather.
int default_block_rows(int n_mlp) { return n_mlp > 0 ? 128 : 64; }

// block_rows: 64 or 128 pair rows a block, or 0 for default_block_rows.
int launch_aggregate(const float* query, const float* points, const int* idx,
                     int nb, int n, int m, const float* feats_p,
                     const float* add_q, const float* const* mlp_w,
                     const float* const* mlp_b, int n_mlp, const float* wn_w0,
                     const float* wn_b0, const float* wn_w1, const float* wn_b1,
                     const float* wn_w2, const float* wn_b2,
                     const TrainExtras& tx, int block_rows, float* out,
                     void* stream) {
  if (nb < 1 || n < 1 || m < 1 || n_mlp < 0 || n_mlp > kMaxMlp)
    return (int)cudaErrorInvalidValue;
  AggArgs a = {query, points, idx, nb, n, m, feats_p, add_q, {}, {}, tx, out};
  a.mlp.n = n_mlp;
  for (int l = 0; l < kMaxMlp; ++l) {
    a.mlp.w[l] = l < n_mlp ? mlp_w[l] : nullptr;
    a.mlp.b[l] = l < n_mlp ? mlp_b[l] : nullptr;
  }
  a.wn = {wn_w0, wn_b0, wn_w1, wn_b1, wn_w2, wn_b2};
  if (block_rows == 0) block_rows = default_block_rows(n_mlp);
  const cudaStream_t st = (cudaStream_t)stream;
  if (block_rows == 128) return launch_shape<4>(a, st);
  if (block_rows == 64) return launch_shape<2>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// queries: queries a block (8 or 32), or 0 for default_knn_queries.
extern "C" int ratrack_knn(const float* query, const float* points,
                           const unsigned char* mask, int nb, int n, int m,
                           int k, int queries, int* idx, void* stream) {
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 || k < 1 || k > knn::kK)
    return (int)cudaErrorInvalidValue;
  if (queries == 0) queries = default_knn_queries(nb, n);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (queries) {
    case 8:
      return launch_knn_tile<8>(query, points, mask, nb, n, m, k, idx, st);
    case 32:
      return launch_knn_tile<32>(query, points, mask, nb, n, m, k, idx, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
                          wn_b2, none, 0, out, stream);
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

// B4 with its block shape forced: block_rows = 64 or 128 pair rows a
// block (0: the default), for measuring the shapes against each other.
extern "C" int ratrack_corr_apply_rows(
    const float* query, const float* points, const int* idx, int nb, int n,
    int m, const float* feats_p, const float* add_q,
    const float* const* mlp_w, const float* const* mlp_b, int n_mlp,
    const float* wn_w0, const float* wn_b0, const float* wn_w1,
    const float* wn_b1, const float* wn_w2, const float* wn_b2,
    int block_rows, float* out, void* stream) {
  const TrainExtras none = {nullptr, {nullptr, nullptr, nullptr}};
  return launch_aggregate(query, points, idx, nb, n, m, feats_p, add_q, mlp_w,
                          mlp_b, n_mlp, wn_w0, wn_b0, wn_w1, wn_b1, wn_w2,
                          wn_b2, none, block_rows, out, stream);
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
                          wn_b2, tx, 0, out, stream);
}
