// Correlator stage, train mode: the backward of kernel B10.
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_correlator_train.py::
// _bwd_kernel (the forward, _fwd_kernel, is the aggregate kernel of
// correlator.cu with dir @ W_dir in layer 1 and its activations stashed:
// ratrack_corr_train_fwd). For each query i and slot s, j = idx[i, s]:
//   h_0 = leaky(feats_p[j] + add_q[i] + dir @ W_dir)   stage 1
//   h_0 = feats_p[j]                                   stage 2
//   h_l = leaky(h_{l-1} @ W_l + b_l), l = 1..n_mlp     (n_mlp = 2 or 0)
//   wn  = WeightNet(dir), dir = points[j] - query[i]   3 -> 8 -> 8 -> 256
//   out[i] = sum_s h_top * wn
// Backward, from dout:
//   dh_top = dout * wn, dwn = dout * h_top -> WeightNet backward (weights,
//     biases, ddir);
//   dz_l = dh_l * leaky'(h_l) (from the sign of the stashed activation);
//   dW_l = h_{l-1}^T dz_l, db_l = sum dz_l, dh_{l-1} = dz_l @ W_l^T;
//   d_slots = dz_0 -> d_feats_p[j] (float atomics), d_add_q = sum_s dz_0,
//   dW_dir = dir^T dz_0, ddir += dz_0 @ W_dir^T -> d_points[j] (atomics),
//   d_query = -sum_s ddir. Selection gets no gradient.
//
// What bounds it on the H100: the two 256x256 pair layers. Their weight
// gradients are (B*N*16 x 256)^T (B*N*16 x 256) products, 8.6 GFLOP each
// at B = 8, N = 512, and their input gradients as many again, in float32
// on the CUDA cores. Design: launches over 64-row blocks. atb_kernel
// computes dW as a split-K product (64x64 output tiles, 4x4 per thread,
// 1,024-row chunks) into per-chunk partials that a fixed-order float64
// reduction adds; rows_matmul_kernel is the forward's register-tiled layer
// (corr_common.cuh) over W^T with the leaky' epilogue. The WeightNet
// backward and the product rule run in one head launch, the scatters in
// one tail launch. Only the scatters to d_feats_p and d_points use float
// atomics; every weight gradient is deterministic.

#include "corr_common.cuh"

namespace {

using namespace ratrack::corr;

// WeightNet gradient block: dw0 (3 x 8) | db0 (8) | dw1 (8 x 8) | db1 (8) |
// dw2 (8 x kC) | db2 (kC); ops/fused_correlator_train.py splits it.
constexpr int kWnGrad = 3 * kWnHidden + kWnHidden + kWnHidden * kWnHidden +
                        kWnHidden + kWnHidden * kC + kC;
constexpr int kPad = kC + 1;        // shared row stride of a (kRows, kC) tile
constexpr int kAtbTile = 64;        // dW output tile
constexpr int kAtbRows = 32;        // rows per shared sub-tile
constexpr int kAtbChunk = 1024;     // rows per split-K chunk

struct WnParams {
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
};

// Product rule and WeightNet backward over kQ queries (kRows pair rows).
// h_top is the stashed top activation, or null for a stage without MLP or
// add_q, whose top is the gathered slot row feats_p[j] itself.
__global__ void __launch_bounds__(kThreads)
bwd_head_kernel(const float* __restrict__ query,
                const float* __restrict__ points, const int* __restrict__ idx,
                int nb, int n, int m, const float* __restrict__ dout,
                const float* __restrict__ h_top,
                const float* __restrict__ feats_p, int top_act, WnParams wn,
                float* __restrict__ dz_top, float* __restrict__ ddir,
                float* __restrict__ wn_part) {
  extern __shared__ float smem[];
  float* dzs = smem;                         // (kRows, kPad) dL/d(wn pre-act)
  float* g1s = dzs + kRows * kPad;           // (kRows, 8) WeightNet hidden 1
  float* g2s = g1s + kRows * kWnHidden;      // (kRows, 8) hidden 2
  float* ds = g2s + kRows * kWnHidden;       // (kRows, 4) directions
  float* dg2 = ds + kRows * 4;               // (kRows, 8)
  float* dz1 = dg2 + kRows * kWnHidden;      // (kRows, 8)
  float* dz0 = dz1 + kRows * kWnHidden;      // (kRows, 8)
  int* sj = reinterpret_cast<int*>(dz0 + kRows * kWnHidden);
  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kQ;
  const long long total = (long long)nb * n;

  if (tid < kRows) {
    const long long g = q0 + tid / kK;
    float d[3] = {0.0f, 0.0f, 0.0f};
    float h1[kWnHidden], h2[kWnHidden];
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) h1[o] = h2[o] = 0.0f;
    int j = 0;
    if (g < total) {
      const int bi = (int)(g / n);
      j = idx[(size_t)g * kK + tid % kK];
      const float* q = query + (size_t)g * 3;
      const float* p = points + ((size_t)bi * m + j) * 3;
      d[0] = p[0] - q[0];
      d[1] = p[1] - q[1];
      d[2] = p[2] - q[2];
      weightnet_hidden(d, wn.w0, wn.b0, wn.w1, wn.b1, h1, h2);
    }
    sj[tid] = j;
#pragma unroll
    for (int o = 0; o < kWnHidden; ++o) {
      g1s[tid * kWnHidden + o] = h1[o];
      g2s[tid * kWnHidden + o] = h2[o];
    }
#pragma unroll
    for (int t = 0; t < 3; ++t) ds[tid * 4 + t] = d[t];
  }
  __syncthreads();

  // one channel a thread: WeightNet output (as the forward computes it),
  // the product rule, and the output layer's weight-gradient sums
  const int c = tid;
  float w2c[kWnHidden], gw2[kWnHidden];
#pragma unroll
  for (int t = 0; t < kWnHidden; ++t) {
    w2c[t] = wn.w2[t * kC + c];
    gw2[t] = 0.0f;
  }
  const float b2c = wn.b2[c];
  float gb2 = 0.0f;
  for (int r = 0; r < kRows; ++r) {
    const long long g = q0 + r / kK;
    float dzw = 0.0f;
    if (g < total) {
      float a = 0.0f;
#pragma unroll
      for (int t = 0; t < kWnHidden; ++t) a = fmaf(g2s[r * kWnHidden + t], w2c[t], a);
      const float w = fmaxf(a + b2c, 0.0f);
      const size_t row = (size_t)g * kK + r % kK;
      const float h = h_top != nullptr
                          ? h_top[row * kC + c]
                          : feats_p[((size_t)(g / n) * m + sj[r]) * kC + c];
      const float d = dout[(size_t)g * kC + c];
      const float dh = d * w;
      dz_top[row * kC + c] = top_act ? (h > 0.0f ? dh : 0.1f * dh) : dh;
      dzw = w > 0.0f ? d * h : 0.0f;
#pragma unroll
      for (int t = 0; t < kWnHidden; ++t)
        gw2[t] = fmaf(g2s[r * kWnHidden + t], dzw, gw2[t]);
      gb2 += dzw;
    }
    dzs[r * kPad + c] = dzw;
  }
  __syncthreads();

  // dL/d(hidden 2) = dzw @ W2^T: four threads a row, two outputs each
  {
    const int r = tid / 4, t0 = (tid % 4) * 2;
    float a0 = 0.0f, a1 = 0.0f;
    for (int k = 0; k < kC; ++k) {
      const float v = dzs[r * kPad + k];
      a0 = fmaf(v, wn.w2[t0 * kC + k], a0);
      a1 = fmaf(v, wn.w2[(t0 + 1) * kC + k], a1);
    }
    dg2[r * kWnHidden + t0] = a0;
    dg2[r * kWnHidden + t0 + 1] = a1;
  }
  __syncthreads();

  // the hidden layers, one row a thread
  if (tid < kRows) {
    const int r = tid;
    float z1[kWnHidden], z0[kWnHidden];
#pragma unroll
    for (int t = 0; t < kWnHidden; ++t)
      z1[t] = g2s[r * kWnHidden + t] > 0.0f ? dg2[r * kWnHidden + t] : 0.0f;
#pragma unroll
    for (int u = 0; u < kWnHidden; ++u) {
      float a = 0.0f;
#pragma unroll
      for (int t = 0; t < kWnHidden; ++t) a = fmaf(z1[t], wn.w1[u * kWnHidden + t], a);
      z0[u] = g1s[r * kWnHidden + u] > 0.0f ? a : 0.0f;
    }
    const long long g = q0 + r / kK;
    if (g < total) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float a = 0.0f;
#pragma unroll
        for (int u = 0; u < kWnHidden; ++u) a = fmaf(z0[u], wn.w0[i * kWnHidden + u], a);
        ddir[((size_t)g * kK + r % kK) * 3 + i] = a;
      }
    }
#pragma unroll
    for (int t = 0; t < kWnHidden; ++t) {
      dz1[r * kWnHidden + t] = z1[t];
      dz0[r * kWnHidden + t] = z0[t];
    }
  }
  __syncthreads();

  // this block's WeightNet gradient sums, rows added in order
  float* part = wn_part + (size_t)blockIdx.x * kWnGrad;
  if (tid < 24) {                       // dw0 (3 x 8)
    const int i = tid / kWnHidden, u = tid % kWnHidden;
    float a = 0.0f;
    for (int r = 0; r < kRows; ++r) a = fmaf(ds[r * 4 + i], dz0[r * kWnHidden + u], a);
    part[tid] = a;
  } else if (tid < 32) {                // db0 (8)
    const int u = tid - 24;
    float a = 0.0f;
    for (int r = 0; r < kRows; ++r) a += dz0[r * kWnHidden + u];
    part[tid] = a;
  } else if (tid < 96) {                // dw1 (8 x 8)
    const int u = (tid - 32) / kWnHidden, t = (tid - 32) % kWnHidden;
    float a = 0.0f;
    for (int r = 0; r < kRows; ++r)
      a = fmaf(g1s[r * kWnHidden + u], dz1[r * kWnHidden + t], a);
    part[tid] = a;
  } else if (tid < 104) {               // db1 (8)
    const int t = tid - 96;
    float a = 0.0f;
    for (int r = 0; r < kRows; ++r) a += dz1[r * kWnHidden + t];
    part[tid] = a;
  }
#pragma unroll
  for (int t = 0; t < kWnHidden; ++t) part[104 + t * kC + c] = gw2[t];
  part[104 + kWnHidden * kC + c] = gb2;
}

// wt = w^T for a (kC, kC) matrix, 32x32 tiles through shared memory.
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ w, float* __restrict__ wt) {
  __shared__ float tile[32][33];
  const int bx = blockIdx.x * 32, by = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;   // 32 x 8
  for (int k = ty; k < 32; k += 8) tile[k][tx] = w[(size_t)(by + k) * kC + bx + tx];
  __syncthreads();
  for (int k = ty; k < 32; k += 8) wt[(size_t)(bx + k) * kC + by + tx] = tile[tx][k];
}

// out[r] = (in[r] @ wt) * leaky'(ref[r]) for kRows rows a block; with
// wt = W^T this is dh_{l-1} = dz_l @ W^T and, through the sign of the
// stashed activation ref (null: no activation), dz_{l-1}.
__global__ void __launch_bounds__(kThreads)
rows_matmul_kernel(const float* __restrict__ in, const float* __restrict__ wt_g,
                   const float* __restrict__ ref, long long rows,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);   // (kRows, kC)
  float* wt = hs + kRows * kC;                   // (kKT, kC)
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  for (int e = tid; e < kRows * (kC / 4); e += kThreads) {
    const long long row = r0 + e / (kC / 4);
    reinterpret_cast<float4*>(hs)[e] =
        row < rows ? reinterpret_cast<const float4*>(in)[row * (kC / 4) + e % (kC / 4)]
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int qq = tid / (kC / 4), col4 = tid % (kC / 4);
  float acc[kK][4];
  tile_layer(wt_g, reinterpret_cast<const float4*>(hs), wt, acc, tid, qq, col4);
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    const long long row = r0 + qq * kK + s;
    if (row >= rows) continue;
    float4 v = make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    if (ref != nullptr) {
      const float4 h = reinterpret_cast<const float4*>(ref)[row * (kC / 4) + col4];
      v.x *= h.x > 0.0f ? 1.0f : 0.1f;
      v.y *= h.y > 0.0f ? 1.0f : 0.1f;
      v.z *= h.z > 0.0f ? 1.0f : 0.1f;
      v.w *= h.w > 0.0f ? 1.0f : 0.1f;
    }
    reinterpret_cast<float4*>(out)[row * (kC / 4) + col4] = v;
  }
}

// Split-K dW: part_w[chunk] = A[chunk rows]^T B[chunk rows] (kC x kC), one
// 64x64 output tile a block (blockIdx.x = i-tile * 4 + o-tile), 4x4 outputs
// a thread; the blocks of i-tile 0 also sum the columns of B (db) into
// part_b[chunk].
__global__ void __launch_bounds__(kThreads)
atb_kernel(const float* __restrict__ A, const float* __restrict__ B,
           long long rows, float* __restrict__ part_w,
           float* __restrict__ part_b) {
  __shared__ float4 as4[kAtbRows * kAtbTile / 4];
  __shared__ float4 bs4[kAtbRows * kAtbTile / 4];
  constexpr int kTiles = kC / kAtbTile;
  constexpr int kT4 = kAtbTile / 4;
  const int ti = blockIdx.x / kTiles, to = blockIdx.x % kTiles;
  const int tid = threadIdx.x, ty = tid / kT4, tx = tid % kT4;
  const long long rbeg = (long long)blockIdx.y * kAtbChunk;
  const long long rend = min(rbeg + kAtbChunk, rows);
  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* B4 = reinterpret_cast<const float4*>(B);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[i][o] = 0.0f;
  float4 colb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long r0 = rbeg; r0 < rend; r0 += kAtbRows) {
    __syncthreads();
    for (int e = tid; e < kAtbRows * kT4; e += kThreads) {
      const long long row = r0 + e / kT4;
      const int c4 = e % kT4;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      as4[e] = row < rend ? A4[row * (kC / 4) + ti * kT4 + c4] : z;
      bs4[e] = row < rend ? B4[row * (kC / 4) + to * kT4 + c4] : z;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kAtbRows; ++rr) {
      const float4 a = as4[rr * kT4 + ty];
      const float4 b = bs4[rr * kT4 + tx];
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
      if (ti == 0 && ty == 0) {
        colb.x += b.x;
        colb.y += b.y;
        colb.z += b.z;
        colb.w += b.w;
      }
    }
  }
  float* pw = part_w + (size_t)blockIdx.y * kC * kC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(pw + (size_t)(ti * kAtbTile + ty * 4 + i) * kC)[to * kT4 + tx] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (ti == 0 && ty == 0)
    reinterpret_cast<float4*>(part_b + (size_t)blockIdx.y * kC)[to * kT4 + tx] = colb;
}

// Slot backward over kQ queries (kRows pair rows), one channel a thread:
// dz0 -> d_feats_p[j] (atomics), d_add_q = sum_s dz0 (if given), dW_dir
// partials dir^T dz0 (if w_dir), ddir = ddir_wn + dz0 @ W_dir^T ->
// d_points[j] (atomics), d_query = -sum_s ddir.
__global__ void __launch_bounds__(kThreads)
bwd_tail_kernel(const float* __restrict__ query,
                const float* __restrict__ points, const int* __restrict__ idx,
                int nb, int n, int m, const float* __restrict__ dz0,
                const float* __restrict__ ddir_wn,
                const float* __restrict__ w_dir, float* __restrict__ d_feats_p,
                float* __restrict__ d_add_q, float* __restrict__ d_query,
                float* __restrict__ d_points, float* __restrict__ wdir_part) {
  extern __shared__ float smem[];
  float* dzs = smem;                  // (kRows, kPad)
  float* ds = dzs + kRows * kPad;     // (kRows, 4) directions
  float* dd = ds + kRows * 4;         // (kRows, 4) ddir
  int* sj = reinterpret_cast<int*>(dd + kRows * 4);
  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kQ;
  const long long total = (long long)nb * n;
  if (tid < kRows) {
    const long long g = q0 + tid / kK;
    float d[3] = {0.0f, 0.0f, 0.0f};
    int j = 0;
    if (g < total) {
      const int bi = (int)(g / n);
      j = idx[(size_t)g * kK + tid % kK];
      const float* q = query + (size_t)g * 3;
      const float* p = points + ((size_t)bi * m + j) * 3;
      d[0] = p[0] - q[0];
      d[1] = p[1] - q[1];
      d[2] = p[2] - q[2];
    }
    sj[tid] = j;
#pragma unroll
    for (int t = 0; t < 3; ++t) ds[tid * 4 + t] = d[t];
  }
  __syncthreads();

  const int c = tid;
  float gwd[3] = {0.0f, 0.0f, 0.0f};
  for (int qi = 0; qi < kQ; ++qi) {
    const long long g = q0 + qi;
    const bool live = g < total;
    const int bi = live ? (int)(g / n) : 0;
    float sq = 0.0f;
    for (int s = 0; s < kK; ++s) {
      const int r = qi * kK + s;
      const float v = live ? dz0[((size_t)g * kK + s) * kC + c] : 0.0f;
      dzs[r * kPad + c] = v;
      if (live) {
        atomicAdd(d_feats_p + ((size_t)bi * m + sj[r]) * kC + c, v);
        sq += v;
#pragma unroll
        for (int i = 0; i < 3; ++i) gwd[i] = fmaf(ds[r * 4 + i], v, gwd[i]);
      }
    }
    if (live && d_add_q != nullptr) d_add_q[(size_t)g * kC + c] = sq;
  }
  if (w_dir != nullptr)
#pragma unroll
    for (int i = 0; i < 3; ++i) wdir_part[((size_t)blockIdx.x * 3 + i) * kC + c] = gwd[i];
  __syncthreads();

  if (tid < kRows * 3) {
    const int r = tid / 3, i = tid % 3;
    const long long g = q0 + r / kK;
    float a = 0.0f;
    if (w_dir != nullptr)
      for (int k = 0; k < kC; ++k) a = fmaf(dzs[r * kPad + k], w_dir[i * kC + k], a);
    dd[r * 4 + i] = g < total ? ddir_wn[((size_t)g * kK + r % kK) * 3 + i] + a : 0.0f;
  }
  __syncthreads();
  if (tid < kRows * 3) {
    const int r = tid / 3, i = tid % 3;
    const long long g = q0 + r / kK;
    if (g < total)
      atomicAdd(d_points + ((size_t)(g / n) * m + sj[r]) * 3 + i, dd[r * 4 + i]);
  }
  if (tid < kQ * 3) {
    const int qi = tid / 3, i = tid % 3;
    const long long g = q0 + qi;
    if (g < total) {
      float a = 0.0f;
      for (int s = 0; s < kK; ++s) a += dd[(qi * kK + s) * 4 + i];
      d_query[(size_t)g * 3 + i] = -a;
    }
  }
}

constexpr size_t kHeadSmem =
    sizeof(float) * (kRows * kPad + 5 * kRows * kWnHidden + kRows * 4) +
    sizeof(int) * kRows;
constexpr size_t kRowsSmem = sizeof(float) * (kRows * kC + kKT * kC);
constexpr size_t kTailSmem =
    sizeof(float) * (kRows * kPad + 2 * kRows * 4) + sizeof(int) * kRows;

#define RATRACK_CHECK(call)                       \
  do {                                            \
    const cudaError_t err_ = (call);              \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

}  // namespace

// Backward of one train correlator stage. Inputs as the forward took them
// (ratrack_corr_train_fwd) plus idx, the stash stash[0..n_mlp] (stash[l]
// null only where the forward stored none: n_mlp == 0 without add_q) and
// dout (B, N, kC). Outputs: d_feats_p and d_points zero-filled by the
// caller; d_add_q / d_wdir null for a stage without them; d_mlp_w/b per
// pair layer; d_wn one kWnGrad block. Scratch: dz_a, dz_b (B*N*kK, kC),
// ddir (B*N*kK, 3), wt (kC, kC), part >= max(blocks * kWnGrad,
// chunks * kC * kC, blocks * 3 * kC) and part_b >= chunks * kC floats,
// with blocks = ceil(B*N / 4), chunks = ceil(B*N*kK / 1024).
extern "C" int ratrack_corr_train_bwd(
    const float* query, const float* points, const int* idx, int nb, int n,
    int m, const float* feats_p, int has_add, const float* w_dir,
    const float* const* mlp_w, int n_mlp, const float* const* stash,
    const float* wn_w0, const float* wn_b0, const float* wn_w1,
    const float* wn_b1, const float* wn_w2, const float* wn_b2,
    const float* dout, float* d_feats_p, float* d_add_q, float* d_query,
    float* d_points, float* d_wdir, float* const* d_mlp_w,
    float* const* d_mlp_b, float* d_wn, float* dz_a, float* dz_b,
    float* ddir, float* wt, float* part, float* part_b, void* stream) {
  if (nb < 1 || n < 1 || m < 1 || n_mlp < 0 || n_mlp > kMaxMlp ||
      (n_mlp > 0 && stash[0] == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)nb * n;
  const long long rows = total * kK;
  const int blocks = (int)((total + kQ - 1) / kQ);
  const int chunks = (int)((rows + kAtbChunk - 1) / kAtbChunk);
  const int row_blocks = (int)((rows + kRows - 1) / kRows);
  RATRACK_CHECK(cudaFuncSetAttribute(
      bwd_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kHeadSmem));
  RATRACK_CHECK(cudaFuncSetAttribute(
      rows_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRowsSmem));
  RATRACK_CHECK(cudaFuncSetAttribute(
      bwd_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTailSmem));

  const WnParams wn = {wn_w0, wn_b0, wn_w1, wn_b1, wn_w2, wn_b2};
  const int top_act = (n_mlp > 0 || has_add) ? 1 : 0;
  bwd_head_kernel<<<blocks, kThreads, kHeadSmem, st>>>(
      query, points, idx, nb, n, m, dout, stash[n_mlp], feats_p, top_act, wn,
      dz_a, ddir, part);
  RATRACK_CHECK(cudaGetLastError());
  RATRACK_CHECK(ratrack::reduce_parts(part, blocks, kWnGrad, d_wn, st));

  float* cur = dz_a;
  float* nxt = dz_b;
  for (int l = n_mlp; l >= 1; --l) {
    atb_kernel<<<dim3((kC / kAtbTile) * (kC / kAtbTile), chunks), kThreads, 0, st>>>(
        stash[l - 1], cur, rows, part, part_b);
    RATRACK_CHECK(cudaGetLastError());
    RATRACK_CHECK(ratrack::reduce_parts(part, chunks, kC * kC, d_mlp_w[l - 1], st));
    RATRACK_CHECK(ratrack::reduce_parts(part_b, chunks, kC, d_mlp_b[l - 1], st));
    transpose_kernel<<<dim3(kC / 32, kC / 32), kThreads, 0, st>>>(mlp_w[l - 1], wt);
    RATRACK_CHECK(cudaGetLastError());
    const float* ref = (l - 1 > 0 || has_add) ? stash[l - 1] : nullptr;
    rows_matmul_kernel<<<row_blocks, kThreads, kRowsSmem, st>>>(cur, wt, ref, rows, nxt);
    RATRACK_CHECK(cudaGetLastError());
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  bwd_tail_kernel<<<blocks, kThreads, kTailSmem, st>>>(
      query, points, idx, nb, n, m, cur, ddir, w_dir, d_feats_p,
      has_add ? d_add_q : nullptr, d_query, d_points, part);
  RATRACK_CHECK(cudaGetLastError());
  if (w_dir != nullptr)
    RATRACK_CHECK(ratrack::reduce_parts(part, blocks, 3 * kC, d_wdir, st));
  return (int)cudaSuccess;
}
