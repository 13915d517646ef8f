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
// gradients dW_l = h_{l-1}^T dz_l are (B*N*16 x 256)^T (B*N*16 x 256)
// products, 8.6 GFLOP each at B = 8, N = 512, and their input gradients
// dh_{l-1} = dz_l W_l^T as many again; every operand is a (B*N*16, 256)
// array of 67 MB at that size. Design: the four products run on the tensor
// cores as 3xTF32 (each float32 operand split into a TF32 high part and a
// TF32 remainder, three mma.sync m16n8k8 products, hi*lo + lo*hi + hi*hi,
// accumulated in float32: float32's accuracy, not TF32's three digits).
// One launch a layer holds both products (pair_layer_kernel): its first
// blocks take dW as a split-K product (128x128 output tiles over chunks of
// kDwChunk rows, db from the same staged dz), the others dh over 128-row
// tiles with W_l read in its own layout (no transpose) and the leaky'
// epilogue from the stashed sign. Operand tiles come through a 3-stage
// cp.async ring. The WeightNet backward and the product rule run in one
// head launch, the scatters in one tail launch, and one finishing launch
// adds every per-block and per-chunk weight-gradient partial in a fixed
// order in float64: five launches for stage 1, three for stage 2. Only
// the scatters to d_feats_p and d_points use float atomics; every weight
// gradient is identical run to run.

#include "corr_common.cuh"

namespace {

using namespace ratrack::corr;

// WeightNet gradient block: dw0 (3 x 8) | db0 (8) | dw1 (8 x 8) | db1 (8) |
// dw2 (8 x kC) | db2 (kC); ops/fused_correlator_train.py splits it.
constexpr int kWnGrad = 3 * kWnHidden + kWnHidden + kWnHidden * kWnHidden +
                        kWnHidden + kWnHidden * kC + kC;
constexpr int kPad = kC + 1;        // shared row stride of a (kRows, kC) tile

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
  float* w2t = dz0 + kRows * kWnHidden;      // (kC, 8) WeightNet W2^T
  int* sj = reinterpret_cast<int*>(w2t + kC * kWnHidden);
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
    w2t[c * kWnHidden + t] = w2c[t];
    gw2[t] = 0.0f;
  }
  const float b2c = wn.b2[c];
  float gb2 = 0.0f;
  // a query at a time: its 16 slot rows are loaded first, so that their
  // loads are in flight together
  for (int qi = 0; qi < kQ; ++qi) {
    const long long g = q0 + qi;
    const bool live = g < total;
    float hv[kK];
    float d = 0.0f;
    if (live) {
      d = dout[(size_t)g * kC + c];
#pragma unroll
      for (int s = 0; s < kK; ++s)
        hv[s] = h_top != nullptr
                    ? h_top[((size_t)g * kK + s) * kC + c]
                    : feats_p[((size_t)(g / n) * m + sj[qi * kK + s]) * kC + c];
    }
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      const int r = qi * kK + s;
      float dzw = 0.0f;
      if (live) {
        float a = 0.0f;
#pragma unroll
        for (int t = 0; t < kWnHidden; ++t) a = fmaf(g2s[r * kWnHidden + t], w2c[t], a);
        const float w = fmaxf(a + b2c, 0.0f);
        const float h = hv[s];
        const float dh = d * w;
        dz_top[((size_t)g * kK + s) * kC + c] =
            top_act ? (h > 0.0f ? dh : 0.1f * dh) : dh;
        dzw = w > 0.0f ? d * h : 0.0f;
#pragma unroll
        for (int t = 0; t < kWnHidden; ++t)
          gw2[t] = fmaf(g2s[r * kWnHidden + t], dzw, gw2[t]);
        gb2 += dzw;
      }
      dzs[r * kPad + c] = dzw;
    }
  }
  __syncthreads();

  // dL/d(hidden 2) = dzw @ W2^T: four threads a row (neighbouring lanes),
  // each over a quarter of the channels (started 8q apart, so that the
  // warp's 32 reads of dzs fall on 32 banks) for all eight outputs, then
  // added by shuffles
  {
    const int r = tid / 4, q = tid % 4;
    float a[kWnHidden];
#pragma unroll
    for (int t = 0; t < kWnHidden; ++t) a[t] = 0.0f;
    for (int j = 0; j < kC / 4; ++j) {
      const int k = q * (kC / 4) + ((j + 8 * q) & (kC / 4 - 1));
      const float v = dzs[r * kPad + k];
      const float4 lo = *reinterpret_cast<const float4*>(w2t + k * kWnHidden);
      const float4 hi =
          *reinterpret_cast<const float4*>(w2t + k * kWnHidden + 4);
      a[0] = fmaf(v, lo.x, a[0]);
      a[1] = fmaf(v, lo.y, a[1]);
      a[2] = fmaf(v, lo.z, a[2]);
      a[3] = fmaf(v, lo.w, a[3]);
      a[4] = fmaf(v, hi.x, a[4]);
      a[5] = fmaf(v, hi.y, a[5]);
      a[6] = fmaf(v, hi.z, a[6]);
      a[7] = fmaf(v, hi.w, a[7]);
    }
#pragma unroll
    for (int t = 0; t < kWnHidden; ++t) {
      a[t] += __shfl_xor_sync(ratrack::kFullMask, a[t], 1);
      a[t] += __shfl_xor_sync(ratrack::kFullMask, a[t], 2);
    }
    dg2[r * kWnHidden + 2 * q] = a[2 * q];
    dg2[r * kWnHidden + 2 * q + 1] = a[2 * q + 1];
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

// ---- the pair layers on the tensor cores: 3xTF32 mma.sync ----

constexpr int kMmaThreads = 256;    // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBM = 128;            // output tile rows
constexpr int kBN = 128;            // output tile columns
constexpr int kBK = 32;             // depth of a staged operand tile
constexpr int kStages = 3;          // cp.async ring
constexpr int kDwChunk = 1024;      // pair rows of a split-K dW chunk
constexpr int kLdK = kBM + 8;       // stride of a depth-major staged row
constexpr int kLdM = kBK + 4;       // stride of a depth-minor staged row
constexpr int kStageFloats = 2 * kBM * kLdM;   // both operands, >= 2 * kBK * kLdK
constexpr size_t kMmaSmem = sizeof(float) * kStages * kStageFloats;
static_assert(kBM == kBN && kBK * kLdK <= kBM * kLdM, "stage layout");

// What one launch of pair_layer_kernel computes for pair layer l.
struct LayerArgs {
  const float* h;        // (rows, kC) h_{l-1}: dW's left operand
  const float* dz;       // (rows, kC) dz_l
  const float* w;        // (kC, kC) W_l, x @ W layout
  const float* ref;      // (rows, kC) h_{l-1} for leaky', or null
  float* dz_prev;        // (rows, kC) dz_{l-1} = (dz_l W_l^T) * leaky'(ref)
  float* part_w;         // (chunks, kC, kC) dW_l partials
  float* part_b;         // (chunks, kC) db_l partials
  long long rows;
  int chunks;
};

// acc (a warp's 64 x 32 of a 128 x 128 output tile) += A B over one
// staged depth tile of kBK. kDw: A = h^T and B = dz, both staged
// depth-major ([k][m], stride kLdK); else A = dz and B = W^T, both staged
// depth-minor ([m][k], stride kLdM: W's own rows). Lane (g, t) = (lane /
// 4, lane % 4) reads element (g, t) of every fragment: the strides put the
// 32 lanes on 32 banks.
template <bool kDw>
__device__ __forceinline__ void mma_stage(float (&acc)[4][4][4],
                                          const float* as, const float* bs,
                                          int wm, int wn, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    unsigned ah[4][4], al[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = wm + mt * 16 + g + (q & 1) * 8;
        const int k = kk + t + (q >> 1) * 4;
        split_tf32(kDw ? as[k * kLdK + m] : as[m * kLdM + k], ah[mt][q],
                   al[mt][q]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      unsigned bh[2], bl[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = wn + nt * 8 + g, k = kk + t + q * 4;
        split_tf32(kDw ? bs[k * kLdK + n] : bs[n * kLdM + k], bh[q], bl[q]);
      }
      // the small terms first; an accumulator's three products four apart
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_tf32(acc[mt][nt], al[mt], bh);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_tf32(acc[mt][nt], ah[mt], bl);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_tf32(acc[mt][nt], ah[mt], bh);
    }
  }
}

// One pair layer's backward products. Blocks [0, chunks * 4): dW, output
// tile blockIdx % 4 (128 x 128) over the rows of chunk blockIdx / 4, into
// part_w; the tiles of output rows 0..127 also sum the staged dz columns
// (db) into part_b. The rest: dh over 128 rows x 128 columns, times
// leaky'(ref), into dz_prev. Two blocks share an SM. Every partial is a
// fixed function of its block's rows: deterministic.
__global__ void __launch_bounds__(kMmaThreads, 2)
pair_layer_kernel(LayerArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int ndw = a.chunks * 4;
  const bool dw = (int)blockIdx.x < ndw;
  long long k0 = 0, kend = 0, bm0 = 0;
  int bn0 = 0;
  if (dw) {
    const int tile = blockIdx.x % 4;
    k0 = (long long)(blockIdx.x / 4) * kDwChunk;
    kend = min(k0 + kDwChunk, a.rows);
    bm0 = (tile >> 1) * kBM;
    bn0 = (tile & 1) * kBN;
  } else {
    const int b = blockIdx.x - ndw;
    bm0 = (long long)(b >> 1) * kBM;
    bn0 = (b & 1) * kBN;
    kend = kC;
  }
  const int nk = (int)((kend - k0 + kBK - 1) / kBK);
  const bool col_sums = dw && bm0 == 0;

  // stage s of depth tile kt: dW: kBK rows of h (columns bm0..) and of dz
  // (columns bn0..); dh: kBM rows of dz (columns kt * kBK..) and kBN rows
  // of W (the same columns). 1,024 float4 an operand: 4 a thread.
  auto load = [&](int kt) {
    float* as = smem + (kt % kStages) * kStageFloats;
    float* bs = as + kStageFloats / 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kMmaThreads;
      if (dw) {
        const int r = e >> 5, c4 = (e & 31) * 4;
        const long long row = k0 + (long long)kt * kBK + r;
        const bool ok = row < kend;
        const long long src = (ok ? row : 0) * kC;
        cp16(as + r * kLdK + c4, a.h + src + bm0 + c4, ok);
        cp16(bs + r * kLdK + c4, a.dz + src + bn0 + c4, ok);
      } else {
        const int r = e >> 3, c4 = (e & 7) * 4;
        const long long row = bm0 + r;
        const bool ok = row < a.rows;
        const int col = kt * kBK + c4;
        cp16(as + r * kLdM + c4, a.dz + (ok ? row : 0) * kC + col, ok);
        cp16(bs + r * kLdM + c4, a.w + (size_t)(bn0 + r) * kC + col, true);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  double colb = 0.0;

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();   // stage kt has landed; stage kt - 1 is consumed
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_commit();
    const float* as = smem + (kt % kStages) * kStageFloats;
    const float* bs = as + kStageFloats / 2;
    if (dw) {
      mma_stage<true>(acc, as, bs, wm, wn, g, t);
      if (col_sums && tid < kBN)
        for (int r = 0; r < kBK; ++r) colb += (double)bs[r * kLdK + tid];
    } else {
      mma_stage<false>(acc, as, bs, wm, wn, g, t);
    }
  }

  // accumulator (mt, nt): rows g and g + 8, columns 2t and 2t + 1
  if (dw) {
    float* pw = a.part_w + (size_t)(blockIdx.x / 4) * kC * kC;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = bm0 + wm + mt * 16 + g + h * 8;
          const int n = bn0 + wn + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(pw + m * kC + n) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
    if (col_sums && tid < kBN)
      a.part_b[(size_t)(blockIdx.x / 4) * kC + bn0 + tid] = (float)colb;
  } else {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = bm0 + wm + mt * 16 + g + h * 8;
        if (row >= a.rows) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const size_t at = (size_t)row * kC + bn0 + wn + nt * 8 + 2 * t;
          float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          if (a.ref != nullptr) {
            const float2 r = *reinterpret_cast<const float2*>(a.ref + at);
            v.x *= r.x > 0.0f ? 1.0f : 0.1f;
            v.y *= r.y > 0.0f ? 1.0f : 0.1f;
          }
          *reinterpret_cast<float2*>(a.dz_prev + at) = v;
        }
      }
  }
}

// Slot backward over kQ queries (kRows pair rows): dz0 -> d_feats_p[j]
// (float4 atomics), d_add_q = sum_s dz0 (if given), dW_dir partials
// dir^T dz0 (if w_dir), ddir = ddir_wn + dz0 @ W_dir^T -> d_points[j]
// (atomics), d_query = -sum_s ddir.
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
  float* wdt = dd + kRows * 4;        // (kC, 4) W_dir^T
  float* gws = wdt + kC * 4;          // (kQ, 3, kC) W_dir sums by query
  int* sj = reinterpret_cast<int*>(gws + kQ * 3 * kC);
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
  if (w_dir != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) wdt[tid * 4 + i] = w_dir[i * kC + tid];
  }
  __syncthreads();

  // a thread per (query, four channels): the query's slots of dz0, the
  // dPF scatter four channels an atomic, d_add_q, W_dir sums
  {
    const int qi = tid / (kC / 4), c4 = (tid % (kC / 4)) * 4;
    const long long g = q0 + qi;
    const bool live = g < total;
    const int bi = live ? (int)(g / n) : 0;
    float4 sq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float gwd[3][4] = {};
    float4 dv[kK];   // the query's slot rows, loaded first
#pragma unroll
    for (int s = 0; s < kK; ++s)
      dv[s] = live ? *reinterpret_cast<const float4*>(
                         dz0 + ((size_t)g * kK + s) * kC + c4)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      const int r = qi * kK + s;
      const float4 v = dv[s];
      if (live)
        atomicAdd(reinterpret_cast<float4*>(
                      d_feats_p + ((size_t)bi * m + sj[r]) * kC + c4), v);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dzs[r * kPad + c4 + u] = vv[u];
#pragma unroll
        for (int i = 0; i < 3; ++i) gwd[i][u] = fmaf(ds[r * 4 + i], vv[u], gwd[i][u]);
      }
      sq.x += v.x;
      sq.y += v.y;
      sq.z += v.z;
      sq.w += v.w;
    }
    if (live && d_add_q != nullptr)
      *reinterpret_cast<float4*>(d_add_q + (size_t)g * kC + c4) = sq;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) gws[(qi * 3 + i) * kC + c4 + u] = gwd[i][u];
  }
  __syncthreads();
  // this block's W_dir sums, the queries added in order
  if (w_dir != nullptr)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float a = 0.0f;
      for (int qi = 0; qi < kQ; ++qi) a += gws[(qi * 3 + i) * kC + tid];
      wdir_part[((size_t)blockIdx.x * 3 + i) * kC + tid] = a;
    }

  // ddir = ddir_wn + dz0 @ W_dir^T: four threads a row (neighbouring
  // lanes), each over a quarter of the channels as in the head, added by
  // shuffles
  {
    const int r = tid / 4, q = tid % 4;
    float a[3] = {0.0f, 0.0f, 0.0f};
    if (w_dir != nullptr) {
      for (int j = 0; j < kC / 4; ++j) {
        const int k = q * (kC / 4) + ((j + 8 * q) & (kC / 4 - 1));
        const float v = dzs[r * kPad + k];
        a[0] = fmaf(v, wdt[k * 4 + 0], a[0]);
        a[1] = fmaf(v, wdt[k * 4 + 1], a[1]);
        a[2] = fmaf(v, wdt[k * 4 + 2], a[2]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a[i] += __shfl_xor_sync(ratrack::kFullMask, a[i], 1);
        a[i] += __shfl_xor_sync(ratrack::kFullMask, a[i], 2);
      }
    }
    const long long g = q0 + r / kK;
    if (q < 3)
      dd[r * 4 + q] =
          g < total ? ddir_wn[((size_t)g * kK + r % kK) * 3 + q] + a[q] : 0.0f;
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

// The weight-gradient finishes of one backward: segment y adds its nparts
// partials of len floats (part[p * len + e]) into out[e], in a fixed order
// in float64. blockDim (32, 8): thread (x, y) sums parts y, y + 8, ... of
// element blockIdx.x * 32 + x, then row y = 0 adds the eight group sums in
// order.
constexpr int kMaxSegments = 2 + 2 * kMaxMlp;
struct Segment {
  const float* part;
  int nparts, len;
  float* out;
};
struct Finish {
  Segment seg[kMaxSegments];
};

__global__ void __launch_bounds__(256)
finish_kernel(Finish f) {
  __shared__ double red[8][32];
  const Segment& sg = f.seg[blockIdx.y];
  if ((int)blockIdx.x * 32 >= sg.len) return;
  const int e = blockIdx.x * 32 + threadIdx.x;
  double acc = 0.0;
  if (e < sg.len)
    for (int p = threadIdx.y; p < sg.nparts; p += 8)
      acc += (double)sg.part[(size_t)p * sg.len + e];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < sg.len) {
    double tot = 0.0;
    for (int q = 0; q < 8; ++q) tot += red[q][threadIdx.x];
    sg.out[e] = (float)tot;
  }
}

constexpr size_t kHeadSmem =
    sizeof(float) * (kRows * kPad + 5 * kRows * kWnHidden + kRows * 4 +
                     kC * kWnHidden) +
    sizeof(int) * kRows;
constexpr size_t kTailSmem =
    sizeof(float) * (kRows * kPad + 2 * kRows * 4 + kC * 4 + kQ * 3 * kC) +
    sizeof(int) * kRows;

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
// ddir (B*N*kK, 3) and part >= blocks * (kWnGrad + 3 * kC) + n_mlp *
// chunks * (kC * kC + kC) floats, with blocks = ceil(B*N / 4), chunks =
// ceil(B*N*kK / kDwChunk).
extern "C" int ratrack_corr_train_bwd(
    const float* query, const float* points, const int* idx, int nb, int n,
    int m, const float* feats_p, int has_add, const float* w_dir,
    const float* const* mlp_w, int n_mlp, const float* const* stash,
    const float* wn_w0, const float* wn_b0, const float* wn_w1,
    const float* wn_b1, const float* wn_w2, const float* wn_b2,
    const float* dout, float* d_feats_p, float* d_add_q, float* d_query,
    float* d_points, float* d_wdir, float* const* d_mlp_w,
    float* const* d_mlp_b, float* d_wn, float* dz_a, float* dz_b,
    float* ddir, float* part, void* stream) {
  if (nb < 1 || n < 1 || m < 1 || n_mlp < 0 || n_mlp > kMaxMlp ||
      (n_mlp > 0 && stash[0] == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)nb * n;
  const long long rows = total * kK;
  const int blocks = (int)((total + kQ - 1) / kQ);
  const int chunks = (int)((rows + kDwChunk - 1) / kDwChunk);
  const int row_tiles = (int)((rows + kBM - 1) / kBM);
  RATRACK_CHECK(cudaFuncSetAttribute(
      bwd_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kHeadSmem));
  RATRACK_CHECK(cudaFuncSetAttribute(
      pair_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmem));
  RATRACK_CHECK(cudaFuncSetAttribute(
      bwd_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTailSmem));
  // part: the head's WeightNet partials, the tail's W_dir partials, then
  // per pair layer its dW and db partials
  float* wn_part = part;
  float* wdir_part = wn_part + (size_t)blocks * kWnGrad;
  float* layer_part = wdir_part + (size_t)blocks * 3 * kC;
  Finish fin = {};
  int nseg = 0;
  fin.seg[nseg++] = {wn_part, blocks, kWnGrad, d_wn};

  const WnParams wn = {wn_w0, wn_b0, wn_w1, wn_b1, wn_w2, wn_b2};
  const int top_act = (n_mlp > 0 || has_add) ? 1 : 0;
  bwd_head_kernel<<<blocks, kThreads, kHeadSmem, st>>>(
      query, points, idx, nb, n, m, dout, stash[n_mlp], feats_p, top_act, wn,
      dz_a, ddir, wn_part);
  RATRACK_CHECK(cudaGetLastError());

  float* cur = dz_a;
  float* nxt = dz_b;
  for (int l = n_mlp; l >= 1; --l) {
    LayerArgs la;
    la.h = stash[l - 1];
    la.dz = cur;
    la.w = mlp_w[l - 1];
    la.ref = (l - 1 > 0 || has_add) ? stash[l - 1] : nullptr;
    la.dz_prev = nxt;
    la.part_w = layer_part + (size_t)(l - 1) * chunks * (kC * kC + kC);
    la.part_b = la.part_w + (size_t)chunks * kC * kC;
    la.rows = rows;
    la.chunks = chunks;
    fin.seg[nseg++] = {la.part_w, chunks, kC * kC, d_mlp_w[l - 1]};
    fin.seg[nseg++] = {la.part_b, chunks, kC, d_mlp_b[l - 1]};
    pair_layer_kernel<<<chunks * 4 + row_tiles * 2, kMmaThreads, kMmaSmem,
                        st>>>(la);
    RATRACK_CHECK(cudaGetLastError());
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  bwd_tail_kernel<<<blocks, kThreads, kTailSmem, st>>>(
      query, points, idx, nb, n, m, cur, ddir, w_dir, d_feats_p,
      has_add ? d_add_q : nullptr, d_query, d_points, wdir_part);
  RATRACK_CHECK(cudaGetLastError());
  if (w_dir != nullptr) fin.seg[nseg++] = {wdir_part, blocks, 3 * kC, d_wdir};
  int longest = 0;
  for (int i = 0; i < nseg; ++i) longest = max(longest, fin.seg[i].len);
  finish_kernel<<<dim3((longest + 31) / 32, nseg), dim3(32, 8), 0, st>>>(fin);
  return (int)cudaGetLastError();
}
