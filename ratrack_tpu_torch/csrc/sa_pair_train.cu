// SA pair and SA scale, train mode: one set-abstraction level at both of
// its radii, or one scale of a level, forward and backward.
//
// Replaces the TPU kernels ratrack_tpu/ops/pallas_sa_train.py::
// _pair_fwd_kernel_pk and _pair_bwd_kernel_pk (fused_sa_pair_train; entries
// ratrack_sa_train_fwd / _bwd) and ::_fwd_kernel and _bwd_kernel with their
// _pk twins (fused_sa_scale_train; entries ratrack_sa_scale_train_fwd /
// _bwd, for levels that are not a pair of equal depth). Each scale runs
// its own blocks of one launch, so the one-scale entries run the same code
// once: a pair equals two one-scale calls bit for bit, except where the
// float atomics of the dPF scatter add in another order.
// For each scale (radius r, ns slots, L layers) and stream:
//   ball query: ns slots per center, CUDA padding (slots past the hit
//     count repeat the first hit; no hit at all gives point 0);
//   z_0 = PF[j] + (x_j - c_i) @ W_xyz       (layer 1: the feature term
//     PF = F @ W1[3:] hoisted outside, the coordinate term in the kernel)
//   a_l = relu(BN_l(z_l)),  z_{l+1} = a_l @ W_{l+1}
//   BN_l: train-mode batch norm, statistics over all M * ns rows of the
//     stream (the duplicate padding slots count)
//   pooled = max over slots of a_{L-1}
// Backward: max-pool (the cotangent is split evenly over ties), ReLU (0 at
// 0), train-mode BN (dz = k (dy - mean dy - xhat mean(dy xhat)),
// k = gamma / sqrt(var + eps)), Dense, and layer 1: dPF[j] += dz_0 and
// dW_xyz = sum over rows of (x_j - c_i)^T dz_0.
//
// Layer 1 takes the coordinates relative to the center in the kernel, as
// the JAX correlator train kernel does (pallas_correlator_train.py:153-
// 163), and not as the difference of two hoisted absolute terms
// (xyz @ W_xyz)[j] - (centers @ W_xyz)[i] (pallas_sa_train.py:1729-1739):
// at radar ranges (tens of metres) that difference, and its backward
// xyz^T dP1 - centers^T dCW, cancel most of float32's digits; measured on
// the 2-stream train step, it made the float32 gradients ten times less
// accurate than the JAX package's own float32 step.
//
// What bounds it on the H100: not FLOPs (at most 8 streams x 16,384 rows
// x a 64x64 layer, ~1 GFLOP a level) but the stream-wide BN reduction
// between every pair of layers, which one TPU program held in VMEM and
// which here spans many blocks. Both directions answer it the same way:
// one launch for all layers of both scales, a thread-block cluster per
// (stream, scale) whose blocks meet after each layer through distributed
// shared memory and add float64 partial sums in rank order (so E[z^2] -
// mu^2 keeps its digits where |mu| >> sigma, and the statistics are
// identical run to run: no float atomics). Forward: select_kernel's ball
// query of both scales, then every layer and the max-pool in one cluster
// launch (fwd_cluster_kernel): two launches. (The ball query inside the
// cluster launch, 64 centers a block, measured slower at every cloud size
// from 512 to 16,384 points: its scans are latency-bound where
// select_kernel spreads a warp a center over the whole card.) Backward:
// the cluster launch and one finishing reduction (see bwd_cluster_kernel);
// only the dPF scatter uses float atomicAdd.

#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxL = 3;            // layers per scale
constexpr int kMaxC = 64;           // widest layer
constexpr int kMaxNs = 32;          // largest nsample
constexpr int kSelWarps = 8;

// One scale of a level. Mirrored field for field by
// ops/fused_sa_train.py::_Scale (ctypes); w[0] and dw[0] are unused.
struct TrainScale {
  const float* pf;             // (B, N, C_0) F @ W1[3:], or null (no features)
  const float* wxyz;           // (3, C_0) coordinate rows of W1
  const float* w[kMaxL];       // w[l]: (C_{l-1}, C_l), x @ W layout
  const float* gamma[kMaxL];   // BN scale of layer l
  const float* beta[kMaxL];    // BN bias of layer l
  int dims[kMaxL];             // C_l
  int n_layers;
  int ns;
  float r2;
  int* idx;                    // (B, M, ns) selected points
  float* z[kMaxL];             // (B, M * ns, C_l) pre-BN activations
  float* mu[kMaxL];            // (B, C_l) batch mean
  float* var[kMaxL];           // (B, C_l) batch variance (biased)
  float* pooled;               // (B, M, C_{L-1})
  const float* dpooled;        // (B, M, C_{L-1})
  float* dy[2];                // (B, M * ns, kMaxC): dL/d(BN output), by parity of l
  float* dpf;                  // (B, N, C_0), zero-filled by the caller
  float* dwxyz;                // (3, C_0)
  float* dw[kMaxL];            // (C_{l-1}, C_l)
  float* dgamma[kMaxL];        // summed over streams
  float* dbeta[kMaxL];
};

__device__ __forceinline__ float rstd_of(float var, float eps) {
  return __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}

// ((z - mu) * rstd) * gamma + beta with every op rounded on its own, so the
// forward max-pool and the backward tie test see the same values.
__device__ __forceinline__ float bn_apply(float z, float mu, float rs,
                                          float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z, mu), rs), g), b);
}

__device__ __forceinline__ float xhat_of(float z, float mu, float rs) {
  return __fmul_rn(__fsub_rn(z, mu), rs);
}

// Ball query of both scales (or of one: nsb = 0, r2b < 0, idx_b null), one
// warp per center: every slot written, with the CUDA padding rule.
__global__ void __launch_bounds__(kSelWarps * 32)
select_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
              const unsigned char* __restrict__ mask, int nb, int n, int m,
              float r2a, int nsa, int* __restrict__ idx_a, float r2b, int nsb,
              int* __restrict__ idx_b) {
  __shared__ int sidx[kSelWarps][2][kMaxNs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kSelWarps + warp;
  if (g >= (long long)nb * m) return;
  const int bi = (int)(g / m);
  const float* c = centers + (size_t)g * 3;
  int ha, hb;
  ratrack::ball_query_pair(
      xyz + (size_t)bi * n * 3,
      mask != nullptr ? mask + (size_t)bi * n : nullptr, n, c[0], c[1], c[2],
      r2a, nsa, r2b, nsb, sidx[warp][0], sidx[warp][1], lane, &ha, &hb);
  for (int t = lane; t < nsa; t += 32)
    idx_a[(size_t)g * nsa + t] = ha > 0 ? sidx[warp][0][t < ha ? t : 0] : 0;
  for (int t = lane; t < nsb; t += 32)
    idx_b[(size_t)g * nsb + t] = hb > 0 ? sidx[warp][1][t < hb ? t : 0] : 0;
}

// (x_j - c_i) @ W_xyz for channel c, the coordinate term of layer 1.
__device__ __forceinline__ float coord_term(const float (&d)[3],
                                            const float* wxyz, int cout,
                                            int c) {
  return fmaf(d[2], wxyz[2 * cout + c],
              fmaf(d[1], wxyz[cout + c], d[0] * wxyz[c]));
}

__device__ __forceinline__ void rel_coords(const float* xb, const float* cb,
                                           int j, long long ci,
                                           float (&d)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = xb[3 * j + i] - cb[3 * ci + i];
}

// ---- the cluster kernels: a thread-block cluster per (stream, scale) ----
//
// The statistics of a batch norm span one stream, so one cluster of
// kCluster blocks owns a stream of one scale (the scale on blockIdx.z: a
// pair is one launch, and a scale runs the same code whichever launch it is
// in). Block r owns the r-th share of the centers, a contiguous run of
// rows (whole slot groups), through every layer: it reads back only rows
// it wrote itself, which come from L2. After each layer a block leaves its
// float64 sums in its own shared memory, the cluster synchronises, and
// every block adds the kCluster partials in rank order through distributed
// shared memory: the same totals everywhere, in a fixed order, no atomics,
// no further launch.

constexpr int kCluster = 8;         // blocks per (stream, scale)
constexpr int kBlock = 512;         // threads per block
constexpr int kTeam = kBlock / 2;   // threads per product of a backward layer
constexpr int kLd = kMaxC + 4;      // row stride of a staged weight matrix
constexpr int kTile = 64 * kMaxC;   // floats of a raw backward tile
constexpr int kStaged = 256 * 20;      // floats of dz / act: 256 rows of 16
constexpr int kGradLen = (kMaxL - 1) * kMaxC * kMaxC + 3 * kMaxC;

struct ScalePair {
  TrainScale s[2];
};

// Offset of dW_l (l >= 1) in a block's flat run of weight-gradient
// partials; l = n_layers gives dW_xyz's.
__host__ __device__ inline int grad_offset(const TrainScale& s, int l) {
  int off = 0;
  for (int j = 1; j < l; ++j) off += s.dims[j - 1] * s.dims[j];
  return off;
}

// Whether rows of c floats from p can go by 16-byte accesses.
__device__ __forceinline__ bool vec16(const void* p, int c) {
  return (c & 3) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Columns c .. c + 3 of a staged row of C floats, zeros past C.
__device__ __forceinline__ float4 row4(const float* row, int c, int C,
                                       bool vec) {
  if (vec) return ld4(row + c);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c + i < C ? row[c + i] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// count floats (a multiple of 4 where vec) from src to shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int count, bool vec) {
  if (vec) {
    for (int e = 4 * threadIdx.x; e < count; e += 4 * kBlock)
      __pipeline_memcpy_async(dst + e, src + e, 16);
  } else {
    for (int e = threadIdx.x; e < count; e += kBlock)
      __pipeline_memcpy_async(dst + e, src + e, 4);
  }
}

// A phase's tile by its widest layer: a stage holds kTile floats a tile, so
// narrow layers take more rows a tile (64 rows of 64 channels, 128 of 32,
// 256 of 16 or fewer), which keeps every thread busy and the tiles few.
// ld: the row stride of dz and act.
struct Tiling {
  int rows, ld;
};

__device__ __forceinline__ Tiling tiling_of(int width) {
  int cm = 16;
  while (cm < width) cm <<= 1;
  Tiling t;
  t.rows = kTile / cm;
  t.ld = cm + 4;
  return t;
}

// The layout of the per-channel phases: thread = (group g, channel c), the
// channels padded to a power of two cp, G groups.
struct Lanes {
  int cp, c, g, G;
};

__device__ __forceinline__ Lanes lanes_of(int C) {
  Lanes t;
  t.cp = 1;
  while (t.cp < C) t.cp <<= 1;
  t.c = threadIdx.x & (t.cp - 1);
  t.g = threadIdx.x / t.cp;
  t.G = kBlock / t.cp;
  return t;
}

// acc += x M for the thread's four rows of x (x points at the first, the
// others rq rows apart, ld floats a row) and four columns of M (wt points
// at them, kLd apart a row of M), over k4 columns of x: the backward's
// dz_l W_l^T and the forward's a_{l-1} W_l.
__device__ __forceinline__ void row_tile(float (&acc)[4][4], const float* dz,
                                         const float* wt, int cout4, int rq,
                                         int ld) {
  for (int c = 0; c < cout4; c += 4) {
    float dv[4][4], wv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d4 = ld4(dz + i * rq * ld + c);
      dv[i][0] = d4.x; dv[i][1] = d4.y; dv[i][2] = d4.z; dv[i][3] = d4.w;
      const float4 w4 = ld4(wt + (c + i) * kLd);
      wv[i][0] = w4.x; wv[i][1] = w4.y; wv[i][2] = w4.z; wv[i][3] = w4.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(dv[i][q], wv[q][j], acc[i][j]);
  }
}

// The sum over the cluster's blocks, in rank order, of the double at `mine`
// in each block's shared memory (the same offset in every block).
__device__ __forceinline__ double cluster_total(const double* mine) {
  cg::cluster_group cluster = cg::this_cluster();
  double tot = 0.0;
  for (int r = 0; r < kCluster; ++r) tot += *cluster.map_shared_rank(mine, r);
  return tot;
}

// ---- forward: the cluster launch after select_kernel ----
//
// The block runs every layer over its rows in tiles (128 rows at 64
// channels, more where the layer is narrower). Layer 1 gathers PF[j] and
// adds the coordinate term from the relative coordinates; a later layer
// brings z_{l-1} (rows the block wrote itself, from L2) into shared memory
// with cp.async one tile ahead, applies BN_{l-1} + ReLU on the way into
// the staged tile, and multiplies it by W_l on 4 x 4 register tiles fed by
// float4 loads. Every thread stores its outputs (z_l, the stash that the
// backward reads) and keeps float64 sums of z and z^2 for its four columns
// from the same registers; the block adds them by row group in order, the
// cluster by rank, and every block derives mu_l and var_l from the totals
// (rank 0 stores them). Last, the max over each center's slots of
// relu(BN(z_{L-1})), from the rows the block wrote.

constexpr int kFwdTile = 2 * kTile;   // floats of a staged forward tile

// Shared memory of fwd_cluster_kernel.
struct FwdSmem {
  double cpart[2][2][kMaxC];          // this block's sums of z, z^2
  float raw[2][kFwdTile];             // stages of the input tile z_{l-1}
  float act[kFwdTile / 4 * 5];        // relu(BN(z_{l-1})), ld = cm + 4
  float w[kMaxC * kLd];               // W_l: (C_{l-1}, C_l)
  float prm[4][kMaxC];                // mu, rstd, gamma, beta of layer l-1
  float stat[2][kMaxC];               // mu, var of the layer just done
};

__global__ void __launch_bounds__(kBlock, 1)
fwd_cluster_kernel(ScalePair pair, const float* __restrict__ xyz,
                   const float* __restrict__ centers, int n, int m,
                   float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const TrainScale& s = pair.s[blockIdx.z];
  const int tid = threadIdx.x, bi = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int ns = s.ns, L = s.n_layers;
  const double count = (double)m * ns;
  // this block's centers and rows, as in bwd_cluster_kernel
  const int cpc = (m + kCluster - 1) / kCluster;
  const int c_lo = min(rank * cpc, m);
  const int ncen = min(cpc, m - c_lo);
  const long long row0 = (long long)bi * m * ns + (long long)c_lo * ns;
  const int nrows = ncen * ns;
  const float* xb = xyz + (size_t)bi * n * 3;
  const float* cb = centers + (size_t)bi * m * 3;

  int par = 0;
  for (int l = 0; l < L; ++l) {
    const int cout = s.dims[l], cin = l > 0 ? s.dims[l - 1] : 0;
    const int cout4 = (cout + 3) & ~3, cin4 = (cin + 3) & ~3;
    int cm = 16;
    while (cm < max(cin, cout)) cm <<= 1;
    const int R = kFwdTile / cm, ld = cm + 4, rq = R >> 2;
    // products: 4 rows (a quarter of the tile apart) x 4 columns a thread
    const int ycols = cout4 >> 2, yrow = tid / ycols, c0 = 4 * (tid % ycols);
    const bool on = yrow < rq;
    float* zout = s.z[l] + (size_t)row0 * cout;
    const bool vo = vec16(zout, cout);
    const float* zin = l > 0 ? s.z[l - 1] + (size_t)row0 * cin : nullptr;
    const bool vi = l > 0 && vec16(zin, cin);
    const int ntiles = (nrows + R - 1) / R;
    auto fetch = [&](int tile) {
      const int r0 = tile * R, nr = min(R, nrows - r0);
      copy_async(sm.raw[tile & 1], zin + (size_t)r0 * cin, nr * cin, vi);
      __pipeline_commit();
    };
    if (l > 0) {
      if (ntiles > 0) fetch(0);
      for (int e = tid; e < kMaxC * kLd; e += kBlock) {
        const int k = e / kLd, c = e - k * kLd;
        sm.w[e] = k < cin && c < cout ? s.w[l][k * cout + c] : 0.0f;
      }
      for (int c = tid; c < kMaxC; c += kBlock) {
        const bool pon = c < cin;
        sm.prm[0][c] = pon ? sm.stat[0][c] : 0.0f;
        sm.prm[1][c] = pon ? rstd_of(sm.stat[1][c], eps) : 0.0f;
        sm.prm[2][c] = pon ? s.gamma[l - 1][c] : 0.0f;
        sm.prm[3][c] = pon ? s.beta[l - 1][c] : 0.0f;
      }
    }
    // layer 1: the thread's four columns of W_xyz and PF
    float wx[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wx[i][j] = l == 0 && c0 + j < cout ? s.wxyz[i * cout + c0 + j] : 0.0f;
    const float* pf = s.pf != nullptr ? s.pf + (size_t)bi * n * cout : nullptr;
    const bool vp = vec16(pf, cout);
    // staging: a thread keeps one group of four input columns
    const int qi = max(cin4 >> 2, 1), si = kBlock / qi;
    const int tci = (tid % qi) * 4, tri = tid / qi;
    float* rel = sm.act;   // layer 1: (rows, 4) relative coordinates and j
    double s1[4] = {0.0, 0.0, 0.0, 0.0}, s2[4] = {0.0, 0.0, 0.0, 0.0};

    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = tile * R, nr = min(R, nrows - r0);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      if (l == 0) {
        __syncthreads();   // the last tile's coordinates are consumed
        for (int r = tid; r < nr; r += kBlock) {
          const int j = s.idx[row0 + r0 + r];
          float d[3];
          rel_coords(xb, cb, j, c_lo + (r0 + r) / ns, d);
          *reinterpret_cast<float4*>(&rel[4 * r]) =
              make_float4(d[0], d[1], d[2], __int_as_float(j));
        }
        __syncthreads();
        if (on) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = yrow + i * rq;
            if (r >= nr) continue;
            const float4 e = ld4(&rel[4 * r]);
            const int j = __float_as_int(e.w);
            const float4 p = pf != nullptr
                                 ? row4(pf + (size_t)j * cout, c0, cout, vp)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[i][q] = pv[q] + fmaf(e.z, wx[2][q],
                                       fmaf(e.y, wx[1][q], e.x * wx[0][q]));
          }
        }
      } else {
        const float* buf = sm.raw[tile & 1];
        __pipeline_wait_prior(0);
        __syncthreads();   // the tile has landed; the last one is consumed
        if (tile + 1 < ntiles) fetch(tile + 1);
        if (tri < si) {
          const float4 pm = ld4(&sm.prm[0][tci]), pr = ld4(&sm.prm[1][tci]);
          const float4 pg = ld4(&sm.prm[2][tci]), pb = ld4(&sm.prm[3][tci]);
          for (int r = tri; r < R; r += si) {
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (r < nr) {
              const float4 z = row4(buf + r * cin, tci, cin, vi);
              v.x = fmaxf(bn_apply(z.x, pm.x, pr.x, pg.x, pb.x), 0.0f);
              v.y = fmaxf(bn_apply(z.y, pm.y, pr.y, pg.y, pb.y), 0.0f);
              v.z = fmaxf(bn_apply(z.z, pm.z, pr.z, pg.z, pb.z), 0.0f);
              v.w = fmaxf(bn_apply(z.w, pm.w, pr.w, pg.w, pb.w), 0.0f);
            }
            *reinterpret_cast<float4*>(&sm.act[r * ld + tci]) = v;
          }
        }
        __syncthreads();
        if (on) row_tile(acc, sm.act + yrow * ld, sm.w + c0, cin4, rq, ld);
      }
      // the stash and this thread's column sums (columns past C_l hold 0)
      if (on) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = yrow + i * rq;
          if (r >= nr) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double v = acc[i][j];
            s1[j] += v;
            s2[j] += v * v;
          }
          float* o = zout + (size_t)(r0 + r) * cout + c0;
          if (vo) {
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + j < cout) o[j] = acc[i][j];
          }
        }
      }
    }
    // the block's sums by row group, in order, then the cluster's by rank
    __syncthreads();   // every read of the staged tiles is done
    double* spart = reinterpret_cast<double*>(sm.raw[0]);   // (rq, 2, C4)
    if (on) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        spart[(yrow * 2 + 0) * cout4 + c0 + j] = s1[j];
        spart[(yrow * 2 + 1) * cout4 + c0 + j] = s2[j];
      }
    }
    __syncthreads();
    if (tid < 2 * cout) {
      const int which = tid / cout, ch = tid % cout;
      double tot = 0.0;
      for (int g = 0; g < rq; ++g) tot += spart[(g * 2 + which) * cout4 + ch];
      sm.cpart[par][which][ch] = tot;
    }
    cluster.sync();
    if (tid < cout) {
      const double mu = cluster_total(&sm.cpart[par][0][tid]) / count;
      const double v = cluster_total(&sm.cpart[par][1][tid]) / count - mu * mu;
      sm.stat[0][tid] = (float)mu;
      sm.stat[1][tid] = (float)(v > 0.0 ? v : 0.0);
      if (rank == 0) {
        s.mu[l][bi * cout + tid] = sm.stat[0][tid];
        s.var[l][bi * cout + tid] = sm.stat[1][tid];
      }
    }
    par ^= 1;
    __syncthreads();
  }

  // -- the max-pool, a thread per (center, channel)
  {
    const int top = L - 1, C = s.dims[top];
    const Lanes t = lanes_of(C);
    if (t.c < C) {
      const float mu = sm.stat[0][t.c], rs = rstd_of(sm.stat[1][t.c], eps);
      const float ga = s.gamma[top][t.c], be = s.beta[top][t.c];
      const float* z = s.z[top] + (size_t)row0 * C + t.c;
      float* po = s.pooled + ((size_t)bi * m + c_lo) * C + t.c;
      for (int cl = t.g; cl < ncen; cl += t.G) {
        float best = -CUDART_INF_F;
        for (int k = 0; k < ns; ++k)
          best = fmaxf(best, fmaxf(bn_apply(z[(size_t)(cl * ns + k) * C], mu,
                                            rs, ga, be), 0.0f));
        po[(size_t)cl * C] = best;
      }
    }
  }
  // no block leaves while another may still read its sums
  cluster.sync();
}

// ---- backward: the cluster launch and finish_kernel ----
//
// The block walks the layers top down, leaving its float64 sums of dy and
// dy * xhat for the cluster after each. The per-block dW / dW_xyz partials
// and the per-stream sums go to scratch, and finish_kernel adds them over
// blocks and streams in a fixed order for every layer of both scales: two
// launches a backward.
//
// Every phase walks the block's rows in tiles (64 rows at 64 channels, more
// where the layer is narrower) that cp.async brings into shared memory one
// tile ahead. A layer's products: dz_l and a_{l-1} are staged once a tile
// (a thread keeps four columns, so the per-channel values are float4 loads
// without bank conflicts), W_l^T once a block; half of the block's threads
// keep 4 x 4 tiles of dW (over the whole run of rows) in registers, the
// other half 4 x 4 tiles of dy_{l-1} (per tile), both fed by float4 loads;
// the column sums are taken from those registers in float64 and meet across
// the block once a layer.

// Shared memory of bwd_cluster_kernel.
struct BwdSmem {
  double red[kBlock * 3];                // block-wide sums, by group
  double cpart[2][2][kMaxC];           // this block's sums of dy, dy * xhat
  float raw[2][3][kTile];              // stages of three raw tiles
  float dz[kStaged];
  float act[kStaged];
  float wt[kMaxC * kLd];               // W_l^T: (C_l, C_{l-1})
  float prm[9][kMaxC];                 // per-channel values, 0 past the width
  float mean[2][kMaxC];                // mean dy, mean dy * xhat of a layer
};

// Every block's cpart[par] summed in rank order -> sm.mean (divided by
// count) in every block; block 0 keeps the sums in ssum (2, kMaxC).
__device__ __forceinline__ void cluster_totals(BwdSmem& sm, int par, int C,
                                               double count,
                                               double* __restrict__ ssum) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x < 2 * C) {
    const int which = threadIdx.x / C, c = threadIdx.x % C;
    const double tot = cluster_total(&sm.cpart[par][which][c]);
    sm.mean[which][c] = (float)(tot / count);
    if (cluster.block_rank() == 0) ssum[which * kMaxC + c] = tot;
  }
  __syncthreads();
}

// One value pair per (group, channel) thread summed over the groups, in
// group order, into cpart[par].
__device__ __forceinline__ void block_sums(BwdSmem& sm, int par, double s1,
                                           double s2, const Lanes& t, int C) {
  if (t.c < C) {
    sm.red[(t.g * 2 + 0) * t.cp + t.c] = s1;
    sm.red[(t.g * 2 + 1) * t.cp + t.c] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    const int which = threadIdx.x / C, ch = threadIdx.x % C;
    double tot = 0.0;
    for (int q = 0; q < t.G; ++q) tot += sm.red[(q * 2 + which) * t.cp + ch];
    sm.cpart[par][which][ch] = tot;
  }
}

// acc += act^T dz over rows first, first + step, ... < rows of a staged
// tile: act and dz point at the thread's four columns of each, ld apart a
// row.
__device__ __forceinline__ void dw_tile(float (&acc)[4][4], const float* act,
                                        const float* dz, int first, int step,
                                        int rows, int ld) {
#pragma unroll 4
  for (int r = first; r < rows; r += step) {
    const float4 a4 = ld4(act + r * ld);
    const float4 d4 = ld4(dz + r * ld);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kBlock, 1)
bwd_cluster_kernel(ScalePair pair, const float* __restrict__ xyz,
                   const float* __restrict__ centers, int n, int m, float eps,
                   double* __restrict__ ssum_all, float* __restrict__ pdw_all) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const TrainScale& s = pair.s[blockIdx.z];
  const int tid = threadIdx.x, bi = blockIdx.y, nb = gridDim.y;
  const int rank = (int)cg::this_cluster().block_rank();
  const int ns = s.ns, top = s.n_layers - 1;
  const double count = (double)m * ns;
  // this block's centers and rows
  const int cpc = (m + kCluster - 1) / kCluster;
  const int c_lo = min(rank * cpc, m);
  const int ncen = min(cpc, m - c_lo);
  const long long row0 = (long long)bi * m * ns + (long long)c_lo * ns;
  const int nrows = ncen * ns;
  // scratch of this scale: ssum (kMaxL, B, 2, kMaxC), pdw (B * kCluster,
  // kGradLen)
  double* ssum = ssum_all + (size_t)blockIdx.z * kMaxL * nb * 2 * kMaxC;
  float* pdw = pdw_all +
      ((size_t)blockIdx.z * nb * kCluster + (size_t)bi * kCluster + rank) *
          kGradLen;
  int par = 0;

  // -- max-pool and the last ReLU: the pooled cotangent goes to every slot
  // whose activation equals the max, split evenly, then through relu' (0
  // at 0). Tiles of whole centers. Pass 1, a thread per (center, channel):
  // the slots' activations, the count of ties, the share. Pass 2, a thread
  // per (row, channel): dy and the sums. (Counting the ties with a thread
  // per row and atomics in shared memory instead measured 10% slower.)
  {
    const int C = s.dims[top];
    const Lanes t = lanes_of(C);
    const Tiling tl = tiling_of(C);
    const int c = t.c, ld = tl.ld;
    const int cpb = max(1, tl.rows / ns);
    const int ntiles = (ncen + cpb - 1) / cpb;
    const float* zt = s.z[top] + (size_t)row0 * C;
    const float* po = s.pooled + ((size_t)bi * m + c_lo) * C;
    const float* dp = s.dpooled + ((size_t)bi * m + c_lo) * C;
    float* dy = s.dy[top & 1] + (size_t)row0 * C;
    const bool vz = vec16(zt, C), vp = vec16(po, C), vd = vec16(dp, C);
    auto fetch = [&](int tile) {
      const int cl0 = tile * cpb, nc = min(cpb, ncen - cl0);
      float(*buf)[kTile] = sm.raw[tile & 1];
      copy_async(buf[0], zt + (size_t)cl0 * ns * C, nc * ns * C, vz);
      copy_async(buf[1], po + (size_t)cl0 * C, nc * C, vp);
      copy_async(buf[2], dp + (size_t)cl0 * C, nc * C, vd);
      __pipeline_commit();
    };
    if (ntiles > 0) fetch(0);
    float mu = 0.0f, rs = 0.0f, ga = 0.0f, be = 0.0f;
    if (c < C) {
      mu = s.mu[top][bi * C + c];
      rs = rstd_of(s.var[top][bi * C + c], eps);
      ga = s.gamma[top][c];
      be = s.beta[top][c];
    }
    double s1 = 0.0, s2 = 0.0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int cl0 = tile * cpb, nc = min(cpb, ncen - cl0);
      const float(*buf)[kTile] = sm.raw[tile & 1];
      __pipeline_wait_prior(0);
      __syncthreads();   // the tile has landed; the last one is consumed
      if (tile + 1 < ntiles) fetch(tile + 1);
      if (c < C)
        for (int cl = t.g; cl < nc; cl += t.G) {
          const float* z = buf[0] + cl * ns * C + c;
          const float best = buf[1][cl * C + c];
          int ties = 0;
          for (int k = 0; k < ns; ++k) {
            const float y = bn_apply(z[k * C], mu, rs, ga, be);
            sm.dz[(cl * ns + k) * ld + c] = y;
            ties += fmaxf(y, 0.0f) == best;
          }
          sm.act[cl * ld + c] =
              ties > 0 ? buf[2][cl * C + c] / (float)ties : 0.0f;
        }
      __syncthreads();
      if (c < C)
        for (int r = t.g; r < nc * ns; r += t.G) {
          const int cl = r / ns;
          const float y = sm.dz[r * ld + c];
          const float d = (fmaxf(y, 0.0f) == buf[1][cl * C + c] && y > 0.0f)
                              ? sm.act[cl * ld + c] : 0.0f;
          dy[((size_t)cl0 * ns + r) * C + c] = d;
          s1 += (double)d;
          s2 += (double)(d * xhat_of(buf[0][r * C + c], mu, rs));
        }
    }
    block_sums(sm, par, s1, s2, t, C);
    cluster_totals(sm, par, C, count, ssum + ((size_t)top * nb + bi) * 2 * kMaxC);
    par ^= 1;
  }

  // -- layers top .. 1:
  //   dz_l = k (dy_l - mean dy_l - xhat_l mean(dy_l xhat_l))   (BN backward)
  //   dW_l partial = a_{l-1}^T dz_l                 (threads 0 .. kTeam - 1)
  //   dy_{l-1} = (dz_l @ W_l^T) * relu'(y_{l-1})    (the other kTeam)
  const int team = tid / kTeam, tt = tid % kTeam;
  for (int l = top; l >= 1; --l) {
    const int cout = s.dims[l], cin = s.dims[l - 1];
    const int cout4 = (cout + 3) & ~3, cin4 = (cin + 3) & ~3;
    const Tiling tl = tiling_of(max(cin, cout));
    const int R = tl.rows, ld = tl.ld;
    for (int c = tid; c < kMaxC; c += kBlock) {
      const bool on = c < cout, pon = c < cin;
      const float rs = on ? rstd_of(s.var[l][bi * cout + c], eps) : 0.0f;
      sm.prm[0][c] = on ? s.gamma[l][c] * rs : 0.0f;
      sm.prm[1][c] = on ? s.mu[l][bi * cout + c] : 0.0f;
      sm.prm[2][c] = rs;
      sm.prm[3][c] = on ? sm.mean[0][c] : 0.0f;
      sm.prm[4][c] = on ? sm.mean[1][c] : 0.0f;
      sm.prm[5][c] = pon ? s.mu[l - 1][bi * cin + c] : 0.0f;
      sm.prm[6][c] = pon ? rstd_of(s.var[l - 1][bi * cin + c], eps) : 0.0f;
      sm.prm[7][c] = pon ? s.gamma[l - 1][c] : 0.0f;
      sm.prm[8][c] = pon ? s.beta[l - 1][c] : 0.0f;
    }
    for (int e = tid; e < kMaxC * kLd; e += kBlock) sm.wt[e] = 0.0f;
    __syncthreads();
    for (int e = tid; e < cin * cout; e += kBlock)
      sm.wt[(e % cout) * kLd + e / cout] = s.w[l][e];

    const float* dyin = s.dy[l & 1] + (size_t)row0 * cout;
    const float* zl = s.z[l] + (size_t)row0 * cout;
    const float* zp = s.z[l - 1] + (size_t)row0 * cin;
    float* dyout = s.dy[(l - 1) & 1] + (size_t)row0 * cin;
    const bool vec_out = vec16(dyin, cout) && vec16(zl, cout);
    const bool vec_in = vec16(zp, cin) && vec16(dyout, cin);
    const int ntiles = (nrows + R - 1) / R;
    auto fetch = [&](int tile) {
      const int r0 = tile * R, nr = min(R, nrows - r0);
      float(*buf)[kTile] = sm.raw[tile & 1];
      copy_async(buf[0], dyin + (size_t)r0 * cout, nr * cout, vec_out);
      copy_async(buf[1], zl + (size_t)r0 * cout, nr * cout, vec_out);
      copy_async(buf[2], zp + (size_t)r0 * cin, nr * cin, vec_in);
      __pipeline_commit();
    };
    if (ntiles > 0) fetch(0);

    // team 0, dW: the (C_{l-1} / 4) x (C_l / 4) tiles of 4 x 4 outputs go
    // round the team's threads; where they are fewer than the threads, wg
    // threads share a tile and each takes every wg-th row.
    // team 1, dy_{l-1}: 4 rows of the tile (a quarter of the tile apart: a
    // warp's threads then read neighbouring rows, which spread over the
    // banks) x 4 columns of C_{l-1} a thread.
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    double s1[4] = {0.0, 0.0, 0.0, 0.0}, s2[4] = {0.0, 0.0, 0.0, 0.0};
    const int wcols = cout4 >> 2, wtiles = (cin4 >> 2) * wcols;
    const int wg = kTeam / wtiles, wtile = tt % wtiles, wrow = tt / wtiles;
    const bool dw_on = team == 0 && wrow < wg;
    const int ycols = cin4 >> 2;
    const int rq = R >> 2, yrow = tt / ycols;
    const bool da_on = team == 1 && yrow < rq;
    const int k0 = 4 * (wtile / wcols);
    const int c0 = team == 0 ? 4 * (wtile % wcols) : 4 * (tt % ycols);
    // staging: a thread keeps one group of four columns and walks the rows
    const int qo = cout4 >> 2, so = kBlock / qo;
    const int tco = (tid % qo) * 4, tro = tid / qo;
    const int qi = cin4 >> 2, si = kBlock / qi;
    const int tci = (tid % qi) * 4, tri = tid / qi;

    for (int tile = 0; tile < ntiles; ++tile) {
      const int nr = min(R, nrows - tile * R);
      const float(*buf)[kTile] = sm.raw[tile & 1];
      __pipeline_wait_prior(0);
      __syncthreads();   // the tile has landed; the last one is consumed
      if (tile + 1 < ntiles) fetch(tile + 1);
      if (tro < so) {
        const float4 pk = ld4(&sm.prm[0][tco]), pm = ld4(&sm.prm[1][tco]);
        const float4 pr = ld4(&sm.prm[2][tco]), py = ld4(&sm.prm[3][tco]);
        const float4 px = ld4(&sm.prm[4][tco]);
        for (int r = tro; r < R; r += so) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (r < nr) {
            const float4 d = row4(buf[0] + r * cout, tco, cout, vec_out);
            const float4 z = row4(buf[1] + r * cout, tco, cout, vec_out);
            v.x = pk.x * (d.x - py.x - xhat_of(z.x, pm.x, pr.x) * px.x);
            v.y = pk.y * (d.y - py.y - xhat_of(z.y, pm.y, pr.y) * px.y);
            v.z = pk.z * (d.z - py.z - xhat_of(z.z, pm.z, pr.z) * px.z);
            v.w = pk.w * (d.w - py.w - xhat_of(z.w, pm.w, pr.w) * px.w);
          }
          *reinterpret_cast<float4*>(&sm.dz[r * ld + tco]) = v;
        }
      }
      if (tri < si) {
        const float4 pm = ld4(&sm.prm[5][tci]), pr = ld4(&sm.prm[6][tci]);
        const float4 pg = ld4(&sm.prm[7][tci]), pb = ld4(&sm.prm[8][tci]);
        for (int r = tri; r < R; r += si) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (r < nr) {
            const float4 z = row4(buf[2] + r * cin, tci, cin, vec_in);
            v.x = fmaxf(bn_apply(z.x, pm.x, pr.x, pg.x, pb.x), 0.0f);
            v.y = fmaxf(bn_apply(z.y, pm.y, pr.y, pg.y, pb.y), 0.0f);
            v.z = fmaxf(bn_apply(z.z, pm.z, pr.z, pg.z, pb.z), 0.0f);
            v.w = fmaxf(bn_apply(z.w, pm.w, pr.w, pg.w, pb.w), 0.0f);
          }
          *reinterpret_cast<float4*>(&sm.act[r * ld + tci]) = v;
        }
      }
      __syncthreads();
      if (dw_on) dw_tile(acc, sm.act + k0, sm.dz + c0, wrow, wg, R, ld);
      if (da_on) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        row_tile(acc, sm.dz + yrow * ld, sm.wt + c0, cout4, rq, ld);
        // relu', the store, and the column sums for the next batch norm
        // (columns past C_{l-1} hold zeros: their act is 0)
        const float4 pm = ld4(&sm.prm[5][c0]), pr = ld4(&sm.prm[6][c0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = yrow + i * rq;
          if (r >= nr) continue;
          const float4 a4 = ld4(&sm.act[r * ld + c0]);
          const float4 z4 = row4(buf[2] + r * cin, c0, cin, vec_in);
          float4 d;
          d.x = a4.x > 0.0f ? acc[i][0] : 0.0f;
          d.y = a4.y > 0.0f ? acc[i][1] : 0.0f;
          d.z = a4.z > 0.0f ? acc[i][2] : 0.0f;
          d.w = a4.w > 0.0f ? acc[i][3] : 0.0f;
          s1[0] += (double)d.x;
          s1[1] += (double)d.y;
          s1[2] += (double)d.z;
          s1[3] += (double)d.w;
          s2[0] += (double)(d.x * xhat_of(z4.x, pm.x, pr.x));
          s2[1] += (double)(d.y * xhat_of(z4.y, pm.y, pr.y));
          s2[2] += (double)(d.z * xhat_of(z4.z, pm.z, pr.z));
          s2[3] += (double)(d.w * xhat_of(z4.w, pm.w, pr.w));
          float* o = dyout + ((size_t)tile * R + r) * cin + c0;
          if (vec_in) {
            *reinterpret_cast<float4*>(o) = d;
          } else {
            const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + j < cin) o[j] = dv[j];
          }
        }
      }
    }
    __syncthreads();   // every read of the staged tiles is done
    // Both teams leave their registers in the (now free) raw stages: team 0
    // its dW tiles, by sharing thread; team 1 its column sums, by row group.
    float* wpart = sm.raw[0][0];                              // (wg, wtiles, 16)
    double* spart = reinterpret_cast<double*>(sm.raw[1][0]);  // (R/4, 2, C4)
    if (dw_on) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&wpart[(wrow * wtiles + wtile) * 16 + 4 * i]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    if (da_on) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        spart[(yrow * 2 + 0) * cin4 + c0 + j] = s1[j];
        spart[(yrow * 2 + 1) * cin4 + c0 + j] = s2[j];
      }
    }
    __syncthreads();
    // this block's dW_l partial (zeros where it owns no row), the sharing
    // threads added in order
    for (int e = tid; e < cin * cout; e += kBlock) {
      const int k = e / cout, c = e - k * cout;
      const int at = ((k >> 2) * wcols + (c >> 2)) * 16 + (k & 3) * 4 + (c & 3);
      float tot = 0.0f;
      for (int g = 0; g < wg; ++g) tot += wpart[g * wtiles * 16 + at];
      pdw[grad_offset(s, l) + e] = tot;
    }
    if (tid < 2 * cin) {
      const int which = tid / cin, ch = tid % cin;
      double tot = 0.0;
      for (int g = 0; g < rq; ++g)
        tot += spart[(g * 2 + which) * cin4 + ch];
      sm.cpart[par][which][ch] = tot;
    }
    cluster_totals(sm, par, cin, count,
                   ssum + ((size_t)(l - 1) * nb + bi) * 2 * kMaxC);
    par ^= 1;
  }

  // -- layer 1: dz_0 from dy_0 (BN backward), dPF[j] += dz_0 (float
  // atomics, four channels at once: slots of many centers hit the same
  // point), and this block's sums of (x_j - c_i)^T dz_0. Tiles of rows of
  // dy_0, z_0 and idx; a row's relative coordinates are loaded while the
  // tile's dz_0 is computed and scattered.
  {
    const int C = s.dims[0], C4 = (C + 3) & ~3;
    const Lanes t = lanes_of(C);
    const Tiling tl = tiling_of(C);
    const int c = t.c, R = tl.rows, ld = tl.ld;
    const float* xb = xyz + (size_t)bi * n * 3;
    const float* cb = centers + (size_t)bi * m * 3;
    const float* dy0 = s.dy[0] + (size_t)row0 * C;
    const float* z0 = s.z[0] + (size_t)row0 * C;
    const float* idxf = reinterpret_cast<const float*>(s.idx) + row0;
    float* dpf = s.dpf != nullptr ? s.dpf + (size_t)bi * n * C : nullptr;
    const bool vy = vec16(dy0, C), vz = vec16(z0, C), va = vec16(dpf, C);
    // whole tiles of idx are 16-byte runs where nsample is a multiple of 4
    const bool vi = vec16(idxf, ns);
    const int ntiles = (nrows + R - 1) / R;
    auto fetch = [&](int tile) {
      const int r0 = tile * R, nr = min(R, nrows - r0);
      float(*buf)[kTile] = sm.raw[tile & 1];
      copy_async(buf[0], dy0 + (size_t)r0 * C, nr * C, vy);
      copy_async(buf[1], z0 + (size_t)r0 * C, nr * C, vz);
      copy_async(buf[2], idxf + r0, nr, vi);
      __pipeline_commit();
    };
    if (ntiles > 0) fetch(0);
    for (int ch = tid; ch < kMaxC; ch += kBlock) {
      const bool on = ch < C;
      const float rs = on ? rstd_of(s.var[0][bi * C + ch], eps) : 0.0f;
      sm.prm[0][ch] = on ? s.gamma[0][ch] * rs : 0.0f;
      sm.prm[1][ch] = on ? s.mu[0][bi * C + ch] : 0.0f;
      sm.prm[2][ch] = rs;
      sm.prm[3][ch] = on ? sm.mean[0][ch] : 0.0f;
      sm.prm[4][ch] = on ? sm.mean[1][ch] : 0.0f;
    }
    const int q = C4 >> 2, so = kBlock / q;
    const int tco = (tid % q) * 4, tro = tid / q;
    float* rel = sm.act;   // (rows, 4) relative coordinates of a tile
    double gw[3] = {0.0, 0.0, 0.0};
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = tile * R, nr = min(R, nrows - r0);
      const float(*buf)[kTile] = sm.raw[tile & 1];
      const int* idx = reinterpret_cast<const int*>(buf[2]);
      __pipeline_wait_prior(0);
      __syncthreads();   // the tile has landed; the last one is consumed
      if (tile + 1 < ntiles) fetch(tile + 1);
      float d[3] = {0.0f, 0.0f, 0.0f};
      if (tid < nr) rel_coords(xb, cb, idx[tid], c_lo + (r0 + tid) / ns, d);
      if (tro < so) {
        const float4 pk = ld4(&sm.prm[0][tco]), pm = ld4(&sm.prm[1][tco]);
        const float4 pr = ld4(&sm.prm[2][tco]), py = ld4(&sm.prm[3][tco]);
        const float4 px = ld4(&sm.prm[4][tco]);
        for (int r = tro; r < nr; r += so) {
          const float4 dy4 = row4(buf[0] + r * C, tco, C, vy);
          const float4 z4 = row4(buf[1] + r * C, tco, C, vz);
          float4 v;
          v.x = pk.x * (dy4.x - py.x - xhat_of(z4.x, pm.x, pr.x) * px.x);
          v.y = pk.y * (dy4.y - py.y - xhat_of(z4.y, pm.y, pr.y) * px.y);
          v.z = pk.z * (dy4.z - py.z - xhat_of(z4.z, pm.z, pr.z) * px.z);
          v.w = pk.w * (dy4.w - py.w - xhat_of(z4.w, pm.w, pr.w) * px.w);
          *reinterpret_cast<float4*>(&sm.dz[r * ld + tco]) = v;
          if (dpf != nullptr) {
            float* o = dpf + (size_t)idx[r] * C + tco;
            if (va) {
              atomicAdd(reinterpret_cast<float4*>(o), v);
            } else {
              const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (tco + i < C) atomicAdd(o + i, vv[i]);
            }
          }
        }
      }
      if (tid < nr) {
#pragma unroll
        for (int i = 0; i < 3; ++i) rel[4 * tid + i] = d[i];
      }
      __syncthreads();
      if (c < C) {
        float f[3] = {0.0f, 0.0f, 0.0f};
        for (int r = t.g; r < nr; r += t.G) {
          const float dz = sm.dz[r * ld + c];
#pragma unroll
          for (int i = 0; i < 3; ++i) f[i] = fmaf(rel[4 * r + i], dz, f[i]);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) gw[i] += (double)f[i];
      }
    }
    __syncthreads();
    if (c < C) {
#pragma unroll
      for (int i = 0; i < 3; ++i) sm.red[(t.g * 3 + i) * t.cp + c] = gw[i];
    }
    __syncthreads();
    if (tid < 3 * C) {
      const int i = tid / C, ch = tid % C;
      double tot = 0.0;
      for (int g = 0; g < t.G; ++g) tot += sm.red[(g * 3 + i) * t.cp + ch];
      pdw[grad_offset(s, s.n_layers) + tid] = (float)tot;
    }
  }
  // no block leaves while another may still read its sums
  cg::this_cluster().sync();
}

// The gradients that sum over blocks and streams, for every layer of the
// scale on blockIdx.y, each added in a fixed order in float64: dW_l and
// dW_xyz over the B * kCluster per-block partials, dbeta_l / dgamma_l over
// the B per-stream sums. blockDim (32, 8), as correlator_train.cu's
// finish_kernel.
__global__ void __launch_bounds__(256)
finish_kernel(ScalePair pair, int nb, const double* __restrict__ ssum_all,
              const float* __restrict__ pdw_all) {
  __shared__ double red[8][32];
  const TrainScale& s = pair.s[blockIdx.y];
  const int L = s.n_layers;
  const int wlen = grad_offset(s, L) + 3 * s.dims[0];
  int blen = 0;
  for (int l = 0; l < L; ++l) blen += 2 * s.dims[l];
  const int e = blockIdx.x * 32 + threadIdx.x;
  if (blockIdx.x * 32 >= wlen + blen) return;
  float* out = nullptr;
  double acc = 0.0;
  if (e < wlen) {
    const float* part = pdw_all + (size_t)blockIdx.y * nb * kCluster * kGradLen;
    for (int p = threadIdx.y; p < nb * kCluster; p += 8)
      acc += (double)part[(size_t)p * kGradLen + e];
    int l = 1;
    while (l < L && e >= grad_offset(s, l + 1)) ++l;
    out = l < L ? s.dw[l] + (e - grad_offset(s, l))
                : s.dwxyz + (e - grad_offset(s, L));
  } else if (e < wlen + blen) {
    int l = 0, off = e - wlen;
    while (off >= 2 * s.dims[l]) off -= 2 * s.dims[l++];
    const int which = off / s.dims[l], c = off % s.dims[l];
    const double* ss = ssum_all +
        ((size_t)blockIdx.y * kMaxL + l) * nb * 2 * kMaxC + which * kMaxC + c;
    for (int bi = threadIdx.y; bi < nb; bi += 8)
      acc += ss[(size_t)bi * 2 * kMaxC];
    out = (which == 0 ? s.dbeta[l] : s.dgamma[l]) + c;
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && out != nullptr) {
    double t = 0.0;
    for (int g = 0; g < 8; ++g) t += red[g][threadIdx.x];
    *out = (float)t;
  }
}

bool valid_scale(const TrainScale& s) {
  if (s.n_layers < 1 || s.n_layers > kMaxL || s.ns < 1 || s.ns > kMaxNs)
    return false;
  for (int l = 0; l < s.n_layers; ++l)
    if (s.dims[l] < 1 || s.dims[l] > kMaxC) return false;
  return true;
}

#define RATRACK_CHECK(call)                       \
  do {                                            \
    const cudaError_t err_ = (call);              \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// The launch shape of a cluster kernel: a cluster of kCluster blocks along
// x per stream (y) and scale (z); attr is the caller's, for the cluster
// attribute.
void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int nb, int nscales, size_t smem, cudaStream_t st) {
  *cfg = {};
  cfg->gridDim = dim3(kCluster, nb, nscales);
  cfg->blockDim = dim3(kBlock);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Scale a and, unless null, scale b in launch order: the scale with more
// rows on blockIdx.z = 0, so that its blocks start first where the card
// cannot hold every cluster at once.
ScalePair order_scales(const TrainScale* a, const TrainScale* b) {
  ScalePair pair = {};
  const bool swap = b != nullptr && b->ns > a->ns;
  pair.s[0] = swap ? *b : *a;
  if (b != nullptr) pair.s[1] = swap ? *a : *b;
  return pair;
}

// Sets the kernel's shared memory and asks once whether the card can place
// one of its clusters: a card that cannot is an error here, not a launch
// that waits.
template <typename Kernel>
cudaError_t prepare_cluster(Kernel kernel, const cudaLaunchConfig_t* cfg,
                            bool* placed) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg->dynamicSmemBytes);
  if (err != cudaSuccess || *placed) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  *placed = true;
  return cudaSuccess;
}

// Forward of scale a and, unless null, scale b: select_kernel's ball
// query of both, then the cluster launch.
int forward_scales(const float* xyz, const float* centers,
                   const unsigned char* mask, int nb, int n, int m, float eps,
                   const TrainScale* a, const TrainScale* b,
                   cudaStream_t st) {
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 || !valid_scale(*a) ||
      (b != nullptr && !valid_scale(*b)))
    return (int)cudaErrorInvalidValue;
  const long long centers_total = (long long)nb * m;
  select_kernel<<<(int)((centers_total + kSelWarps - 1) / kSelWarps),
                  kSelWarps * 32, 0, st>>>(
      xyz, centers, mask, nb, n, m, a->r2, a->ns, a->idx,
      b != nullptr ? b->r2 : -1.0f, b != nullptr ? b->ns : 0,
      b != nullptr ? b->idx : nullptr);
  RATRACK_CHECK(cudaGetLastError());
  const ScalePair pair = order_scales(a, b);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, nb, b != nullptr ? 2 : 1, sizeof(FwdSmem), st);
  static bool placed = false;
  RATRACK_CHECK(prepare_cluster(fwd_cluster_kernel, &cfg, &placed));
  RATRACK_CHECK(cudaLaunchKernelEx(&cfg, fwd_cluster_kernel, pair, xyz,
                                   centers, n, m, eps));
  return (int)cudaSuccess;
}

// Backward of scale a and, unless null, scale b: the cluster launch and the
// finishing reduction.
int backward_scales(const float* xyz, const float* centers, int nb, int n,
                    int m, float eps, const TrainScale* a,
                    const TrainScale* b, double* ssum, float* pdw,
                    cudaStream_t st) {
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 || !valid_scale(*a) ||
      (b != nullptr && !valid_scale(*b)))
    return (int)cudaErrorInvalidValue;
  const ScalePair pair = order_scales(a, b);
  const int nscales = b != nullptr ? 2 : 1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, nb, nscales, sizeof(BwdSmem), st);
  static bool placed = false;
  RATRACK_CHECK(prepare_cluster(bwd_cluster_kernel, &cfg, &placed));
  RATRACK_CHECK(cudaLaunchKernelEx(&cfg, bwd_cluster_kernel, pair, xyz,
                                   centers, n, m, eps, ssum, pdw));
  const int len = kGradLen + 2 * kMaxL * kMaxC;
  finish_kernel<<<dim3((len + 31) / 32, nscales), dim3(32, 8), 0, st>>>(
      pair, nb, ssum, pdw);
  return (int)cudaGetLastError();
}

// How many clusters of a launch of `kernel` the card holds at once, or a
// negative CUDA error code.
template <typename Kernel>
int clusters_held(Kernel kernel, size_t smem, int nb, int nscales) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, nb, nscales, smem, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // namespace

// Scratch (the Python wrapper allocates it, see ops/fused_sa_train.py).
// Forward: none. Backward: ssum (scales, 3, B, 2, 64) float64 and pdw
// (scales, B * 8, 2 * 64 * 64 + 3 * 64) float32, and in every TrainScale
// dy[2] of (B, M * ns, 64) float32 each, 16-byte aligned like z.
// sa, sb point to one TrainScale each (a type of this file only, hence
// void pointers: the C interface must not name it).
extern "C" int ratrack_sa_train_fwd(const float* xyz, const float* centers,
                                    const unsigned char* mask, int nb, int n,
                                    int m, float eps, const void* sa,
                                    const void* sb, void* stream) {
  return forward_scales(xyz, centers, mask, nb, n, m, eps,
                        static_cast<const TrainScale*>(sa),
                        static_cast<const TrainScale*>(sb),
                        (cudaStream_t)stream);
}

extern "C" int ratrack_sa_train_bwd(const float* xyz, const float* centers,
                                    int nb, int n, int m, float eps,
                                    const void* sa, const void* sb,
                                    double* ssum, float* pdw, void* stream) {
  return backward_scales(xyz, centers, nb, n, m, eps,
                         static_cast<const TrainScale*>(sa),
                         static_cast<const TrainScale*>(sb), ssum, pdw,
                         (cudaStream_t)stream);
}

// How many of the backward's clusters the card holds at once (a negative
// CUDA error code if it cannot say).
extern "C" int ratrack_sa_train_bwd_clusters(int nb, int nscales) {
  return clusters_held(bwd_cluster_kernel, sizeof(BwdSmem), nb, nscales);
}

// The same for the forward's clusters.
extern "C" int ratrack_sa_train_fwd_clusters(int nb, int nscales) {
  return clusters_held(fwd_cluster_kernel, sizeof(FwdSmem), nb, nscales);
}

// Kernel B8: one scale of a level, forward and backward; scratch as above.
extern "C" int ratrack_sa_scale_train_fwd(const float* xyz,
                                          const float* centers,
                                          const unsigned char* mask, int nb,
                                          int n, int m, float eps,
                                          const void* scale, void* stream) {
  return forward_scales(xyz, centers, mask, nb, n, m, eps,
                        static_cast<const TrainScale*>(scale), nullptr,
                        (cudaStream_t)stream);
}

extern "C" int ratrack_sa_scale_train_bwd(const float* xyz,
                                          const float* centers, int nb, int n,
                                          int m, float eps, const void* scale,
                                          double* ssum, float* pdw,
                                          void* stream) {
  return backward_scales(xyz, centers, nb, n, m, eps,
                         static_cast<const TrainScale*>(scale), nullptr, ssum,
                         pdw, (cudaStream_t)stream);
}
