// SA pair and SA scale, train mode: one set-abstraction level at both of
// its radii, or one scale of a level, forward and backward.
//
// Replaces the TPU kernels ratrack_tpu/ops/pallas_sa_train.py::
// _pair_fwd_kernel_pk and _pair_bwd_kernel_pk (fused_sa_pair_train; entries
// ratrack_sa_train_fwd / _bwd) and ::_fwd_kernel and _bwd_kernel with their
// _pk twins (fused_sa_scale_train; entries ratrack_sa_scale_train_fwd /
// _bwd, for levels that are not a pair of equal depth). Each scale runs
// its own launches, so the one-scale entries run the per-scale sequence
// once, after the same ball query with an empty second list: a pair equals
// two one-scale calls bit for bit, except where the float atomics of the
// dPF scatter add in another order.
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
// which here spans many blocks. Design: one launch per layer; every block
// applies the previous layer's BN + ReLU on load, multiplies, stores the
// pre-BN activations (the stash the backward reads) and writes per-channel
// partial sums in float64, so E[z^2] - mu^2 keeps its digits where
// |mu| >> sigma. A one-block launch adds the partials in a fixed order: no
// float atomics, so the statistics are identical run to run. The backward
// is again one launch per layer plus fixed-order reductions of per-chunk
// partial sums and per-chunk dW partials; only the final dPF scatter uses
// float atomicAdd. Each scale runs its own launches.

#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kMaxL = 3;            // layers per scale
constexpr int kMaxC = 64;           // widest layer
constexpr int kMaxNs = 32;          // largest nsample
constexpr int kSelWarps = 8;
constexpr int kThreads = 256;
constexpr int kRows = 64;           // rows (center x slot) per tile
constexpr int kPer = kRows * kMaxC / kThreads;
constexpr int kChunkTiles = 8;      // backward layer: tiles per block
constexpr int kRedThreads = 1024;   // statistics reduction, one block
constexpr int kRedGroups = kRedThreads / kMaxC;
constexpr int kCenters = 16;        // layer-1 backward: centers per block

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

// Layer l over kRows rows of stream blockIdx.y (row = center * ns + slot):
//   l == 0: z = PF[j] + (x_j - c_i) @ W_xyz, j = idx[row], i = center
//   l >= 1: z = relu(BN_{l-1}(z_{l-1}[row])) @ W_l
// stores z_l and the tile's per-channel sums of z and z^2 into
// part (B, tiles, 2, kMaxC).
__global__ void __launch_bounds__(kThreads)
fwd_layer_kernel(TrainScale s, const float* __restrict__ xyz,
                 const float* __restrict__ centers, int l, int n, int m,
                 float eps, double* __restrict__ part) {
  extern __shared__ float smem[];
  float* xs = smem;                     // (kRows, C_in) input, then output
  float* ws = xs + kRows * kMaxC;       // (C_in, C_out)
  float* bnp = ws + kMaxC * kMaxC;      // mu, rstd, gamma, beta of layer l-1
  const int tid = threadIdx.x, bi = blockIdx.y, ns = s.ns;
  const long long rows = (long long)m * ns;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nrow = (int)min((long long)kRows, rows - r0);
  const int cout = s.dims[l];
  if (l == 0) {
    const float* pf = s.pf != nullptr ? s.pf + (size_t)bi * n * cout : nullptr;
    const float* xb = xyz + (size_t)bi * n * 3;
    const float* cb = centers + (size_t)bi * m * 3;
    const int* idx = s.idx + (size_t)bi * rows;
    for (int e = tid; e < nrow * cout; e += kThreads) {
      const int r = e / cout, c = e % cout;
      const long long row = r0 + r;
      const int j = idx[row];
      float d[3];
      rel_coords(xb, cb, j, row / ns, d);
      const float v = pf != nullptr ? pf[(size_t)j * cout + c] : 0.0f;
      xs[e] = v + coord_term(d, s.wxyz, cout, c);
    }
  } else {
    const int cin = s.dims[l - 1];
    for (int t = tid; t < cin * cout; t += kThreads) ws[t] = s.w[l][t];
    for (int c = tid; c < cin; c += kThreads) {
      bnp[c] = s.mu[l - 1][bi * cin + c];
      bnp[kMaxC + c] = rstd_of(s.var[l - 1][bi * cin + c], eps);
      bnp[2 * kMaxC + c] = s.gamma[l - 1][c];
      bnp[3 * kMaxC + c] = s.beta[l - 1][c];
    }
    __syncthreads();
    const float* zin = s.z[l - 1] + ((size_t)bi * rows + r0) * cin;
    for (int e = tid; e < nrow * cin; e += kThreads) {
      const int c = e % cin;
      xs[e] = fmaxf(bn_apply(zin[e], bnp[c], bnp[kMaxC + c],
                             bnp[2 * kMaxC + c], bnp[3 * kMaxC + c]), 0.0f);
    }
    __syncthreads();
    float res[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      res[i] = 0.0f;
      if (e < nrow * cout) {
        const int r = e / cout, c = e % cout;
        float acc = 0.0f;
        for (int q = 0; q < cin; ++q)
          acc = fmaf(xs[r * cin + q], ws[q * cout + c], acc);
        res[i] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < nrow * cout) xs[e] = res[i];
    }
  }
  __syncthreads();
  float* zout = s.z[l] + ((size_t)bi * rows + r0) * cout;
  for (int e = tid; e < nrow * cout; e += kThreads) zout[e] = xs[e];
  if (tid < cout) {
    double s1 = 0.0, s2 = 0.0;
    for (int r = 0; r < nrow; ++r) {
      const double v = xs[r * cout + tid];
      s1 += v;
      s2 += v * v;
    }
    double* p = part + ((size_t)bi * gridDim.x + blockIdx.x) * 2 * kMaxC;
    p[tid] = s1;
    p[kMaxC + tid] = s2;
  }
}

// Adds the partial sums part (B, nblk, 2, kMaxC) of layer l over blocks in
// a fixed order, stream by stream. Forward: mu and var of every stream
// (count rows each). Backward: the per-stream sums of dy and dy * xhat into
// ssum (B, 2, kMaxC), and dbeta / dgamma of layer l summed over streams.
__global__ void __launch_bounds__(kRedThreads)
reduce_stats_kernel(TrainScale s, int l, int nb, int nblk, double count,
                    int backward, const double* __restrict__ part,
                    double* __restrict__ ssum) {
  __shared__ double red[kRedGroups][2][kMaxC];
  const int c = threadIdx.x % kMaxC, grp = threadIdx.x / kMaxC;
  const int C = s.dims[l];
  double tot1 = 0.0, tot2 = 0.0;
  for (int bi = 0; bi < nb; ++bi) {
    double s1 = 0.0, s2 = 0.0;
    if (c < C)
      for (int t = grp; t < nblk; t += kRedGroups) {
        const double* p = part + ((size_t)bi * nblk + t) * 2 * kMaxC;
        s1 += p[c];
        s2 += p[kMaxC + c];
      }
    red[grp][0][c] = s1;
    red[grp][1][c] = s2;
    __syncthreads();
    if (grp == 0 && c < C) {
      double a = 0.0, q = 0.0;
      for (int g = 0; g < kRedGroups; ++g) {
        a += red[g][0][c];
        q += red[g][1][c];
      }
      if (backward) {
        ssum[(size_t)bi * 2 * kMaxC + c] = a;
        ssum[(size_t)bi * 2 * kMaxC + kMaxC + c] = q;
        tot1 += a;
        tot2 += q;
      } else {
        const double mu = a / count;
        const double v = q / count - mu * mu;
        s.mu[l][bi * C + c] = (float)mu;
        s.var[l][bi * C + c] = (float)(v > 0.0 ? v : 0.0);
      }
    }
    __syncthreads();
  }
  if (backward && grp == 0 && c < C) {
    s.dbeta[l][c] = (float)tot1;
    s.dgamma[l][c] = (float)tot2;
  }
}

// pooled[b, center, c] = max over slots of relu(BN_{L-1}(z_{L-1})).
__global__ void __launch_bounds__(kThreads)
pool_kernel(TrainScale s, int nb, int m, float eps) {
  const int L = s.n_layers - 1, C = s.dims[L], ns = s.ns;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)nb * m * C) return;
  const int c = (int)(e % C);
  const long long g = e / C;            // stream * m + center
  const int bi = (int)(g / m);
  const float mu = s.mu[L][bi * C + c];
  const float rs = rstd_of(s.var[L][bi * C + c], eps);
  const float ga = s.gamma[L][c], be = s.beta[L][c];
  const float* z = s.z[L] + (size_t)g * ns * C + c;
  float best = -CUDART_INF_F;
  for (int t = 0; t < ns; ++t)
    best = fmaxf(best, fmaxf(bn_apply(z[(size_t)t * C], mu, rs, ga, be), 0.0f));
  s.pooled[e] = best;
}

// Backward of the max-pool and the last ReLU over cpb centers per block:
// the pooled cotangent goes to every slot whose activation equals the max,
// split evenly, then through relu' (0 at 0). Stores dy_{L-1} and the
// block's per-channel sums of dy and dy * xhat.
__global__ void __launch_bounds__(kThreads)
bwd_top_kernel(TrainScale s, int m, int cpb, float eps,
               double* __restrict__ part) {
  extern __shared__ float smem[];
  float* dyt = smem;                  // (cpb * ns, C)
  float* dxt = dyt + kRows * kMaxC;   // dy * xhat
  const int L = s.n_layers - 1, C = s.dims[L], ns = s.ns;
  const int bi = blockIdx.y;
  const int c0 = blockIdx.x * cpb;
  const int ncen = min(cpb, m - c0);
  for (int e = threadIdx.x; e < ncen * C; e += kThreads) {
    const int cl = e / C, c = e % C;
    const long long g = (long long)bi * m + c0 + cl;
    const float mu = s.mu[L][bi * C + c];
    const float rs = rstd_of(s.var[L][bi * C + c], eps);
    const float ga = s.gamma[L][c], be = s.beta[L][c];
    const float* z = s.z[L] + (size_t)g * ns * C + c;
    const float best = s.pooled[g * C + c];
    int ties = 0;
    for (int t = 0; t < ns; ++t)
      ties += fmaxf(bn_apply(z[(size_t)t * C], mu, rs, ga, be), 0.0f) == best;
    const float share = ties > 0 ? s.dpooled[g * C + c] / (float)ties : 0.0f;
    float* dy = s.dy[L & 1] + (size_t)g * ns * C + c;
    for (int t = 0; t < ns; ++t) {
      const float zv = z[(size_t)t * C];
      const float y = bn_apply(zv, mu, rs, ga, be);
      const float d = (fmaxf(y, 0.0f) == best && y > 0.0f) ? share : 0.0f;
      dy[(size_t)t * C] = d;
      dyt[(cl * ns + t) * C + c] = d;
      dxt[(cl * ns + t) * C + c] = d * xhat_of(zv, mu, rs);
    }
  }
  __syncthreads();
  if (threadIdx.x < C) {
    double s1 = 0.0, s2 = 0.0;
    for (int r = 0; r < ncen * ns; ++r) {
      s1 += dyt[r * C + threadIdx.x];
      s2 += dxt[r * C + threadIdx.x];
    }
    double* p = part + ((size_t)bi * gridDim.x + blockIdx.x) * 2 * kMaxC;
    p[threadIdx.x] = s1;
    p[kMaxC + threadIdx.x] = s2;
  }
}

// Layer l >= 1 backward over a chunk of kChunkTiles * kRows rows:
//   dz_l = k (dy_l - mean dy_l - xhat_l mean(dy_l xhat_l))   (BN backward)
//   dW_l partial = a_{l-1}^T dz_l                (into pdw, one per chunk)
//   dy_{l-1} = (dz_l @ W_l^T) * relu'(y_{l-1})
// and the chunk's per-channel sums of dy_{l-1} and dy_{l-1} * xhat_{l-1}.
__global__ void __launch_bounds__(kThreads)
bwd_layer_kernel(TrainScale s, int l, int m, float eps,
                 const double* __restrict__ ssum, double count,
                 float* __restrict__ pdw, double* __restrict__ part) {
  extern __shared__ float smem[];
  float* dzs = smem;                    // (kRows, C_l) dz_l, then dy_{l-1}
  float* as = dzs + kRows * kMaxC;      // (kRows, C_{l-1}) a, then dy * xhat
  float* wt = as + kRows * kMaxC;       // (C_l, C_{l-1}) = W_l^T
  float* prm = wt + kMaxC * kMaxC;      // 9 x kMaxC per-channel values
  const int tid = threadIdx.x, bi = blockIdx.y;
  const int cout = s.dims[l], cin = s.dims[l - 1];
  const long long rows = (long long)m * s.ns;
  for (int c = tid; c < cout; c += kThreads) {
    const float rs = rstd_of(s.var[l][bi * cout + c], eps);
    prm[c] = s.gamma[l][c] * rs;
    prm[kMaxC + c] = s.mu[l][bi * cout + c];
    prm[2 * kMaxC + c] = rs;
    prm[3 * kMaxC + c] = (float)(ssum[(size_t)bi * 2 * kMaxC + c] / count);
    prm[4 * kMaxC + c] =
        (float)(ssum[(size_t)bi * 2 * kMaxC + kMaxC + c] / count);
  }
  for (int c = tid; c < cin; c += kThreads) {
    prm[5 * kMaxC + c] = s.mu[l - 1][bi * cin + c];
    prm[6 * kMaxC + c] = rstd_of(s.var[l - 1][bi * cin + c], eps);
    prm[7 * kMaxC + c] = s.gamma[l - 1][c];
    prm[8 * kMaxC + c] = s.beta[l - 1][c];
  }
  for (int t = tid; t < cin * cout; t += kThreads)
    wt[(t % cout) * cin + t / cout] = s.w[l][t];
  __syncthreads();

  float dwacc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dwacc[i] = 0.0f;
  double s1 = 0.0, s2 = 0.0;
  const long long chunk0 = (long long)blockIdx.x * kChunkTiles * kRows;
  for (int tile = 0; tile < kChunkTiles; ++tile) {
    const long long r0 = chunk0 + (long long)tile * kRows;
    if (r0 >= rows) break;
    const int nrow = (int)min((long long)kRows, rows - r0);
    const size_t base = (size_t)bi * rows + r0;
    const float* dyin = s.dy[l & 1] + base * cout;
    const float* zl = s.z[l] + base * cout;
    const float* zp = s.z[l - 1] + base * cin;
    for (int e = tid; e < nrow * cout; e += kThreads) {
      const int c = e % cout;
      const float xh = xhat_of(zl[e], prm[kMaxC + c], prm[2 * kMaxC + c]);
      dzs[e] = prm[c] * (dyin[e] - prm[3 * kMaxC + c] - xh * prm[4 * kMaxC + c]);
    }
    for (int e = tid; e < nrow * cin; e += kThreads) {
      const int c = e % cin;
      as[e] = fmaxf(bn_apply(zp[e], prm[5 * kMaxC + c], prm[6 * kMaxC + c],
                             prm[7 * kMaxC + c], prm[8 * kMaxC + c]), 0.0f);
    }
    __syncthreads();
    float da[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = tid + i * kThreads;
      if (p < cin * cout) {
        const int k = p / cout, c = p % cout;
        float acc = 0.0f;
        for (int r = 0; r < nrow; ++r)
          acc = fmaf(as[r * cin + k], dzs[r * cout + c], acc);
        dwacc[i] += acc;
      }
      da[i] = 0.0f;
      if (p < nrow * cin) {
        const int r = p / cin, k = p % cin;
        float acc = 0.0f;
        for (int c = 0; c < cout; ++c)
          acc = fmaf(dzs[r * cout + c], wt[c * cin + k], acc);
        da[i] = acc;
      }
    }
    __syncthreads();
    float* dyout = s.dy[(l - 1) & 1] + base * cin;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < nrow * cin) {
        const int k = e % cin;
        const float d = as[e] > 0.0f ? da[i] : 0.0f;
        dyout[e] = d;
        dzs[e] = d;
        as[e] = d * xhat_of(zp[e], prm[5 * kMaxC + k], prm[6 * kMaxC + k]);
      }
    }
    __syncthreads();
    if (tid < cin)
      for (int r = 0; r < nrow; ++r) {
        s1 += dzs[r * cin + tid];
        s2 += as[r * cin + tid];
      }
    __syncthreads();
  }
  float* pw = pdw + ((size_t)bi * gridDim.x + blockIdx.x) * cin * cout;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = tid + i * kThreads;
    if (p < cin * cout) pw[p] = dwacc[i];
  }
  if (tid < cin) {
    double* pp = part + ((size_t)bi * gridDim.x + blockIdx.x) * 2 * kMaxC;
    pp[tid] = s1;
    pp[kMaxC + tid] = s2;
  }
}

// Layer-1 backward over kCenters centers of stream blockIdx.y: dz_0 from
// dy_0 (BN backward), dPF[j] += dz_0 (float atomics: slots of many
// centers hit the same point), and this block's sums of
// (x_j - c_i)^T dz_0 into pwx (B, blocks, 3, C_0).
__global__ void __launch_bounds__(kThreads)
bwd_layer0_kernel(TrainScale s, const float* __restrict__ xyz,
                  const float* __restrict__ centers, int n, int m,
                  float eps, const double* __restrict__ ssum, double count,
                  float* __restrict__ pwx) {
  __shared__ float contrib[kCenters][3][kMaxC];
  const int C = s.dims[0], ns = s.ns, bi = blockIdx.y;
  const int c0 = blockIdx.x * kCenters;
  const int ncen = min(kCenters, m - c0);
  const float* xb = xyz + (size_t)bi * n * 3;
  const float* cb = centers + (size_t)bi * m * 3;
  for (int e = threadIdx.x; e < kCenters * C; e += kThreads) {
    const int cl = e / C, c = e % C;
    float gw[3] = {0.0f, 0.0f, 0.0f};
    if (cl < ncen) {
      const long long g = (long long)bi * m + c0 + cl;
      const float mu = s.mu[0][bi * C + c];
      const float rs = rstd_of(s.var[0][bi * C + c], eps);
      const float k = s.gamma[0][c] * rs;
      const float mdy = (float)(ssum[(size_t)bi * 2 * kMaxC + c] / count);
      const float mdx =
          (float)(ssum[(size_t)bi * 2 * kMaxC + kMaxC + c] / count);
      for (int t = 0; t < ns; ++t) {
        const size_t row = (size_t)g * ns + t;
        const int j = s.idx[row];
        const float xh = xhat_of(s.z[0][row * C + c], mu, rs);
        const float dz = k * (s.dy[0][row * C + c] - mdy - xh * mdx);
        if (s.dpf != nullptr)
          atomicAdd(s.dpf + ((size_t)bi * n + j) * C + c, dz);
        float d[3];
        rel_coords(xb, cb, j, c0 + cl, d);
#pragma unroll
        for (int i = 0; i < 3; ++i) gw[i] = fmaf(d[i], dz, gw[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) contrib[cl][i][c] = gw[i];
  }
  __syncthreads();
  if (threadIdx.x < 3 * C) {
    const int i = threadIdx.x / C, c = threadIdx.x % C;
    float a = 0.0f;
    for (int cl = 0; cl < kCenters; ++cl) a += contrib[cl][i][c];
    pwx[((size_t)bi * gridDim.x + blockIdx.x) * 3 * C + threadIdx.x] = a;
  }
}

bool valid_scale(const TrainScale& s) {
  if (s.n_layers < 1 || s.n_layers > kMaxL || s.ns < 1 || s.ns > kMaxNs)
    return false;
  for (int l = 0; l < s.n_layers; ++l)
    if (s.dims[l] < 1 || s.dims[l] > kMaxC) return false;
  return true;
}

constexpr size_t kFwdSmem = sizeof(float) * (kRows * kMaxC + kMaxC * kMaxC + 4 * kMaxC);
constexpr size_t kTopSmem = sizeof(float) * 2 * kRows * kMaxC;
constexpr size_t kLayerSmem =
    sizeof(float) * (2 * kRows * kMaxC + kMaxC * kMaxC + 9 * kMaxC);

#define RATRACK_CHECK(call)                       \
  do {                                            \
    const cudaError_t err_ = (call);              \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// Forward of scale a and, unless null, scale b: one shared ball query, then
// per scale a launch and a statistics reduction per layer and the pool.
int forward_scales(const float* xyz, const float* centers,
                   const unsigned char* mask, int nb, int n, int m, float eps,
                   const TrainScale* a, const TrainScale* b, double* part,
                   cudaStream_t st) {
  if (nb < 1 || n < 1 || m < 1 || !valid_scale(*a) ||
      (b != nullptr && !valid_scale(*b)))
    return (int)cudaErrorInvalidValue;
  const long long centers_total = (long long)nb * m;
  select_kernel<<<(int)((centers_total + kSelWarps - 1) / kSelWarps),
                  kSelWarps * 32, 0, st>>>(
      xyz, centers, mask, nb, n, m, a->r2, a->ns, a->idx,
      b != nullptr ? b->r2 : -1.0f, b != nullptr ? b->ns : 0,
      b != nullptr ? b->idx : nullptr);
  RATRACK_CHECK(cudaGetLastError());
  const TrainScale* const scales[2] = {a, b};
  for (const TrainScale* s : scales) {
    if (s == nullptr) continue;
    const long long rows = (long long)m * s->ns;
    const int tiles = (int)((rows + kRows - 1) / kRows);
    for (int l = 0; l < s->n_layers; ++l) {
      fwd_layer_kernel<<<dim3(tiles, nb), kThreads, kFwdSmem, st>>>(
          *s, xyz, centers, l, n, m, eps, part);
      RATRACK_CHECK(cudaGetLastError());
      reduce_stats_kernel<<<1, kRedThreads, 0, st>>>(*s, l, nb, tiles,
                                                     (double)rows, 0, part,
                                                     nullptr);
      RATRACK_CHECK(cudaGetLastError());
    }
    const long long outs = centers_total * s->dims[s->n_layers - 1];
    pool_kernel<<<(int)((outs + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        *s, nb, m, eps);
    RATRACK_CHECK(cudaGetLastError());
  }
  return (int)cudaSuccess;
}

// Backward of scale a and, unless null, scale b, each on its own.
int backward_scales(const float* xyz, const float* centers, int nb, int n,
                    int m, float eps, const TrainScale* a,
                    const TrainScale* b, double* part, double* ssum,
                    float* pdw, cudaStream_t st) {
  if (nb < 1 || n < 1 || m < 1 || !valid_scale(*a) ||
      (b != nullptr && !valid_scale(*b)))
    return (int)cudaErrorInvalidValue;
  RATRACK_CHECK(cudaFuncSetAttribute(
      bwd_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kLayerSmem));
  const TrainScale* const scales[2] = {a, b};
  for (const TrainScale* s : scales) {
    if (s == nullptr) continue;
    const int top = s->n_layers - 1;
    const long long rows = (long long)m * s->ns;
    const double count = (double)rows;
    const int cpb = kRows / s->ns;
    const int top_blocks = (m + cpb - 1) / cpb;
    bwd_top_kernel<<<dim3(top_blocks, nb), kThreads, kTopSmem, st>>>(
        *s, m, cpb, eps, part);
    RATRACK_CHECK(cudaGetLastError());
    reduce_stats_kernel<<<1, kRedThreads, 0, st>>>(*s, top, nb, top_blocks,
                                                   count, 1, part, ssum);
    RATRACK_CHECK(cudaGetLastError());
    const int chunks =
        (int)((rows + kChunkTiles * kRows - 1) / (kChunkTiles * kRows));
    for (int l = top; l >= 1; --l) {
      bwd_layer_kernel<<<dim3(chunks, nb), kThreads, kLayerSmem, st>>>(
          *s, l, m, eps, ssum, count, pdw, part);
      RATRACK_CHECK(cudaGetLastError());
      RATRACK_CHECK(ratrack::reduce_parts(
          pdw, nb * chunks, s->dims[l - 1] * s->dims[l], s->dw[l], st));
      reduce_stats_kernel<<<1, kRedThreads, 0, st>>>(*s, l - 1, nb, chunks,
                                                     count, 1, part, ssum);
      RATRACK_CHECK(cudaGetLastError());
    }
    const int cblocks = (m + kCenters - 1) / kCenters;
    bwd_layer0_kernel<<<dim3(cblocks, nb), kThreads, 0, st>>>(
        *s, xyz, centers, n, m, eps, ssum, count, pdw);
    RATRACK_CHECK(cudaGetLastError());
    RATRACK_CHECK(ratrack::reduce_parts(pdw, nb * cblocks, 3 * s->dims[0],
                                        s->dwxyz, st));
  }
  return (int)cudaSuccess;
}

}  // namespace

// Scratch sizes (the Python wrapper allocates them, see
// ops/fused_sa_train.py): part >= B * max(tiles) * 2 * 64 float64, where
// tiles is ceil(M * ns / 64) forward, ceil(M / (64 / ns)) at the top of
// the backward and ceil(M * ns / 512) per backward layer; ssum B * 2 * 64
// float64; pdw >= B * max(ceil(M * ns / 512) * 64 * 64,
// ceil(M / 16) * 3 * 64) float32.
// sa, sb point to one TrainScale each (a type of this file only, hence
// void pointers: the C interface must not name it).
extern "C" int ratrack_sa_train_fwd(const float* xyz, const float* centers,
                                    const unsigned char* mask, int nb, int n,
                                    int m, float eps, const void* sa,
                                    const void* sb, double* part,
                                    void* stream) {
  return forward_scales(xyz, centers, mask, nb, n, m, eps,
                        static_cast<const TrainScale*>(sa),
                        static_cast<const TrainScale*>(sb), part,
                        (cudaStream_t)stream);
}

extern "C" int ratrack_sa_train_bwd(const float* xyz, const float* centers,
                                    int nb, int n, int m, float eps,
                                    const void* sa, const void* sb,
                                    double* part, double* ssum, float* pdw,
                                    void* stream) {
  return backward_scales(xyz, centers, nb, n, m, eps,
                         static_cast<const TrainScale*>(sa),
                         static_cast<const TrainScale*>(sb), part, ssum, pdw,
                         (cudaStream_t)stream);
}

// Kernel B8: one scale of a level, forward and backward; scratch as above.
extern "C" int ratrack_sa_scale_train_fwd(const float* xyz,
                                          const float* centers,
                                          const unsigned char* mask, int nb,
                                          int n, int m, float eps,
                                          const void* scale, double* part,
                                          void* stream) {
  return forward_scales(xyz, centers, mask, nb, n, m, eps,
                        static_cast<const TrainScale*>(scale), nullptr, part,
                        (cudaStream_t)stream);
}

extern "C" int ratrack_sa_scale_train_bwd(const float* xyz,
                                          const float* centers, int nb, int n,
                                          int m, float eps, const void* scale,
                                          double* part, double* ssum,
                                          float* pdw, void* stream) {
  return backward_scales(xyz, centers, nb, n, m, eps,
                         static_cast<const TrainScale*>(scale), nullptr, part,
                         ssum, pdw, (cudaStream_t)stream);
}
