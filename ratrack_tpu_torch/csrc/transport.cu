// FLOT's unbalanced entropic transport and the flow of its plan (kernel
// B11).
//
// Replaces no TPU kernel: the JAX package runs no FLOT. It was added for
// the FLOT configuration (models/flot.py), whose transport is a dense
// n x m plan per stream (8192 x 8192), which no kernel of the port
// computed. Per stream, from normalised features f (n x C) and g (m x C)
// and the clouds p (n x 3) and q (m x 3), with eps and power =
// gamma / (gamma + eps) read from the device:
//   K_ij = exp(-(1 - f_i . g_j) / eps) where |p_i - q_j|^2 < support2,
//          else 0; d^2 in the difference form ((dx dx + dy dy) + dz dz,
//          each op rounded on its own, as the plain version computes it);
//   a = 1/n, then `iters` times
//     b_j = ((1/m) / (sum_i K_ij a_i + 1e-8))^power
//     a_i = ((1/n) / (sum_j K_ij b_j + 1e-8))^power
//   T = diag(a) K diag(b), flow_i = (T q)_i / (sum_j T_ij + 1e-8) - p_i,
//   computed as a_i (sum_j K_ij b_j q_j) / (a_i sum_j K_ij b_j + 1e-8).
// Every entry of the support is kept, every iteration runs, all float32
// with expf and powf at full precision.
//
// What bounds it on the H100: the n x m x C products of the cost (C =
// 128: 17.2 GFLOP a stream at 8192 points), which the float32 units
// compute (TF32 is a lower precision and is not used): 0.26 ms a stream at
// 67 TFLOP/s. Then the bytes of the passes over the plan. Design, the
// plan's K materialised once (the caller's scratch, n x m floats a
// stream, 268 MB at 8192 points) and read by each pass, rather than its
// tiles recomputed from the 128-deep products on every pass: a pass over
// K costs 268 MB of reads (0.08 ms a stream), a recomputation another
// 0.26 ms of products. Launches, 1 + 2 x iters:
//   transport_cost_kernel  a block a 128 x 128 tile of K of one stream,
//                 256 threads of 8 x 8 outputs each, the products from
//                 8-deep slices of f and g staged (transposed) in shared
//                 memory; the epilogue takes exp, the support and writes
//                 K;
//   transport_cols_kernel  a thread a column j: sum_i K_ij a_i in order of
//                 i (coalesced rows), then b_j;
//   transport_rows_kernel  a warp a row i: sum_j K_ij b_j over float4
//                 columns, a lane's partial sums added by a xor tree,
//                 then a_i; on the last iteration also sum_j K_ij b_j q_j
//                 and the flow.
// Sums run in another order than torch's, so the result differs from the
// plain version (ops/fused_transport.py) in the last bits of each sum.
// One instantiation of each kernel: the shapes are runtime values.

#include "common.cuh"

namespace {

constexpr int kTile = 128;     // rows and columns of K a block
constexpr int kDepth = 8;      // feature channels a shared-memory slice
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kColThreads = 256;
constexpr int kRowWarps = 8;   // rows a block of the row pass
constexpr float kTiny = 1e-8f;

// d^2 of two points in the difference form, each op rounded on its own.
__device__ __forceinline__ float diff_sq(float px, float py, float pz,
                                         float qx, float qy, float qz) {
  const float dx = __fsub_rn(px, qx), dy = __fsub_rn(py, qy),
              dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// grid (ceil(m / 128), ceil(n / 128), B). f (B, n, c), g (B, m, c), c a
// multiple of kDepth, m a multiple of 4.
__global__ void __launch_bounds__(kThreads)
transport_cost_kernel(const float* __restrict__ f, const float* __restrict__ g,
                      const float* __restrict__ p, const float* __restrict__ q,
                      const float* __restrict__ params, int n, int m, int c,
                      float support2, float* __restrict__ kmat) {
  __shared__ __align__(16) float fs[kDepth][kTile];
  __shared__ __align__(16) float gs[kDepth][kTile];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bi = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* fb = f + (size_t)bi * n * c;
  const float* gb = g + (size_t)bi * m * c;
  // the slice load: a float4 of channels a thread, rows tid / 2
  const int lr = tid / 2, lk = (tid % 2) * 4;

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;

  for (int k0 = 0; k0 < c; k0 += kDepth) {
    float4 fv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gv = fv;
    if (i0 + lr < n)
      fv = *reinterpret_cast<const float4*>(fb + (size_t)(i0 + lr) * c + k0 +
                                            lk);
    if (j0 + lr < m)
      gv = *reinterpret_cast<const float4*>(gb + (size_t)(j0 + lr) * c + k0 +
                                            lk);
    __syncthreads();   // the last slice is read
    fs[lk][lr] = fv.x;
    fs[lk + 1][lr] = fv.y;
    fs[lk + 2][lr] = fv.z;
    fs[lk + 3][lr] = fv.w;
    gs[lk][lr] = gv.x;
    gs[lk + 1][lr] = gv.y;
    gs[lk + 2][lr] = gv.z;
    gs[lk + 3][lr] = gv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&fs[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&fs[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&gs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
  }

  const float eps = params[0];
  const float* pb = p + (size_t)bi * n * 3;
  const float* qb = q + (size_t)bi * m * 3;
  float qx[8], qy[8], qz[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int j = j0 + (v < 4 ? tx * 4 + v : 64 + tx * 4 + v - 4);
    const int jj = j < m ? j : m - 1;
    qx[v] = qb[3 * jj];
    qy[v] = qb[3 * jj + 1];
    qz[v] = qb[3 * jj + 2];
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = i0 + (u < 4 ? ty * 4 + u : 64 + ty * 4 + u - 4);
    if (i >= n) continue;
    const float px = pb[3 * i], py = pb[3 * i + 1], pz = pb[3 * i + 2];
    float out[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float cost = __fsub_rn(1.0f, acc[u][v]);
      const float e = expf(__fdiv_rn(-cost, eps));
      out[v] = diff_sq(px, py, pz, qx[v], qy[v], qz[v]) < support2 ? e : 0.0f;
    }
    float* row = kmat + ((size_t)bi * n + i) * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;   // m % 4 == 0: all four or none
      if (j < m)
        *reinterpret_cast<float4*>(row + j) =
            make_float4(out[4 * h], out[4 * h + 1], out[4 * h + 2],
                        out[4 * h + 3]);
    }
  }
}

// grid (ceil(m / 256), B): b_j from the column sums of K weighted by a.
__global__ void __launch_bounds__(kColThreads)
transport_cols_kernel(const float* __restrict__ kmat,
                      const float* __restrict__ a,
                      const float* __restrict__ params, int n, int m,
                      float* __restrict__ b) {
  const int bi = blockIdx.y;
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  if (j >= m) return;
  const float* col = kmat + (size_t)bi * n * m + j;
  const float* ab = a + (size_t)bi * n;
  constexpr int kUnroll = 8;   // loads in flight a thread
  float s = 0.0f;
  int i = 0;
  for (; i + kUnroll <= n; i += kUnroll) {
    float kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) kv[u] = col[(size_t)(i + u) * m];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s = fmaf(kv[u], ab[i + u], s);
  }
  for (; i < n; ++i) s = fmaf(col[(size_t)i * m], ab[i], s);
  const float prob = __fdiv_rn(1.0f, (float)m);
  b[(size_t)bi * m + j] = powf(__fdiv_rn(prob, __fadd_rn(s, kTiny)),
                               params[1]);
}

// grid (ceil(n / 8), B), a warp a row: a_i from the row sums of K weighted
// by b; with `flow` (the last iteration) also the flow of the plan.
__global__ void __launch_bounds__(kRowWarps * 32)
transport_rows_kernel(const float* __restrict__ kmat,
                      const float* __restrict__ b,
                      const float* __restrict__ p, const float* __restrict__ q,
                      const float* __restrict__ params, int n, int m,
                      float* __restrict__ a, float* __restrict__ flow) {
  const int bi = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (i >= n) return;   // a whole warp leaves together
  const float4* row =
      reinterpret_cast<const float4*>(kmat + ((size_t)bi * n + i) * m);
  const float4* bb = reinterpret_cast<const float4*>(b + (size_t)bi * m);
  const float4* qb = reinterpret_cast<const float4*>(q + (size_t)bi * m * 3);
  float s = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int j4 = lane; j4 < m / 4; j4 += 32) {
    const float4 kv = row[j4];
    const float4 bv = bb[j4];
    const float w0 = __fmul_rn(kv.x, bv.x), w1 = __fmul_rn(kv.y, bv.y),
                w2 = __fmul_rn(kv.z, bv.z), w3 = __fmul_rn(kv.w, bv.w);
    s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, w0), w1), w2), w3);
    if (flow != nullptr) {
      // points 4 j4 .. 4 j4 + 3: x0 y0 z0 x1 | y1 z1 x2 y2 | z2 x3 y3 z3
      const float4 q0 = qb[3 * j4], q1 = qb[3 * j4 + 1], q2 = qb[3 * j4 + 2];
      sx = fmaf(w3, q2.y, fmaf(w2, q1.z, fmaf(w1, q0.w, fmaf(w0, q0.x, sx))));
      sy = fmaf(w3, q2.z, fmaf(w2, q1.w, fmaf(w1, q1.x, fmaf(w0, q0.y, sy))));
      sz = fmaf(w3, q2.w, fmaf(w2, q2.x, fmaf(w1, q1.y, fmaf(w0, q0.z, sz))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(ratrack::kFullMask, s, off));
    sx = __fadd_rn(sx, __shfl_xor_sync(ratrack::kFullMask, sx, off));
    sy = __fadd_rn(sy, __shfl_xor_sync(ratrack::kFullMask, sy, off));
    sz = __fadd_rn(sz, __shfl_xor_sync(ratrack::kFullMask, sz, off));
  }
  if (lane != 0) return;
  const float prob = __fdiv_rn(1.0f, (float)n);
  const float ai = powf(__fdiv_rn(prob, __fadd_rn(s, kTiny)), params[1]);
  a[(size_t)bi * n + i] = ai;
  if (flow == nullptr) return;
  const float den = __fadd_rn(__fmul_rn(ai, s), kTiny);
  const float* pi = p + ((size_t)bi * n + i) * 3;
  float* fo = flow + ((size_t)bi * n + i) * 3;
  fo[0] = __fsub_rn(__fdiv_rn(__fmul_rn(ai, sx), den), pi[0]);
  fo[1] = __fsub_rn(__fdiv_rn(__fmul_rn(ai, sy), den), pi[1]);
  fo[2] = __fsub_rn(__fdiv_rn(__fmul_rn(ai, sz), den), pi[2]);
}

}  // namespace

// f (B, n, c), g (B, m, c): the normalised features; p (B, n, 3), q (B, m,
// 3); params (2,): eps, power. kmat: B * n * m floats of scratch; a (B, n)
// holds 1/n on entry and the last a on return, b (B, m) scratch; flow
// (B, n, 3) out. c a multiple of 8, m a multiple of 4, every pointer
// 16-byte aligned, iters >= 1.
extern "C" int ratrack_transport_flow(const float* f, const float* g,
                                      const float* p, const float* q,
                                      const float* params, int nb, int n,
                                      int m, int c, float support2, int iters,
                                      float* kmat, float* a, float* b,
                                      float* flow, void* stream) {
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 || c < kDepth ||
      c % kDepth != 0 || m % 4 != 0 || iters < 1 ||
      (m + kTile - 1) / kTile > 65535 || (n + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  transport_cost_kernel<<<dim3((m + kTile - 1) / kTile,
                               (n + kTile - 1) / kTile, nb),
                          kThreads, 0, st>>>(f, g, p, q, params, n, m, c,
                                             support2, kmat);
  int err = (int)cudaGetLastError();
  for (int it = 0; it < iters && err == 0; ++it) {
    transport_cols_kernel<<<dim3((m + kColThreads - 1) / kColThreads, nb),
                            kColThreads, 0, st>>>(kmat, a, params, n, m, b);
    err = (int)cudaGetLastError();
    if (err != 0) break;
    transport_rows_kernel<<<dim3((n + kRowWarps - 1) / kRowWarps, nb),
                            kRowWarps * 32, 0, st>>>(
        kmat, b, p, q, params, n, m, a, it == iters - 1 ? flow : nullptr);
    err = (int)cudaGetLastError();
  }
  return err;
}
