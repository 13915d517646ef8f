// FP: 3-NN inverse-distance interpolation, fused.
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_fp.py::_fp_kernel
// (fused_three_interpolate). For each unknown point:
//   the 3 nearest valid known points, lowest index on ties; fewer than 3
//   valid points repeat the nearest, none valid gives index 0 with the
//   _BIG distance (so uniform weights);
//   w_k = 1 / (sqrt(d_k^2) + eps), normalised;
//   out = sum_k w_k * feats[j_k].
//
// What bounds it on the H100: not bytes (the clouds, 3 C-wide rows read
// and one written an unknown: 0.006 ms an eval step) nor arithmetic
// (N x M distances, 2 M a stream at 512 x 512) but latency: a launch's
// fixed part, the staging of the known cloud and a dependent merge.
// Design: a block owns a tile of Q unknowns of one stream (blockIdx.y)
// and stages the stream's known cloud once in shared memory as float4
// (x, y, z, |x|^2, or -1 for a masked point), read coalesced from the raw
// (B, M, 3) cloud and mask, kPiece = 4096 at a time (eval has M = 512;
// the stretch fp1 512 centers under 8192 unknowns). G = 8 to 32 lanes an
// unknown (32 at one 512-point stream, 16 at eval, 8 at the stretch fp1):
// each lane keeps a sorted top-3 of its strided share (strict <
// keeps the lowest index, since a lane sees its indices in increasing
// order); the group then merges by a lexicographic (d^2, index) argmin
// over its G lanes, three times, so the lowest index still wins ties. The
// weights are computed as the plain version's op order asks, then the
// group's lanes write the weighted sum of the three rows as float4 (C is
// a multiple of 4).
// Measuring build (kernels/build.py): RATRACK_SKELETON scans one known
// point a lane instead of M / G, the launch's floor (staging, merge and
// the weighted sum), whose outputs are not the function's.

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kPiece = 4096;   // known points staged at a time (64 KB)
#ifdef RATRACK_SKELETON
constexpr bool kSkeleton = true;   // a measuring build: one point a lane
#else
constexpr bool kSkeleton = false;
#endif

__device__ __forceinline__ float4 weighted3(float4 a, float wa, float4 b,
                                            float wb, float4 c, float wc) {
  auto one = [&](float x, float y, float z) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, wa), __fmul_rn(y, wb)),
                     __fmul_rn(z, wc));
  };
  return make_float4(one(a.x, b.x, c.x), one(a.y, b.y, c.y),
                     one(a.z, b.z, c.z), one(a.w, b.w, c.w));
}

template <int kQ, int kG>
__global__ void __launch_bounds__(kQ * kG)
three_interpolate_kernel(const float* __restrict__ unknown,
                         const float* __restrict__ known,
                         const float4* __restrict__ feats,
                         const unsigned char* __restrict__ mask, int n, int m,
                         int c4, float eps, float4* __restrict__ out,
                         int* __restrict__ idx_out) {
  extern __shared__ float4 cloud[];
  constexpr int kThreads = kQ * kG;
  const int tid = threadIdx.x, g = tid % kG;
  const int bi = blockIdx.y;
  const int qi = blockIdx.x * kQ + tid / kG;
  const bool active = qi < n;
  float ux = 0.0f, uy = 0.0f, uz = 0.0f;
  if (active) {
    const float* u = unknown + ((size_t)bi * n + qi) * 3;
    ux = u[0];
    uy = u[1];
    uz = u[2];
  }
  const float squ = ratrack::sq_norm3(ux, uy, uz);
  const float* kb = known + (size_t)bi * m * 3;
  const unsigned char* mb = mask != nullptr ? mask + (size_t)bi * m : nullptr;

  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int j0 = INT_MAX, j1 = INT_MAX, j2 = INT_MAX;
  for (int p0 = 0; p0 < m; p0 += kPiece) {
    const int cnt = min(kPiece, m - p0);
    if (p0 > 0) __syncthreads();   // every unknown has read the last piece
    ratrack::stage_cloud<kThreads>(cloud, kb, mb, p0, cnt, cnt, tid);
    __syncthreads();
    const int end = kSkeleton ? min(cnt, g + 1) : cnt;
    for (int e = g; e < end; e += kG) {
      const float4 p = cloud[e];
      const float d =
          p.w >= 0.0f ? ratrack::sq_dist(ux, uy, uz, squ, p.x, p.y, p.z, p.w)
                      : ratrack::kBig;
      const int j = p0 + e;
      if (d < d2) {
        if (d < d1) {
          d2 = d1; j2 = j1;
          if (d < d0) { d1 = d0; j1 = j0; d0 = d; j0 = j; }
          else { d1 = d; j1 = j; }
        } else { d2 = d; j2 = j; }
      }
    }
  }

  float sd[3];
  int sj[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float bd = d0;
    int bj = j0;
    ratrack::group_argmin<kG>(bd, bj);
    if (r > 0 && bd >= ratrack::kBig) {   // exhausted: repeat the nearest
      bd = sd[0];
      bj = sj[0];
    }
    sd[r] = bd;
    sj[r] = bj;
    if (j0 == bj) {   // the owning lane pops its head
      d0 = d1; j0 = j1; d1 = d2; j1 = j2; d2 = CUDART_INF_F; j2 = INT_MAX;
    }
  }
  if (!active) return;

  float rc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    rc[r] = __frcp_rn(__fadd_rn(__fsqrt_rn(sd[r]), eps));
  const float norm = __fadd_rn(__fadd_rn(rc[0], rc[1]), rc[2]);
  const float w0 = __fdiv_rn(rc[0], norm), w1 = __fdiv_rn(rc[1], norm),
              w2 = __fdiv_rn(rc[2], norm);
  const float4* f0 = feats + ((size_t)bi * m + sj[0]) * c4;
  const float4* f1 = feats + ((size_t)bi * m + sj[1]) * c4;
  const float4* f2 = feats + ((size_t)bi * m + sj[2]) * c4;
  float4* o = out + ((size_t)bi * n + qi) * c4;
  for (int e = g; e < c4; e += kG)
    o[e] = weighted3(f0[e], w0, f1[e], w1, f2[e], w2);
  if (idx_out != nullptr && g < 3)
    idx_out[((size_t)bi * n + qi) * 3 + g] =
        g == 0 ? sj[0] : (g == 1 ? sj[1] : sj[2]);
}

template <int kQ, int kG>
int launch_shape(const float* unknown, const float* known, const float* feats,
                 const unsigned char* mask, int nb, int n, int m, int c,
                 float eps, float* out, int* idx_out, cudaStream_t st) {
  const size_t smem = sizeof(float4) * (size_t)(m < kPiece ? m : kPiece);
  const cudaError_t err = cudaFuncSetAttribute(
      three_interpolate_kernel<kQ, kG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kQ - 1) / kQ, nb);
  three_interpolate_kernel<kQ, kG><<<grid, kQ * kG, smem, st>>>(
      unknown, known, reinterpret_cast<const float4*>(feats), mask, n, m,
      c / 4, eps, reinterpret_cast<float4*>(out), idx_out);
  return (int)cudaGetLastError();
}

// (unknowns a block, lanes an unknown), read off kernels/tune.py --fp
// (NVIDIA H100 80GB HBM3, 700 W), by unknowns a launch: up to 1,024 a
// warp an unknown (1 x 512: 0.0080 ms at (4, 32) against 0.0093 at
// (8, 16)); below 8,192 16 lanes (8 x 512: 0.0100-0.0104 at (16, 16),
// 0.0117-0.0125 at 8 lanes, 0.0122-0.0124 at 32, 0.0162-0.0179 at 4);
// from there 8 lanes (8192 x 512: 0.0142 at (32, 8) or (16, 8) against
// 0.0155 at 16).
void default_shape(int nb, int n, int* queries, int* lanes) {
  const long long unknowns = (long long)nb * n;
  *queries = unknowns <= 1024 ? 4 : 16;
  *lanes = unknowns <= 1024 ? 32 : (unknowns < 8192 ? 16 : 8);
}

}  // namespace

// queries (unknowns a block) and lanes (an unknown), one of the pairs
// below (default_shape's three and a neighbour of two of them, 128 or 256
// threads a block), or 0 and 0 for default_shape. c
// must be a multiple of 4 and feats and out 16-byte aligned (float4
// rows).
extern "C" int ratrack_three_interpolate(const float* unknown,
                                         const float* known,
                                         const float* feats,
                                         const unsigned char* mask, int nb,
                                         int n, int m, int c, float eps,
                                         int queries, int lanes, float* out,
                                         int* idx_out, void* stream) {
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 || c < 4 || c % 4 != 0 ||
      (reinterpret_cast<size_t>(feats) & 15) != 0 ||
      (reinterpret_cast<size_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (queries == 0 && lanes == 0) default_shape(nb, n, &queries, &lanes);
  const cudaStream_t st = (cudaStream_t)stream;
#define RATRACK_FP_SHAPE(Q, G)                                             \
  if (queries == Q && lanes == G)                                          \
    return launch_shape<Q, G>(unknown, known, feats, mask, nb, n, m, c, eps, \
                              out, idx_out, st);
  RATRACK_FP_SHAPE(16, 8)
  RATRACK_FP_SHAPE(32, 8)
  RATRACK_FP_SHAPE(8, 16)
  RATRACK_FP_SHAPE(16, 16)
  RATRACK_FP_SHAPE(4, 32)
#undef RATRACK_FP_SHAPE
  return (int)cudaErrorInvalidValue;
}
