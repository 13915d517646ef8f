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
// What bounds it on the H100: the selection, N x M distances (2M per
// stream at 512 x 512) against 3 x C gathered floats per output row.
// Design: one warp per unknown point. Each lane scans every 32nd known
// point and keeps a sorted running top-3 (strict < keeps the lowest index,
// since a lane sees its indices in increasing order); three warp-wide
// lexicographic (distance, index) argmin rounds merge the lanes. The
// weighted sum is then a coalesced pass over C by the whole warp.

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
three_interpolate_kernel(const float* __restrict__ unknown,
                         const float* __restrict__ known,
                         const float* __restrict__ feats,
                         const unsigned char* __restrict__ mask, int nb, int n,
                         int m, int c, float eps, float* __restrict__ out,
                         int* __restrict__ idx_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= (long long)nb * n) return;
  const int bi = (int)(g / n);

  const float* u = unknown + (size_t)g * 3;
  const float ux = u[0], uy = u[1], uz = u[2];
  const float squ = ratrack::sq_norm3(ux, uy, uz);
  const float* kb = known + (size_t)bi * m * 3;
  const unsigned char* mb = mask != nullptr ? mask + (size_t)bi * m : nullptr;

  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int j0 = INT_MAX, j1 = INT_MAX, j2 = INT_MAX;
  for (int j = lane; j < m; j += 32) {
    float d = ratrack::kBig;
    if (mb == nullptr || mb[j] != 0) {
      const float x = kb[3 * j], y = kb[3 * j + 1], z = kb[3 * j + 2];
      d = ratrack::sq_dist(ux, uy, uz, squ, x, y, z, ratrack::sq_norm3(x, y, z));
    }
    if (d < d2) {
      if (d < d1) {
        d2 = d1; j2 = j1;
        if (d < d0) { d1 = d0; j1 = j0; d0 = d; j0 = j; }
        else { d1 = d; j1 = j; }
      } else { d2 = d; j2 = j; }
    }
  }

  float sd[3];
  int sj[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float bd = d0;
    int bj = j0;
    ratrack::warp_argmin(bd, bj);
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

  float rc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    rc[r] = __frcp_rn(__fadd_rn(__fsqrt_rn(sd[r]), eps));
  const float norm = __fadd_rn(__fadd_rn(rc[0], rc[1]), rc[2]);
  const float w0 = __fdiv_rn(rc[0], norm), w1 = __fdiv_rn(rc[1], norm),
              w2 = __fdiv_rn(rc[2], norm);
  const float* f0 = feats + ((size_t)bi * m + sj[0]) * c;
  const float* f1 = feats + ((size_t)bi * m + sj[1]) * c;
  const float* f2 = feats + ((size_t)bi * m + sj[2]) * c;
  float* o = out + (size_t)g * c;
  for (int k = lane; k < c; k += 32)
    o[k] = __fadd_rn(__fadd_rn(__fmul_rn(f0[k], w0), __fmul_rn(f1[k], w1)),
                     __fmul_rn(f2[k], w2));
  if (idx_out != nullptr && lane < 3) idx_out[(size_t)g * 3 + lane] = sj[lane];
}

}  // namespace

extern "C" int ratrack_three_interpolate(const float* unknown,
                                         const float* known,
                                         const float* feats,
                                         const unsigned char* mask, int nb,
                                         int n, int m, int c, float eps,
                                         float* out, int* idx_out,
                                         void* stream) {
  if (nb < 1 || n < 1 || m < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * n;
  const int grid = (int)((total + kWarps - 1) / kWarps);
  three_interpolate_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      unknown, known, feats, mask, nb, n, m, c, eps, out, idx_out);
  return (int)cudaGetLastError();
}
