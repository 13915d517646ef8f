// SA pair and SA scale: one set-abstraction level at both of its radii, or
// one scale of a level, fused.
//
// Replaces the TPU kernels ratrack_tpu/ops/pallas_sa.py::_sa_pair_kernel
// (fused_sa_pair, entry ratrack_sa_pair) and ::_sa_kernel (fused_sa_scale,
// entry ratrack_sa_scale: the same kernel instantiated for one scale, for
// levels that are not a pair). For each center i and each radius r (scales
// a, b; or a alone):
//   ball query: the first ns valid points with d^2 < r^2, in index order;
//   h_s = relu(P1[j_s] - CW[i])     (layer 1, hoisted outside the kernel)
//   h_s = relu(h_s @ W_l + b_l)     (BN-folded layers 2..L)
//   out[i] = max over the filled slots s of h_s
// With no hit the pooled value is the pair (i, point 0), as the CUDA
// reference's zero-filled index slots give (pallas_sa.py:36-39).
//
// What bounds it on the H100: neither bytes nor FLOPs at the main-path
// shape (B=8, N=M=512; at most 48 slots x a 64x64 layer per center) but
// latency of the per-center work. Design: one warp per center. The ball
// query scans the cloud 32 points a step; __ballot_sync + __popc give
// every hit its rank at both radii at once, and the scan stops as soon as
// both slot lists are full. The folded weights of both scales (at most
// 33 KB) sit in shared memory; each lane owns output channels lane and
// lane+32 of every layer, so a layer is one broadcast read of the input
// activation and one conflict-free read of a weight row per step.
// Only filled slots are computed; padding slots would repeat the first
// hit and cannot change the max.
// The one-scale instance runs the same ball query with an empty second
// list (radius^2 -1, no slot) and the same per-scale body once, so a pair
// equals two one-scale launches bit for bit.

#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRest = 2;   // folded layers after layer 1
constexpr int kMaxC = 64;     // widest layer
constexpr int kMaxNs = 32;    // largest nsample

struct Scale {
  const float* p1;   // (B, N, C1) hoisted layer-1 pre-activation per point
  const float* cw;   // (B, M, C1) per-center term
  const float* w[kMaxRest];   // (C_l, C_{l+1}) folded weights
  const float* b[kMaxRest];   // (C_{l+1},) folded biases
  int dims[kMaxRest + 1];     // C1, C2, ...
  int n_rest;
  float r2;
  int ns;
  float* out;        // (B, M, C_last)
  int* idx;          // (B, M, ns) selected indices, or null
  int wsize;         // floats of folded weights staged in shared memory
};

__device__ void stage_weights(const Scale& s, float* dst) {
  int off = 0;
  for (int l = 0; l < s.n_rest; ++l) {
    const int nw = s.dims[l] * s.dims[l + 1];
    for (int t = threadIdx.x; t < nw; t += blockDim.x) dst[off + t] = s.w[l][t];
    off += nw;
    for (int t = threadIdx.x; t < s.dims[l + 1]; t += blockDim.x)
      dst[off + t] = s.b[l][t];
    off += s.dims[l + 1];
  }
}

// MLP over the filled slots of one center and max-pool; one warp.
__device__ void pool_scale(const Scale& s, const float* sw, const int* slots,
                           int hits, int bi, int ci, int n, int m, float* h0,
                           float* h1, int lane) {
  const int c1 = s.dims[0];
  const int cout = s.dims[s.n_rest];
  const float* cw = s.cw + ((size_t)bi * m + ci) * c1;
  const float* p1 = s.p1 + (size_t)bi * n * c1;
  float best0 = -CUDART_INF_F, best1 = -CUDART_INF_F;
  const int nslots = hits > 0 ? hits : 1;
  for (int t = 0; t < nslots; ++t) {
    const int j = hits > 0 ? slots[t] : 0;
    for (int c = lane; c < c1; c += 32)
      h0[c] = fmaxf(__fsub_rn(p1[(size_t)j * c1 + c], cw[c]), 0.0f);
    __syncwarp();
    float* hin = h0;
    float* hout = h1;
    const float* wp = sw;
    for (int l = 0; l < s.n_rest; ++l) {
      const int ci_ = s.dims[l], co = s.dims[l + 1];
      const float* bl = wp + ci_ * co;
      for (int c = lane; c < co; c += 32) {
        float acc = 0.0f;
        for (int k = 0; k < ci_; ++k) acc = fmaf(hin[k], wp[k * co + c], acc);
        hout[c] = fmaxf(acc + bl[c], 0.0f);
      }
      __syncwarp();
      wp += ci_ * co + co;
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    if (lane < cout) best0 = fmaxf(best0, hin[lane]);
    if (lane + 32 < cout) best1 = fmaxf(best1, hin[lane + 32]);
    __syncwarp();
  }
  float* out = s.out + ((size_t)bi * m + ci) * cout;
  if (lane < cout) out[lane] = best0;
  if (lane + 32 < cout) out[lane + 32] = best1;
  if (s.idx != nullptr) {
    int* idx = s.idx + ((size_t)bi * m + ci) * s.ns;
    for (int t = lane; t < s.ns; t += 32)
      idx[t] = hits > 0 ? slots[t < hits ? t : 0] : 0;
  }
}

// kTwo: both scales of a level (B1); otherwise scale a alone (B1'), sb
// unread.
template <bool kTwo>
__global__ void __launch_bounds__(kWarps * 32)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
          const unsigned char* __restrict__ mask, int nb, int n, int m,
          Scale sa, Scale sb) {
  extern __shared__ float smem[];
  float* swa = smem;
  float* swb = swa + sa.wsize;
  float* hbuf = swb + (kTwo ? sb.wsize : 0);                  // kWarps*2*kMaxC
  int* sidx = reinterpret_cast<int*>(hbuf + kWarps * 2 * kMaxC);  // kWarps*2*kMaxNs
  stage_weights(sa, swa);
  if (kTwo) stage_weights(sb, swb);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= (long long)nb * m) return;
  const int bi = (int)(g / m), ci = (int)(g % m);

  const float* c = centers + (size_t)g * 3;
  int* slots_a = sidx + warp * 2 * kMaxNs;
  int* slots_b = slots_a + kMaxNs;
  int hits_a, hits_b;
  ratrack::ball_query_pair(
      xyz + (size_t)bi * n * 3,
      mask != nullptr ? mask + (size_t)bi * n : nullptr, n, c[0], c[1], c[2],
      sa.r2, sa.ns, kTwo ? sb.r2 : -1.0f, kTwo ? sb.ns : 0, slots_a, slots_b,
      lane, &hits_a, &hits_b);

  float* h0 = hbuf + warp * 2 * kMaxC;
  float* h1 = h0 + kMaxC;
  pool_scale(sa, swa, slots_a, hits_a, bi, ci, n, m, h0, h1, lane);
  if (kTwo) pool_scale(sb, swb, slots_b, hits_b, bi, ci, n, m, h0, h1, lane);
}

bool make_scale(Scale* s, const float* p1, const float* cw,
                const float* const* w, const float* const* b, const int* dims,
                int n_rest, float r2, int ns, float* out, int* idx) {
  if (n_rest < 0 || n_rest > kMaxRest || ns < 1 || ns > kMaxNs) return false;
  s->p1 = p1;
  s->cw = cw;
  s->n_rest = n_rest;
  s->r2 = r2;
  s->ns = ns;
  s->out = out;
  s->idx = idx;
  s->wsize = 0;
  for (int l = 0; l <= n_rest; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxC) return false;
    s->dims[l] = dims[l];
  }
  for (int l = 0; l < n_rest; ++l) {
    s->w[l] = w[l];
    s->b[l] = b[l];
    s->wsize += dims[l] * dims[l + 1] + dims[l + 1];
  }
  return true;
}

template <bool kTwo>
int launch_sa(const float* xyz, const float* centers,
              const unsigned char* mask, int nb, int n, int m,
              const Scale& sa, const Scale& sb, void* stream) {
  const size_t smem =
      sizeof(float) * (sa.wsize + (kTwo ? sb.wsize : 0) + kWarps * 2 * kMaxC) +
      sizeof(int) * kWarps * 2 * kMaxNs;
  cudaError_t err = cudaFuncSetAttribute(
      sa_kernel<kTwo>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long centers_total = (long long)nb * m;
  const int grid = (int)((centers_total + kWarps - 1) / kWarps);
  sa_kernel<kTwo><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      xyz, centers, mask, nb, n, m, sa, sb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ratrack_sa_pair(
    const float* xyz, const float* centers, const unsigned char* mask, int nb,
    int n, int m,
    const float* p1a, const float* cwa, const float* const* wa,
    const float* const* ba, const int* dims_a, int n_rest_a, float r2a,
    int nsa, float* out_a, int* idx_a,
    const float* p1b, const float* cwb, const float* const* wb,
    const float* const* bb, const int* dims_b, int n_rest_b, float r2b,
    int nsb, float* out_b, int* idx_b, void* stream) {
  Scale sa, sb;
  if (nb < 1 || n < 1 || m < 1 ||
      !make_scale(&sa, p1a, cwa, wa, ba, dims_a, n_rest_a, r2a, nsa, out_a,
                  idx_a) ||
      !make_scale(&sb, p1b, cwb, wb, bb, dims_b, n_rest_b, r2b, nsb, out_b,
                  idx_b))
    return (int)cudaErrorInvalidValue;
  return launch_sa<true>(xyz, centers, mask, nb, n, m, sa, sb, stream);
}

// Kernel B1': one scale of a level.
extern "C" int ratrack_sa_scale(
    const float* xyz, const float* centers, const unsigned char* mask, int nb,
    int n, int m, const float* p1, const float* cw, const float* const* w,
    const float* const* b, const int* dims, int n_rest, float r2, int ns,
    float* out, int* idx, void* stream) {
  Scale s;
  if (nb < 1 || n < 1 || m < 1 ||
      !make_scale(&s, p1, cw, w, b, dims, n_rest, r2, ns, out, idx))
    return (int)cudaErrorInvalidValue;
  return launch_sa<false>(xyz, centers, mask, nb, n, m, s, s, stream);
}

extern "C" const char* ratrack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
