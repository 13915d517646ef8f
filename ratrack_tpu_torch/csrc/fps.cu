// Farthest point sampling, the whole sequential loop in one launch
// (kernel B6).
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_fps_kernel.py::_fps_kernel
// (fps_indices_fused). Per stream:
//   seed   = the first valid index (0 when no point is valid);
//   temp_j = 1e10 for a valid point, -1 for an invalid one;
//   each of the npoint - 1 steps: d_j = dx*dx + dy*dy + dz*dz to the last
//   sample (float32, every op rounded on its own, in that order),
//   temp_j = min(temp_j, d_j) for valid points, and the next sample is the
//   FIRST index of the maximum of temp.
// Invalid points stay at -1 and are never chosen while a valid point
// remains; with none valid every sample is 0; npoint above the valid count
// repeats points (already-chosen points sit at temp = 0, the maximum).
//
// What bounds it on the H100: latency. The npoint - 1 steps depend on each
// other, and each is one (maximum, lowest index) reduction over the
// stream's points: 511 dependent block reductions at 512 samples. Bytes
// (N x 3 floats read once) and arithmetic (8 N operations a step) are
// negligible. Design: one block per stream, all steps in the launch. The
// coordinates sit in shared memory, one array per axis (192 KB at 16384
// points; thread t touches words t, t + T, ...: no bank conflicts); each
// thread keeps the running temp of its P = N / T points in registers. A
// step is: P distance updates per thread, a (max, lowest index) reduction
// by warp shuffles, one shared-memory stage over the warps, and the
// winner's coordinates broadcast from shared memory: two block barriers.

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxP = 16;   // points per thread: N <= 16384

// (d, j) beats (od, oj): larger, or as large with the lower index.
__device__ __forceinline__ void warp_argmax(float& d, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(ratrack::kFullMask, d, off);
    const int oj = __shfl_xor_sync(ratrack::kFullMask, j, off);
    if (od > d || (od == d && oj < j)) {
      d = od;
      j = oj;
    }
  }
}

struct Stage {
  float d[32];
  int j[32];
  int win;          // the step's winner
  float wx, wy, wz; // and its coordinates
};

// Block-wide (max d, lowest j); thread 0 publishes the winner (INT_MAX, no
// candidate at all, becomes 0) and its coordinates. Two barriers; every
// thread of the block calls it.
__device__ __forceinline__ int block_argmax(float d, int j, Stage& st,
                                            const float* xs, const float* ys,
                                            const float* zs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_argmax(d, j);
  if (lane == 0) {
    st.d[warp] = d;
    st.j[warp] = j;
  }
  __syncthreads();
  if (warp == 0) {
    d = lane < nwarps ? st.d[lane] : -CUDART_INF_F;
    j = lane < nwarps ? st.j[lane] : INT_MAX;
    warp_argmax(d, j);
    if (lane == 0) {
      if (j == INT_MAX) j = 0;
      st.win = j;
      st.wx = xs[j];
      st.wy = ys[j];
      st.wz = zs[j];
    }
  }
  __syncthreads();
  return st.win;
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
           int n, int npoint, int* __restrict__ out) {
  extern __shared__ float coords[];   // xs, ys, zs, each P * blockDim.x
  __shared__ Stage st;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int np = P * nthreads;
  float* xs = coords;
  float* ys = xs + np;
  float* zs = ys + np;
  const float* xb = xyz + (size_t)blockIdx.x * n * 3;
  const unsigned char* mb =
      mask != nullptr ? mask + (size_t)blockIdx.x * n : nullptr;
  int* ob = out + (size_t)blockIdx.x * npoint;

  // load; the seed is the lowest valid index: an argmax over (valid, index)
  float temp[P];
  int seed = INT_MAX;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = i * nthreads + tid;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    temp[i] = -CUDART_INF_F;   // a slot past the cloud: never chosen
    if (j < n) {
      x = xb[3 * (size_t)j];
      y = xb[3 * (size_t)j + 1];
      z = xb[3 * (size_t)j + 2];
      const bool valid = mb == nullptr || mb[j] != 0;
      temp[i] = valid ? 1e10f : -1.0f;
      if (valid) seed = min(seed, j);
    }
    xs[j] = x;
    ys[j] = y;
    zs[j] = z;
  }
  __syncthreads();
  int last = block_argmax(seed != INT_MAX ? 1.0f : 0.0f, seed, st, xs, ys, zs);
  if (tid == 0) ob[0] = last;

  for (int s = 1; s < npoint; ++s) {
    const float cx = st.wx, cy = st.wy, cz = st.wz;
    float bd = -CUDART_INF_F;
    int bj = INT_MAX;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int j = i * nthreads + tid;
      const float dx = __fsub_rn(xs[j], cx);
      const float dy = __fsub_rn(ys[j], cy);
      const float dz = __fsub_rn(zs[j], cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      // valid points have temp >= 0; -1 (invalid) and -inf (past the
      // cloud) stay as they are
      if (temp[i] >= 0.0f) temp[i] = fminf(temp[i], d);
      if (temp[i] > bd) {   // j ascends with i: the first maximum is kept
        bd = temp[i];
        bj = j;
      }
    }
    last = block_argmax(bd, bj, st, xs, ys, zs);
    if (tid == 0) ob[s] = last;
  }
}

template <int P>
int launch(const float* xyz, const unsigned char* mask, int nb, int n,
           int npoint, int* out, int threads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * P * threads;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<P><<<nb, threads, smem, stream>>>(xyz, mask, n, npoint, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ratrack_fps(const float* xyz, const unsigned char* mask, int nb,
                           int n, int npoint, int* out, void* stream) {
  if (nb < 1 || n < 1 || npoint < 1 || n > kMaxThreads * kMaxP)
    return (int)cudaErrorInvalidValue;
  const int threads = min(kMaxThreads, (n + 31) / 32 * 32);
  const int per = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (per <= 1) return launch<1>(xyz, mask, nb, n, npoint, out, threads, s);
  if (per <= 2) return launch<2>(xyz, mask, nb, n, npoint, out, threads, s);
  if (per <= 4) return launch<4>(xyz, mask, nb, n, npoint, out, threads, s);
  if (per <= 8) return launch<8>(xyz, mask, nb, n, npoint, out, threads, s);
  return launch<16>(xyz, mask, nb, n, npoint, out, threads, s);
}
