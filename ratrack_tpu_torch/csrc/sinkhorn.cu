// All Sinkhorn iterations of the association in one launch (kernel B7).
//
// Replaces the TPU kernel ratrack_tpu/ops/pallas_sinkhorn.py::_kernel
// (sinkhorn_uv). Per stream, from u = v = 0, `iters` times:
//   u_i = log_mu_i - log(max(sum_j exp(c_ij + v_j), 1e-30))
//   v_j = log_nu_j - log(max(sum_i exp(c_ij + u_i), 1e-30))   (the new u)
// the bounded log-sum-exp of tracker/sinkhorn.py (no max pass: the finite
// operands of this problem lie in [-20, 20], masked entries are -1e9 and
// their exp is exactly 0). expf and logf are the full-precision functions.
//
// What bounds it on the H100: latency. The 2 * iters half-steps (1000 at
// 500 iterations) depend on each other; each is K1 sums of K1 exponentials
// (K1 = 33: 2.2 M exp in all per stream) on a 4 KB matrix. The eager loop
// this replaces pays ~12 launches an iteration. Design: one block per
// stream, c in shared memory with an odd row stride (rows and columns are
// both read without bank conflicts), one thread a row (then a column); a
// half-step is K1 independent expf a thread, summed in index order, one
// logf and a block barrier.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(128)
sinkhorn_kernel(const float* __restrict__ c, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, int k1, int iters,
                float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float sm[];
  const int stride = k1 | 1;
  float* cs = sm;                  // (k1, stride)
  float* us = cs + k1 * stride;    // (k1,)
  float* vs = us + k1;             // (k1,)
  const int t = threadIdx.x;
  const float* cb = c + (size_t)blockIdx.x * k1 * k1;
  for (int e = t; e < k1 * k1; e += blockDim.x)
    cs[(e / k1) * stride + e % k1] = cb[e];
  float lmu = 0.0f, lnu = 0.0f;
  if (t < k1) {
    lmu = log_mu[(size_t)blockIdx.x * k1 + t];
    lnu = log_nu[(size_t)blockIdx.x * k1 + t];
    us[t] = 0.0f;
    vs[t] = 0.0f;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    if (t < k1) {
      float s = 0.0f;
      for (int j = 0; j < k1; ++j)
        s = __fadd_rn(s, expf(__fadd_rn(cs[t * stride + j], vs[j])));
      us[t] = __fsub_rn(lmu, logf(fmaxf(s, 1e-30f)));
    }
    __syncthreads();
    if (t < k1) {
      float s = 0.0f;
      for (int i = 0; i < k1; ++i)
        s = __fadd_rn(s, expf(__fadd_rn(cs[i * stride + t], us[i])));
      vs[t] = __fsub_rn(lnu, logf(fmaxf(s, 1e-30f)));
    }
    __syncthreads();
  }
  if (t < k1) {
    u_out[(size_t)blockIdx.x * k1 + t] = us[t];
    v_out[(size_t)blockIdx.x * k1 + t] = vs[t];
  }
}

}  // namespace

extern "C" int ratrack_sinkhorn(const float* c, const float* log_mu,
                                const float* log_nu, int nb, int k1, int iters,
                                float* u, float* v, void* stream) {
  if (nb < 1 || k1 < 1 || k1 > 128 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = (k1 + 31) / 32 * 32;
  const size_t smem = sizeof(float) * ((size_t)k1 * (k1 | 1) + 2 * k1);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      c, log_mu, log_nu, k1, iters, u, v);
  return (int)cudaGetLastError();
}
