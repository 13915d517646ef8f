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
// stream and a group of kLanes lanes a row of c (and the same group a
// column): lane l of the group takes the terms j = l, l + kLanes, ..., so
// a lane's terms are few and independent, and the group adds its partial
// sums by a fixed xor tree of shuffles. A thread keeps its terms of its
// row and of its column of c in registers for the whole loop (kTerms of
// each, the power of two that covers K1 / kLanes: a launch is compiled
// for each, so the term loop is straight-line code), and only the
// potentials go through shared memory: one lane of the group takes
// the log and writes the new potential, then one block barrier a
// half-step. By default E = exp(c) is taken once and a term is E_ij *
// exp(v_j), with exp(v_j) taken once by the lane that writes v_j: one
// exponential per potential a half-step instead of K1 (masked entries
// still give exactly 0: exp(-1e9) is 0 and exp(v) is finite, the finite
// terms being bounded).
//
// Variants, for measuring (kernels/tune.py --sinkhorn): kLanes in {4, 8,
// 16} (K1 * kLanes <= 1024: one block of at most 1024 threads, one row a
// group); kExp, a term exp(c_ij + v_j) as the plain version computes it;
// kSkeleton keeps the launch shape, the loads, adds, shuffles and barriers
// and drops every exp and log: the latency floor of this shape (its u and
// v are not the potentials).

#include "common.cuh"

namespace {

constexpr int kExp = 0;
constexpr int kFactored = 1;
constexpr int kSkeleton = 2;
constexpr int kMaxK1 = 128;

// A launch of kLanes lanes a row and kTerms terms a lane serves K1 <=
// kLanes * kTerms, at most 1024 threads.
template <int kLanes, int kTerms>
struct Shape {
  static constexpr int kThreads = kLanes * kLanes * kTerms;
  static constexpr int kMaxThreads = kThreads < 1024 ? (kThreads + 31) / 32 * 32 : 1024;
};

// The group's sum over j of term(a_j, p_j) for this lane's terms a[m] (j =
// lane + kLanes m) of its row: exp(a + p) (kExp), a * p (kFactored: a =
// exp(c), p = exp(potential)) or a + p (kSkeleton). Straight-line code:
// every load is issued first (clamped into the row), a term past K1 adds
// nothing. A lane adds its terms in index order, the group its lanes by
// the xor tree.
template <int kLanes, int kTerms, int kMode>
__device__ __forceinline__ float row_sum(const float (&a)[kTerms],
                                         const float* p, int k1, int lane) {
  float pv[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) pv[m] = p[min(lane + m * kLanes, k1 - 1)];
  float s = 0.0f;
#pragma unroll
  for (int m = 0; m < kTerms; ++m) {
    float term;
    if (kMode == kExp)
      term = expf(__fadd_rn(a[m], pv[m]));
    else if (kMode == kFactored)
      term = __fmul_rn(a[m], pv[m]);
    else
      term = __fadd_rn(a[m], pv[m]);
    if (lane + m * kLanes < k1) s = __fadd_rn(s, term);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(ratrack::kFullMask, s, off));
  return s;
}

// The new potential of a row (or column) from its log-marginal and sum.
template <int kMode>
__device__ __forceinline__ float potential(float lm, float s) {
  return kMode == kSkeleton ? __fsub_rn(lm, __fmul_rn(s, 1e-12f))
                            : __fsub_rn(lm, logf(fmaxf(s, 1e-30f)));
}

template <int kLanes, int kTerms, int kMode>
__global__ void __launch_bounds__(Shape<kLanes, kTerms>::kMaxThreads)
sinkhorn_kernel(const float* __restrict__ c, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, int k1, int iters,
                float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float us[kMaxK1], vs[kMaxK1];   // the potentials
  __shared__ float eu[kMaxK1], ev[kMaxK1];   // their exps (kFactored)
  const int t = threadIdx.x, lane = t % kLanes, grp = t / kLanes;
  const bool live = grp < k1;           // the group's row i and column j
  const int r = min(grp, k1 - 1);
  const size_t s0 = (size_t)blockIdx.x * k1;
  const float* cb = c + s0 * k1;
  float crow[kTerms], ccol[kTerms];     // c[r][j], c[j][r], j = lane + kLanes m
#pragma unroll
  for (int m = 0; m < kTerms; ++m) {
    const int j = min(lane + m * kLanes, k1 - 1);
    crow[m] = cb[(size_t)r * k1 + j];
    ccol[m] = cb[(size_t)j * k1 + r];
    if (kMode == kFactored) {
      crow[m] = expf(crow[m]);
      ccol[m] = expf(ccol[m]);
    }
  }
  const float lmu = log_mu[s0 + r], lnu = log_nu[s0 + r];
  for (int i = t; i < k1; i += blockDim.x) {
    us[i] = 0.0f;
    vs[i] = 0.0f;
    eu[i] = 1.0f;
    ev[i] = 1.0f;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float s = row_sum<kLanes, kTerms, kMode>(
        crow, kMode == kFactored ? ev : vs, k1, lane);
    if (lane == 0 && live) {
      const float x = potential<kMode>(lmu, s);
      us[grp] = x;
      if (kMode == kFactored) eu[grp] = expf(x);
    }
    __syncthreads();
    s = row_sum<kLanes, kTerms, kMode>(ccol, kMode == kFactored ? eu : us, k1,
                                       lane);
    if (lane == 0 && live) {
      const float x = potential<kMode>(lnu, s);
      vs[grp] = x;
      if (kMode == kFactored) ev[grp] = expf(x);
    }
    __syncthreads();
  }
  for (int i = t; i < k1; i += blockDim.x) {
    u_out[s0 + i] = us[i];
    v_out[s0 + i] = vs[i];
  }
}

// The launch with the fewest terms a lane (a power of two) that covers K1.
template <int kLanes, int kMode, int kTerms = 1>
int launch(const float* c, const float* log_mu, const float* log_nu, int nb,
           int k1, int iters, float* u, float* v, cudaStream_t stream) {
  if constexpr (kLanes * kTerms < kMaxK1) {
    if (k1 > kLanes * kTerms)
      return launch<kLanes, kMode, 2 * kTerms>(c, log_mu, log_nu, nb, k1,
                                               iters, u, v, stream);
  }
  const int threads = (k1 * kLanes + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  sinkhorn_kernel<kLanes, kTerms, kMode><<<nb, threads, 0, stream>>>(
      c, log_mu, log_nu, k1, iters, u, v);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(const float* c, const float* log_mu, const float* log_nu,
                int nb, int k1, int iters, int lanes, float* u, float* v,
                cudaStream_t s) {
  switch (lanes) {
    case 4: return launch<4, kMode>(c, log_mu, log_nu, nb, k1, iters, u, v, s);
    case 8: return launch<8, kMode>(c, log_mu, log_nu, nb, k1, iters, u, v, s);
    case 16: return launch<16, kMode>(c, log_mu, log_nu, nb, k1, iters, u, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shape and the summation the wrapper launches, read off
// kernels/tune.py --sinkhorn (NVIDIA H100 80GB HBM3, 700 W; 8 streams x 33
// x 33, 500 iterations): 8 lanes a row with exp(c) taken once, 0.245 ms,
// against 0.274 and 0.287 with 16 and 4 lanes and 0.471 with exp(c + v) a
// term; the skeleton of the same shape takes 0.161.
constexpr int kDefaultLanes = 8;
constexpr int kDefaultMode = kFactored;

}  // namespace

// lanes: 4, 8 or 16 lanes a row (K1 * lanes <= 1024); mode: 0 exp(c + v)
// a term, 1 exp(c) taken once times exp(v), 2 the skeleton (no exp or log:
// for timing only, u and v are not the potentials).
extern "C" int ratrack_sinkhorn_variant(const float* c, const float* log_mu,
                                        const float* log_nu, int nb, int k1,
                                        int iters, int lanes, int mode,
                                        float* u, float* v, void* stream) {
  if (nb < 1 || k1 < 1 || k1 > kMaxK1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kExp:
      return launch_mode<kExp>(c, log_mu, log_nu, nb, k1, iters, lanes, u, v, s);
    case kFactored:
      return launch_mode<kFactored>(c, log_mu, log_nu, nb, k1, iters, lanes,
                                    u, v, s);
    case kSkeleton:
      return launch_mode<kSkeleton>(c, log_mu, log_nu, nb, k1, iters, lanes,
                                    u, v, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ratrack_sinkhorn(const float* c, const float* log_mu,
                                const float* log_nu, int nb, int k1, int iters,
                                float* u, float* v, void* stream) {
  return ratrack_sinkhorn_variant(c, log_mu, log_nu, nb, k1, iters,
                                  kDefaultLanes, kDefaultMode, u, v, stream);
}
