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
// stream's points: 511 dependent reductions at 512 samples. Bytes (N x 3
// floats read once) and arithmetic (9 N operations a step) are negligible.
// So the design shortens the step:
//   - one barrier a step. Each warp's winner goes to a stage indexed by the
//     step's parity; after the barrier every warp reduces the stage itself
//     and every thread reads the winner's coordinates from shared memory as
//     a broadcast. No warp or thread works alone while the others wait.
//   - one key, hardware reductions. (temp, index) is one pair of 32-bit
//     words: the float's bits mapped monotonically to unsigned, and ~index,
//     so that the maximum is "largest temp, lowest index". A warp reduces it
//     with two redux.sync operations (__reduce_max_sync): the maximum of
//     the high words, then of the low words among the lanes that hold it.
//   - the coordinates of a thread's points sit in registers (shared memory
//     holds the whole cloud too, for the winner's broadcast), and the block
//     is sized by N: few, full warps at small N make the barrier cheap.
//   - above a few thousand points a thread-block cluster shares one stream:
//     each block updates a slice of the cloud on its own SM, the warps'
//     winners go to every block's stage through distributed shared memory,
//     and the step's one barrier is the cluster's. That barrier and the
//     remote stores cost about 0.35 us a step (a step of 512 points takes
//     0.23 us in one block and 0.58 in a cluster of two), so the cluster
//     pays only where a block's update work is longer: it starts above
//     6144 points. (Without the barrier, each warp polling its block's
//     stage for entries tagged with the step's number, a step took longer
//     still: 1.2 us.) ratrack_fps picks the shape by N from the table at
//     default_shape unless the caller gives one.

#include "common.cuh"

#include <cooperative_groups.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxP = 16;         // points per thread
constexpr int kMaxEntries = 64;   // warps of one stream, over all its blocks
constexpr int kMaxCluster = 8;
constexpr int kMaxPoints = 16384;

// Float bits -> unsigned, order kept: -inf < -1 < +0 < ... < 1e10.
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

// Warp-wide maximum of (hi, lo), lexicographic; every lane gets it.
__device__ __forceinline__ void warp_max_key(unsigned& hi, unsigned& lo) {
  const unsigned mh = __reduce_max_sync(ratrack::kFullMask, hi);
  lo = __reduce_max_sync(ratrack::kFullMask, hi == mh ? lo : 0u);
  hi = mh;
}

typedef unsigned long long Entry;   // (hi << 32) | lo, one warp's winner

// The (largest temp, lowest index) of the stream's points from each
// thread's candidate, in every thread of every block: each warp's winner to
// the stage (of every block of the cluster, through distributed shared
// memory), one barrier (the block's, or the cluster's), every warp reduces
// the stage. stage is the step's parity's array of entries: a warp that
// runs ahead writes the other one.
template <bool CLUSTER>
__device__ __forceinline__ int stream_argmax(float d, int j, Entry* stage,
                                             int rank, int ncta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5, entries = nwarps * ncta;
  unsigned hi = ordered_bits(d), lo = ~(unsigned)j;
  warp_max_key(hi, lo);
  const Entry mine = ((Entry)hi << 32) | lo;
  const int slot = rank * nwarps + warp;
  if (CLUSTER) {
    if (lane < ncta)
      cg::this_cluster().map_shared_rank(stage, lane)[slot] = mine;
    cg::this_cluster().sync();
  } else {
    if (lane == 0) stage[slot] = mine;
    __syncthreads();
  }
  Entry e0 = lane < entries ? stage[lane] : 0;
  const Entry e1 = lane + 32 < entries ? stage[lane + 32] : 0;
  if (e1 > e0) e0 = e1;
  hi = (unsigned)(e0 >> 32);
  lo = (unsigned)e0;
  warp_max_key(hi, lo);
  return (int)~lo;
}

// T: the most threads a block is launched with. The coordinates stay in
// registers unless 16 points a thread meet a block of over 256 threads
// (64 registers a thread): then they are read from shared memory.
template <int P, int T, bool CLUSTER>
__global__ void __launch_bounds__(T)
fps_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
           int n, int npoint, int ncta, int* __restrict__ out) {
  constexpr bool kInRegs = P <= 8 || T <= 256;
  extern __shared__ __align__(16) float coords[];   // xs, ys, zs, each n
  __shared__ Entry stages[2][kMaxEntries];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int stream = CLUSTER ? blockIdx.x / ncta : blockIdx.x;
  const int stride = nthreads * ncta, first = rank * nthreads + tid;
  float* xs = coords;
  float* ys = xs + n;
  float* zs = ys + n;
  const float* xb = xyz + (size_t)stream * n * 3;
  const unsigned char* mb =
      mask != nullptr ? mask + (size_t)stream * n : nullptr;
  int* ob = out + (size_t)stream * npoint;

  // every block holds the whole cloud (any point can win a step)
  for (int e = tid; e < n; e += nthreads) {
    xs[e] = xb[3 * (size_t)e];
    ys[e] = xb[3 * (size_t)e + 1];
    zs[e] = xb[3 * (size_t)e + 2];
  }
  // this thread's points first, first + stride, ...; the seed is the lowest
  // valid index: an argmax over (valid, index)
  float temp[P], px[kInRegs ? P : 1], py[kInRegs ? P : 1], pz[kInRegs ? P : 1];
  float sd = 0.0f;
  int sj = 0;
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    const int j = i * stride + first;
    temp[i] = -CUDART_INF_F;   // a slot past the cloud: never chosen
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (j < n) {
      x = xb[3 * (size_t)j];
      y = xb[3 * (size_t)j + 1];
      z = xb[3 * (size_t)j + 2];
      const bool valid = mb == nullptr || mb[j] != 0;
      temp[i] = valid ? 1e10f : -1.0f;
      if (valid) {
        sd = 1.0f;
        sj = j;
      }
    }
    if (kInRegs) {
      px[i] = x;
      py[i] = y;
      pz[i] = z;
    }
  }
  // the coordinates are in shared memory, and every block of the cluster
  // runs, before anyone reads the one or writes to another's stage
  if (CLUSTER) cg::this_cluster().sync(); else __syncthreads();
  int last = stream_argmax<CLUSTER>(sd, sj, stages[0], rank, ncta);
  if (rank == 0 && tid == 0) ob[0] = last;

  for (int s = 1; s < npoint; ++s) {
    const float cx = xs[last], cy = ys[last], cz = zs[last];
    float bd = -CUDART_INF_F;
    int bj = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int j = i * stride + first;
      const int js = kInRegs ? 0 : min(j, n - 1);
      const float dx = __fsub_rn(kInRegs ? px[i] : xs[js], cx);
      const float dy = __fsub_rn(kInRegs ? py[i] : ys[js], cy);
      const float dz = __fsub_rn(kInRegs ? pz[i] : zs[js], cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      // d >= 0: -1 (invalid) and -inf (past the cloud) stay as they are
      temp[i] = fminf(temp[i], d);
      if (temp[i] > bd) {   // j ascends with i: the first maximum is kept
        bd = temp[i];
        bj = j;
      }
    }
    last = stream_argmax<CLUSTER>(bd, bj, stages[s & 1], rank, ncta);
    if (rank == 0 && tid == 0) ob[s] = last;
  }
}

template <int P, int T, bool CLUSTER>
int launch(const float* xyz, const unsigned char* mask, int nb, int n,
           int npoint, int* out, int threads, int ncta, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * n;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<P, T, CLUSTER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * ncta);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  if (CLUSTER) {
    // asked once per shape: a cluster that fits no GPC is an error here,
    // not a launch that never starts
    static size_t ok_smem = 0;
    static int ok_threads = 0, ok_ncta = 0;
    if (smem != ok_smem || threads != ok_threads || ncta != ok_ncta) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(
          &clusters, fps_kernel<P, T, CLUSTER>, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
      ok_smem = smem;
      ok_threads = threads;
      ok_ncta = ncta;
    }
  }
  return (int)cudaLaunchKernelEx(&cfg, fps_kernel<P, T, CLUSTER>, xyz, mask,
                                 n, npoint, ncta, out);
}

template <int P>
int launch_p(const float* xyz, const unsigned char* mask, int nb, int n,
             int npoint, int* out, int threads, int ncta, cudaStream_t s) {
  if (ncta > 1)
    return threads <= 256
        ? launch<P, 256, true>(xyz, mask, nb, n, npoint, out, threads, ncta, s)
        : launch<P, 1024, true>(xyz, mask, nb, n, npoint, out, threads, ncta, s);
  return threads <= 256
      ? launch<P, 256, false>(xyz, mask, nb, n, npoint, out, threads, 1, s)
      : launch<P, 1024, false>(xyz, mask, nb, n, npoint, out, threads, 1, s);
}

int launch_shape(const float* xyz, const unsigned char* mask, int nb, int n,
                 int npoint, int* out, int threads, int ncta,
                 cudaStream_t s) {
  if (nb < 1 || n < 1 || n > kMaxPoints || npoint < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || ncta < 1 ||
      ncta > kMaxCluster || (threads / 32) * ncta > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  const int per = (n + threads * ncta - 1) / (threads * ncta);
  if (per > kMaxP) return (int)cudaErrorInvalidValue;
  if (per <= 1) return launch_p<1>(xyz, mask, nb, n, npoint, out, threads, ncta, s);
  if (per <= 2) return launch_p<2>(xyz, mask, nb, n, npoint, out, threads, ncta, s);
  if (per <= 4) return launch_p<4>(xyz, mask, nb, n, npoint, out, threads, ncta, s);
  if (per <= 8) return launch_p<8>(xyz, mask, nb, n, npoint, out, threads, ncta, s);
  return launch_p<16>(xyz, mask, nb, n, npoint, out, threads, ncta, s);
}

// The launch shape by N: (threads a block, blocks a stream), read off
// kernels/tune.py's times on an H100 (ms for 512 samples: block / cluster):
// 512 points 0.116 (128 threads) / 0.30; 4096 points 0.25 (512 threads) /
// 0.47; 8192 points 0.41 (1024 threads) / 0.37 (8 blocks of 128); 16384
// points 0.89 / 0.46. One block of about 8 points a thread (128 to 1024
// threads) up to 6144 points, a cluster of 8 blocks of 128 threads above.
void default_shape(int n, int* threads, int* ncta) {
  if (n <= 6144) {
    *threads = min(1024, max(128, ((n + 7) / 8 + 31) / 32 * 32));
    *ncta = 1;
  } else {
    *threads = 128;
    *ncta = kMaxCluster;
  }
}

}  // namespace

// threads = 0: the launch shape by N from the table above. Otherwise the
// caller's: threads a block (a multiple of 32) and blocks a stream (1: one
// block, no cluster; up to 8: a cluster), at most 16 points a thread and
// 64 warps a stream.
extern "C" int ratrack_fps(const float* xyz, const unsigned char* mask, int nb,
                           int n, int npoint, int* out, int threads, int ncta,
                           void* stream) {
  if (threads == 0) default_shape(n, &threads, &ncta);
  return launch_shape(xyz, mask, nb, n, npoint, out, threads, ncta,
                      (cudaStream_t)stream);
}
