// DBSCAN's cluster labels from the pairwise squared distances (kernel B12).
//
// Replaces no TPU kernel: the JAX package's `tracker/dbscan.py::dbscan` is
// plain JAX, and so was the port's (`tracker/dbscan.py::dbscan_reference`,
// 1 + max_iters propagation rounds of ~9 launches each over (B, N, N)
// int64 tensors). Per cloud, from d2 (n x n, float32, as
// `ops/neighborhood.py::square_distance` gives it), the mask, eps2 and
// min_samples, exactly as the plain version computes them:
//   adj_ij  = d2_ij <= eps2 and mask_i and mask_j   (row i: the point's own)
//   core_i  = mask_i and popc(adj row i) >= min_samples (the point counts)
//   label_i = i for a core point, n otherwise; then `rounds` times
//     new_i = min(label_i, min over j in adj_i, core_i, core_j of label_j)
//     label_i = min(new_i, new_i < n ? new_{new_i} : n)      (all at once)
//   a masked non-core point takes the least label of its core neighbours
//   (n: noise); cluster_i = (number of roots r <= label_i) - 1 where a
//   root is a point with label_r == r, -1 for label n.
// The rounds stop early once one round changed no label: that round is a
// fixpoint, so every later one is the identity and the labels are those of
// all `rounds`. Everything after the comparison with eps2 is integer work,
// so the labels equal the plain version's bit for bit on the same d2.
//
// What bounds it on the H100: the read of d2, 4 n^2 bytes a cloud (1 MB
// at 512 points; 268 MB, 0.08 ms at 3.35 TB/s, for 256 clouds), where the
// plain version moves ~2 GB a round at 256 x 512. Design, one block a
// cloud, everything after the read in shared memory:
//   - a warp a row of d2: lanes read 32 columns a step (coalesced, only
//     where the column's point is masked in, and only for masked-in rows),
//     `__ballot_sync` packs the step's 32 comparisons into one word of the
//     row's bit adjacency; popc of the row gives the core test;
//   - the rows ANDed with the core bitmask serve both the propagation and
//     the border adoption;
//   - a thread a point for the rounds, labels int32 double-buffered so a
//     round keeps the all-at-once semantics, `__syncthreads_or` for the
//     early exit;
//   - the roots as a bitmask, their ranks from popc and a warp's prefix
//     sum over at most 32 words.
// Shared memory: n x (words | 1) words of adjacency (an odd row stride,
// so that the threads of a warp read their rows from distinct banks), four
// bitmask rows, two label rows: 38 KB at 512 points, 140 KB at the limit
// of 1024 (above 48 KB by the opt-in attribute).

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxPoints = 1024;   // 32 words a row: one lane a word
constexpr int kStep = 8;           // loads in flight a lane in the row read

__device__ __forceinline__ bool bit_of(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// grid (B), kThreads threads, dynamic shared memory `shared_bytes(n)`.
__global__ void __launch_bounds__(kThreads)
dbscan_labels_kernel(const float* __restrict__ d2,
                     const unsigned char* __restrict__ mask, int n,
                     float eps2, int min_samples, int rounds,
                     int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int words = (n + 31) / 32;
  const int stride = words | 1;
  unsigned* adj = smem;                        // n x stride
  unsigned* maskw = adj + (size_t)n * stride;  // words each
  unsigned* corew = maskw + words;
  unsigned* rootw = corew + words;
  int* before = reinterpret_cast<int*>(rootw + words);   // roots before a word
  int* lab = before + words;                   // n
  int* nxt = lab + n;                          // n
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cloud = blockIdx.x;
  const unsigned char* mb = mask + cloud * n;

  for (int base = 0; base < words * 32; base += kThreads) {
    const int i = base + tid;
    const unsigned bal =
        __ballot_sync(ratrack::kFullMask, i < n && mb[i] != 0);
    if (lane == 0 && (i >> 5) < words) maskw[i >> 5] = bal;
  }
  for (int w = tid; w < words; w += kThreads) corew[w] = 0u;
  __syncthreads();

  // the bit adjacency, a warp a row; lane w keeps the row's word w
  const float* db = d2 + cloud * n * n;
  for (int i = warp; i < n; i += kThreads / 32) {
    unsigned* row = adj + (size_t)i * stride;
    if (!bit_of(maskw, i)) {
      if (lane < words) row[lane] = 0u;
      continue;
    }
    const float* drow = db + (size_t)i * n;
    unsigned mine = 0u;
    int count = 0;
    for (int w0 = 0; w0 < words; w0 += kStep) {
      bool hit[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int w = w0 + u;
        hit[u] = false;
        if (w < words && ((maskw[w] >> lane) & 1u))   // j < n: masked in
          hit[u] = drow[w * 32 + lane] <= eps2;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        if (w0 + u < words) {   // the same for every lane
          const unsigned bal = __ballot_sync(ratrack::kFullMask, hit[u]);
          count += __popc(bal);
          if (lane == w0 + u) mine = bal;
        }
      }
    }
    if (lane < words) row[lane] = mine;
    if (lane == 0 && count >= min_samples)
      atomicOr(&corew[i >> 5], 1u << (i & 31));
  }
  __syncthreads();

  // core neighbours only, and a core point's own index as its label
  for (int e = tid; e < n * words; e += kThreads) {
    const int i = e / words, w = e - i * words;
    adj[(size_t)i * stride + w] &= corew[w];
  }
  for (int i = tid; i < n; i += kThreads) lab[i] = bit_of(corew, i) ? i : n;
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i < n; i += kThreads) {
      int v = lab[i];
      if (bit_of(corew, i)) {
        const unsigned* row = adj + (size_t)i * stride;
        for (int w = 0; w < words; ++w) {
          for (unsigned bits = row[w]; bits != 0u; bits &= bits - 1u)
            v = min(v, lab[w * 32 + __ffs(bits) - 1]);
        }
      }
      nxt[i] = v;
    }
    __syncthreads();
    int changed = 0;
    for (int i = tid; i < n; i += kThreads) {
      const int v = nxt[i];
      const int o = min(v, v < n ? nxt[v] : n);
      changed |= o != lab[i];
      lab[i] = o;
    }
    if (!__syncthreads_or(changed)) break;
  }

  // border points: the least label of their core neighbours (cores keep
  // theirs, so no label read here is written here)
  for (int i = tid; i < n; i += kThreads) {
    if (bit_of(corew, i) || !bit_of(maskw, i)) continue;
    const unsigned* row = adj + (size_t)i * stride;
    int v = n;
    for (int w = 0; w < words; ++w) {
      for (unsigned bits = row[w]; bits != 0u; bits &= bits - 1u)
        v = min(v, lab[w * 32 + __ffs(bits) - 1]);
    }
    lab[i] = v;
  }
  __syncthreads();

  for (int base = 0; base < words * 32; base += kThreads) {
    const int i = base + tid;
    const unsigned bal =
        __ballot_sync(ratrack::kFullMask, i < n && lab[i] == i);
    if (lane == 0 && (i >> 5) < words) rootw[i >> 5] = bal;
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < words ? __popc(rootw[lane]) : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(ratrack::kFullMask, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane < words) before[lane] = incl - c;
  }
  __syncthreads();

  int* ob = out + cloud * n;
  for (int i = tid; i < n; i += kThreads) {
    const int l = lab[i];
    ob[i] = l < n ? before[l >> 5] +
                        __popc(rootw[l >> 5] & (0xffffffffu >> (31 - (l & 31)))) - 1
                  : -1;
  }
}

size_t shared_bytes(int n) {
  const int words = (n + 31) / 32;
  return sizeof(unsigned) * ((size_t)n * (words | 1) + 4 * (size_t)words +
                             2 * (size_t)n);
}

}  // namespace

// d2 (B, n, n) float32, mask (B, n) bool as bytes -> out (B, n) int32
// cluster ids, -1 for noise. 1 <= n <= 1024, rounds = 1 + max_iters >= 1.
extern "C" int ratrack_dbscan_labels(const float* d2, const unsigned char* mask,
                                     int nb, int n, float eps2,
                                     int min_samples, int rounds, int* out,
                                     void* stream) {
  if (nb < 1 || n < 1 || n > kMaxPoints || rounds < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dbscan_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dbscan_labels_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      d2, mask, n, eps2, min_samples, rounds, out);
  return (int)cudaGetLastError();
}
