// The k-nearest selection shared by kernel B5 (knn_tiled.cu) and B3's
// selection launch (correlator.cu): a query's sorted top-k of (d^2,
// index), k <= 16, kept across the 16 lanes of half a warp, slot s in
// lane s, so the two queries of a warp insert side by side.
//
// A step takes kStep candidates from a staged float4 buffer (x, y, z,
// |x|^2, or a negative w for an invalid candidate): kUnroll batches of 16,
// one distance a lane a batch (independent chains), a compare with the
// exact k-th slot and a ballot; each candidate that beats the k-th slot is
// then inserted by a shuffle shift (about ten instructions), so the k-th
// slot is always exact. Insertion orders by (d^2, index) whatever the
// order the candidates come in: ties go to the lowest index.
//
// Where more than kMergeAbove candidates of a batch beat the k-th slot
// for a query of the warp (the first batches of a query, while the list
// fills), the step takes each batch's ballot against the k-th slot as it
// stands and merges such a batch instead: a bitonic network sorts the
// batch across the 16 lanes and keeps the 16 nearest of list and batch,
// 15 compare-exchange stages in place of one insertion (about five
// dependent shuffle steps) a candidate. Otherwise the batches' ballots
// are taken together first, against the k-th slot as it was (a candidate
// that misses it as it was misses it as it becomes), and their
// candidates inserted.
#pragma once

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace ratrack {
namespace knn {

constexpr int kK = 16;        // deepest list: one slot a lane of a half warp
constexpr int kLanes = 16;    // lanes a query
constexpr int kUnroll = 4;    // batches of 16 candidates a step
constexpr int kStep = kUnroll * kLanes;
constexpr int kMergeAbove = 3;   // beating candidates a batch that merge
#ifdef RATRACK_SKELETON
constexpr bool kSkeleton = true;   // a measuring build: no insertion
#else
constexpr bool kSkeleton = false;
#endif

// (d, j) sorts before (od, oj): nearer, or as near with the lower index.
__device__ __forceinline__ bool before(float d, int j, float od, int oj) {
  return d < od || (d == od && j < oj);
}

struct HalfWarpList {
  int k, l16, half;
  float sd;   // slot l16 (lanes >= k hold none)
  int sj;
  float kd;   // the k-th slot, in every lane of the query
  int kj;

  // An empty list of depth k for the query of warp lane `lane`.
  __device__ __forceinline__ static HalfWarpList empty(int k, int lane) {
    HalfWarpList l;
    l.k = k;
    l.l16 = lane % kLanes;
    l.half = lane & kLanes;
    l.sd = l.kd = CUDART_INF_F;
    l.sj = l.kj = INT_MAX;
    return l;
  }

  // Insert, in turn, the candidates (d, j) of the lanes set in `mine`
  // that still beat the k-th slot; both queries of the warp side by side,
  // until neither has one left.
  __device__ __forceinline__ void insert(float d, int j, unsigned mine) {
    while (__any_sync(kFullMask, mine != 0u)) {
      const bool have = mine != 0u;
      const int src = have ? __ffs(mine) - 1 : 0;
      const float nd = __shfl_sync(kFullMask, d, src, kLanes);
      const int nj = __shfl_sync(kFullMask, j, src, kLanes);
      if (have) mine &= mine - 1u;
      const bool ins = have && before(nd, nj, kd, kj);
      const unsigned bef =
          (__ballot_sync(kFullMask, l16 < k && before(sd, sj, nd, nj)) >>
           half) &
          0xffffu;
      const int pos = __popc(bef);
      const float ud = __shfl_up_sync(kFullMask, sd, 1, kLanes);
      const int uj = __shfl_up_sync(kFullMask, sj, 1, kLanes);
      if (ins && l16 < k) {
        if (l16 == pos) {
          sd = nd;
          sj = nj;
        } else if (l16 > pos) {
          sd = ud;
          sj = uj;
        }
      }
      kd = __shfl_sync(kFullMask, sd, k - 1, kLanes);
      kj = __shfl_sync(kFullMask, sj, k - 1, kLanes);
    }
  }

  // One compare-exchange of a bitonic network across the half warp: with
  // the lane `stride` away, the lower lane keeps the earlier of the two
  // (ascending) or the later (not ascending), the upper lane the other.
  __device__ __forceinline__ void exchange(float& d, int& j, int stride,
                                           bool ascending) const {
    const float od = __shfl_xor_sync(kFullMask, d, stride, kLanes);
    const int oj = __shfl_xor_sync(kFullMask, j, stride, kLanes);
    const bool lower = (l16 & stride) == 0;
    if (lower == ascending ? before(od, oj, d, j) : before(d, j, od, oj)) {
      d = od;
      j = oj;
    }
  }

  // Merge a batch, one candidate (d, j) a lane, (inf, INT_MAX) for none:
  // sorted descending by a bitonic network, the slot-wise earlier of list
  // and batch holds the 16 nearest of both as a bitonic sequence, which
  // four more stages sort; slots from k on are emptied again.
  __device__ __forceinline__ void merge(float d, int j) {
#pragma unroll
    for (int size = 2; size <= kLanes; size <<= 1)
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1)
        exchange(d, j, stride, (l16 & size) != 0);
    if (before(d, j, sd, sj)) {
      sd = d;
      sj = j;
    }
#pragma unroll
    for (int stride = kLanes / 2; stride > 0; stride >>= 1)
      exchange(sd, sj, stride, true);
    if (l16 >= k) {
      sd = CUDART_INF_F;
      sj = INT_MAX;
    }
    kd = __shfl_sync(kFullMask, sd, k - 1, kLanes);
    kj = __shfl_sync(kFullMask, sj, k - 1, kLanes);
  }

  // The kStep candidates cb[0, kStep), indices j0 + e, against the query
  // (qx, qy, qz) with |q|^2 = sqq; an inactive query takes nothing but
  // joins the warp's ballots and shuffles.
  __device__ __forceinline__ void step(const float4* cb, int j0, float qx,
                                       float qy, float qz, float sqq,
                                       bool active) {
    float d[kUnroll];
    int j[kUnroll];
    bool ok[kUnroll];
    unsigned mine[kUnroll];
    bool many = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float4 p = cb[u * kLanes + l16];
      j[u] = j0 + u * kLanes + l16;
      d[u] = p.w >= 0.0f
                 ? sq_dist(qx, qy, qz, sqq, p.x, p.y, p.z, p.w)
                 : CUDART_INF_F;
      ok[u] = active && !kSkeleton && p.w >= 0.0f;
      mine[u] = (__ballot_sync(kFullMask,
                               ok[u] && before(d[u], j[u], kd, kj)) >>
                 half) &
                0xffffu;
      many = many || __popc(mine[u]) > kMergeAbove;
    }
    if (!__any_sync(kFullMask, many)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) insert(d[u], j[u], mine[u]);
      return;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool beats = ok[u] && before(d[u], j[u], kd, kj);
      const unsigned m =
          (__ballot_sync(kFullMask, beats) >> half) & 0xffffu;
      if (__any_sync(kFullMask, __popc(m) > kMergeAbove))
        merge(beats ? d[u] : CUDART_INF_F, beats ? j[u] : INT_MAX);
      else
        insert(d[u], j[u], m);
    }
  }
};

}  // namespace knn
}  // namespace ratrack
