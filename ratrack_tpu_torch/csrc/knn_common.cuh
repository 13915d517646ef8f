// The k-nearest selection shared by kernel B5 (knn_tiled.cu) and B3's
// selection launch (correlator.cu): a query's sorted top-k of (d^2,
// index), kept across a group of kW lanes, slot s in lane s. The depth is
// the template parameter kW: WarpList<16> (HalfWarpList) keeps k <= 16
// across half a warp, so the two queries of a warp insert side by side;
// WarpList<32> keeps k <= 32 across a whole warp, one query a warp (B5 at
// k = 32, FLOT's graph). A full warp and not two slots a lane: the list
// stays one slot a lane, so an insertion stays one shuffle shift and a
// slot's compare one compare, and the bitonic merge one more stage deep;
// two slots a lane would make every shift two dependent moves across lane
// pairs. The cost is half the queries a warp, with twice the candidates a
// batch (32), so a step's distances a lane are the same.
//
// A step takes kW * kUnroll candidates from a staged float4 buffer (x, y,
// z, |x|^2, or a negative w for an invalid candidate): kUnroll batches of
// kW, one distance a lane a batch (independent chains), a compare with the
// exact k-th slot and a ballot; each candidate that beats the k-th slot is
// then inserted by a shuffle shift (about ten instructions), so the k-th
// slot is always exact. Insertion orders by (d^2, index) whatever the
// order the candidates come in: ties go to the lowest index.
//
// Where more than kMergeAbove candidates of a batch beat the k-th slot
// for a query of the warp (the first batches of a query, while the list
// fills), the step takes each batch's ballot against the k-th slot as it
// stands and merges such a batch instead: a bitonic network sorts the
// batch across the kW lanes and keeps the kW nearest of list and batch,
// 15 compare-exchange stages at kW = 16 (21 at 32) in place of one
// insertion (about five dependent shuffle steps) a candidate. Otherwise
// the batches' ballots are taken together first, against the k-th slot as
// it was (a candidate that misses it as it was misses it as it becomes),
// and their candidates inserted.
#pragma once

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace ratrack {
namespace knn {

constexpr int kK = 16;        // deepest half-warp list: a slot a lane
constexpr int kLanes = 16;    // lanes a query of the half-warp list
constexpr int kKWarp = 32;    // deepest list: a slot a lane of a warp
constexpr int kUnroll = 4;    // batches of kW candidates a step
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

template <int kW>
struct WarpList {
  static_assert(kW == 16 || kW == 32, "a list is half a warp or a warp");
  static constexpr int kStep = kUnroll * kW;   // candidates a step
  // the list's lanes in a ballot shifted down by `half`
  static constexpr unsigned kMask = kW == 32 ? 0xffffffffu
                                             : (1u << kW) - 1u;
  int k, l16, half;   // l16: the lane's slot, lane % kW
  float sd;   // slot l16 (lanes >= k hold none)
  int sj;
  float kd;   // the k-th slot, in every lane of the query
  int kj;

  // An empty list of depth k for the query of warp lane `lane`.
  __device__ __forceinline__ static WarpList empty(int k, int lane) {
    WarpList l;
    l.k = k;
    l.l16 = lane % kW;
    l.half = lane & kW;   // 0 or 16 at kW = 16; 0 at kW = 32
    l.sd = l.kd = CUDART_INF_F;
    l.sj = l.kj = INT_MAX;
    return l;
  }

  // Insert, in turn, the candidates (d, j) of the lanes set in `mine`
  // that still beat the k-th slot; at kW = 16 both queries of the warp
  // side by side, until neither has one left.
  __device__ __forceinline__ void insert(float d, int j, unsigned mine) {
    while (__any_sync(kFullMask, mine != 0u)) {
      const bool have = mine != 0u;
      const int src = have ? __ffs(mine) - 1 : 0;
      const float nd = __shfl_sync(kFullMask, d, src, kW);
      const int nj = __shfl_sync(kFullMask, j, src, kW);
      if (have) mine &= mine - 1u;
      const bool ins = have && before(nd, nj, kd, kj);
      const unsigned bef =
          (__ballot_sync(kFullMask, l16 < k && before(sd, sj, nd, nj)) >>
           half) &
          kMask;
      const int pos = __popc(bef);
      const float ud = __shfl_up_sync(kFullMask, sd, 1, kW);
      const int uj = __shfl_up_sync(kFullMask, sj, 1, kW);
      if (ins && l16 < k) {
        if (l16 == pos) {
          sd = nd;
          sj = nj;
        } else if (l16 > pos) {
          sd = ud;
          sj = uj;
        }
      }
      kd = __shfl_sync(kFullMask, sd, k - 1, kW);
      kj = __shfl_sync(kFullMask, sj, k - 1, kW);
    }
  }

  // One compare-exchange of a bitonic network across the list's lanes: with
  // the lane `stride` away, the lower lane keeps the earlier of the two
  // (ascending) or the later (not ascending), the upper lane the other.
  __device__ __forceinline__ void exchange(float& d, int& j, int stride,
                                           bool ascending) const {
    const float od = __shfl_xor_sync(kFullMask, d, stride, kW);
    const int oj = __shfl_xor_sync(kFullMask, j, stride, kW);
    const bool lower = (l16 & stride) == 0;
    if (lower == ascending ? before(od, oj, d, j) : before(d, j, od, oj)) {
      d = od;
      j = oj;
    }
  }

  // Merge a batch, one candidate (d, j) a lane, (inf, INT_MAX) for none:
  // sorted descending by a bitonic network, the slot-wise earlier of list
  // and batch holds the kW nearest of both as a bitonic sequence, which
  // log2(kW) more stages sort; slots from k on are emptied again.
  __device__ __forceinline__ void merge(float d, int j) {
#pragma unroll
    for (int size = 2; size <= kW; size <<= 1)
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1)
        exchange(d, j, stride, (l16 & size) != 0);
    if (before(d, j, sd, sj)) {
      sd = d;
      sj = j;
    }
#pragma unroll
    for (int stride = kW / 2; stride > 0; stride >>= 1)
      exchange(sd, sj, stride, true);
    if (l16 >= k) {
      sd = CUDART_INF_F;
      sj = INT_MAX;
    }
    kd = __shfl_sync(kFullMask, sd, k - 1, kW);
    kj = __shfl_sync(kFullMask, sj, k - 1, kW);
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
      const float4 p = cb[u * kW + l16];
      j[u] = j0 + u * kW + l16;
      d[u] = p.w >= 0.0f
                 ? sq_dist(qx, qy, qz, sqq, p.x, p.y, p.z, p.w)
                 : CUDART_INF_F;
      ok[u] = active && !kSkeleton && p.w >= 0.0f;
      mine[u] = (__ballot_sync(kFullMask,
                               ok[u] && before(d[u], j[u], kd, kj)) >>
                 half) &
                kMask;
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
          (__ballot_sync(kFullMask, beats) >> half) & kMask;
      if (__any_sync(kFullMask, __popc(m) > kMergeAbove))
        merge(beats ? d[u] : CUDART_INF_F, beats ? j[u] : INT_MAX);
      else
        insert(d[u], j[u], m);
    }
  }
};

using HalfWarpList = WarpList<16>;

}  // namespace knn
}  // namespace ratrack
