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
// What bounds it on the H100: at the main-path shape (B=8, N=M=512) the
// work is small (~4 GFLOP of products a step, 80% of them sa3's 64 x 64
// layers over up to 16 + 32 slots a center; 0.023 ms at the 3xTF32 rate)
// and latency bounds it. One warp a center (the first design) made each
// layer a dependent chain of fmaf with two shared-memory loads each and
// re-read every weight for every slot. Measured (kernels/tune.py
// --sa-eval, the skeleton below): the ball query, the weights' staging
// and the compaction take ~0.017-0.020 ms a launch, most of sa1's and
// sa2's time, and at 8192 points the ball query is all but 10% of it.
// Design: a block owns a tile of T centers of one stream (T = 8 or 16 by
// the launch's center count, default_tile; 32 can be forced) and turns
// the per-slot work into tile products, with every device-memory load of
// a phase issued before the phase stores any:
//   1. ball query: the cloud passes through shared memory 1024 points at a
//      time and each warp scans it for its centers of the tile, 32 points
//      a ballot (exact first-hit slots, early exit; ball_query_tile);
//   2. compaction: an exclusive prefix sum over the centers' filled-slot
//      counts (one row for a center with no hit) packs every (center,
//      slot) pair of a scale into a contiguous row list, one segment a
//      center;
//   3. the rows go through the layers in chunks of 4096 / width rows:
//      layer 1 gathered as relu(P1[j] - CW[i]) with float4 loads, each
//      folded layer a product rows x C_in x C_out between two shared
//      activation tiles, the weights staged once a block (for T centers,
//      not 8) by cp.async under the ball query, zero-padded to a
//      multiple of 8 wide;
//   4. the last layer's epilogue max-pools each row into its center's
//      running max (relu'd values: an int atomicMax on the float bits in
//      shared memory, exact in any order).
// A layer's product is register tiles: each thread a 4-row x 4-column
// tile, float4 operands, one fmaf chain an output in ascending k. (3xTF32
// mma.sync m16n8k8 lost to it by 4-20% at every level config, tile and
// shape, PERF.md.) A measuring build (RATRACK_SKELETON, kernels/build.py)
// runs the ball query, the compaction and the index output but no layer,
// and writes zeros: the floor of the launch.
// Every output element depends on its own row and the weights only, in a
// fixed order, so neither the tile nor the chunking changes a result, and
// the one-scale instance runs the same per-scale body: a pair equals two
// one-scale launches bit for bit. One kernel launch a call.
//
// Operand type (template parameter Op, entries ratrack_sa_pair_bf16 and
// ratrack_sa_scale_bf16 for __nv_bfloat16): what the TPU kernel computes
// at compute_dtype=bfloat16. Each gathered P1 row is rounded to bfloat16
// (pallas_sa.py:177-182, 242-253), except a no-hit center's row, which
// pools relu(P1[0] - CW[i]) from the float32 row (pallas_sa.py:139-142);
// each folded layer multiplies bfloat16-rounded activations and weights
// (the activation tiles are stored rounded, the staged weights rounded
// once in shared memory) with float32 accumulation; bias, ReLU and the
// max stay float32, and so does the output. Products of bfloat16-rounded
// operands are exact in float32, so the register tiles stay as they are.
// The float instantiation is the float32 kernel unchanged.

#include "common.cuh"
#include "corr_common.cuh"

#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRest = 2;   // folded layers after layer 1
constexpr int kMaxC = 64;     // widest layer
constexpr int kMaxNs = 32;    // largest nsample
constexpr int kMaxTile = 32;  // centers a block
constexpr int kChunkFloats = 4096;  // rows x padded width of a row chunk
constexpr int kMaxChunkRows = 256;
constexpr int kCloud = 1024;        // cloud points staged a step (float4)
constexpr int kBatch = 4;           // loads a thread issues before storing
#ifdef RATRACK_SKELETON
constexpr bool kSkeleton = true;    // a measuring build: no layer, outputs 0
#else
constexpr bool kSkeleton = false;
#endif

struct Scale {
  const float* p1;   // (B, N, C1) hoisted layer-1 pre-activation per point
  const float* cw;   // (B, M, C1) per-center term
  const float* w[kMaxRest];   // (C_l, C_{l+1}) folded weights
  const float* b[kMaxRest];   // (C_{l+1},) folded biases
  int dims[kMaxRest + 1];     // C1, C2, ...
  int pdims[kMaxRest + 1];    // the same, rounded up to a multiple of 8
  int n_rest;
  int cout;          // dims[n_rest]
  float r2;
  int ns;
  float* out;        // (B, M, C_last)
  int* idx;          // (B, M, ns) selected indices, or null
  int wsize;         // floats of padded weights and biases in shared memory
  int chunk_rows;    // rows a chunk: kChunkFloats / widest padded layer
};

__host__ __device__ inline int pad8(int c) { return (c + 7) & ~7; }
// Row strides of an activation tile of padded width pc and of a weight
// matrix: skewed by 4 and 8 floats, rows stay 16-byte aligned for float4.
__host__ __device__ inline int act_stride(int pc) { return pc + 4; }
__host__ __device__ inline int w_stride(int pc_out) { return pc_out + 8; }

// 4 bytes global -> shared, asynchronously, or a zero where !valid.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Padded weights W_l (pd_l x w_stride(pd_{l+1}), zeros outside C_l x
// C_{l+1}) then b_l (pd_{l+1}), layer after layer, by cp.async: the copies
// run under the ball query (waited for in run_scale).
__device__ __forceinline__ void stage_weights(const Scale& s,
                                              float* dst) {
  int off = 0;
#pragma unroll   // constant indices: the kernel parameter stays in place
  for (int l = 0; l < kMaxRest; ++l) {
    if (l >= s.n_rest) break;
    const int ci = s.dims[l], co = s.dims[l + 1];
    const int ws = w_stride(s.pdims[l + 1]);
    const int nw = s.pdims[l] * ws;
    for (int e = threadIdx.x; e < nw; e += kThreads) {
      const int k = e / ws, c = e % ws;
      const bool in = k < ci && c < co;
      cp4(dst + off + e, s.w[l] + (in ? k * co + c : 0), in);
    }
    off += nw;
    for (int c = threadIdx.x; c < s.pdims[l + 1]; c += kThreads)
      cp4(dst + off + c, s.b[l] + (c < co ? c : 0), c < co);
    off += s.pdims[l + 1];
  }
  ratrack::corr::cp_commit();
}

// Where a layer's output element (row r < nr of the chunk, column c) goes:
// into the next activation tile, or, after the last layer (pool != null),
// into the running max of the row's center. Every output is relu'd, so
// >= 0, where a float's bits order as an int's: the max is an int
// atomicMax, exact in any order.
struct Sink {
  float* hout;       // (rows, act_stride(pco))
  int* pool;         // (tile, kMaxC) float bits, or null
  const int* rowct;  // the chunk's rows' tile-local centers
  int cout;          // real output columns
  int nr;            // real rows of the chunk
};

__device__ __forceinline__ void sink_pool(const Sink& o, int r, int c,
                                          float v) {
  if (r < o.nr && c < o.cout)
    atomicMax(o.pool + o.rowct[r] * kMaxC + c, __float_as_int(v));
}

// relu(hin @ W + b) over rows [0, nr) (rounded up to 4) into `o`: a
// thread per 4 x 4 output tile; an activation tile receives Op operands.
template <typename Op>
__device__ void layer_registers(const float* hin, int pci, const float* w,
                                const float* bias, int pco, const Sink& o) {
  const int nr = o.nr;
  const int si = act_stride(pci), so = act_stride(pco), sw = w_stride(pco);
  const int groups = pco / 4;
  const int tiles = ((nr + 3) / 4) * groups;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int r0 = (t / groups) * 4, c0 = (t % groups) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < pci; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(hin + (r0 + i) * si + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        b[kk] = *reinterpret_cast<const float4*>(w + (k + kk) * sw + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[i][0] = fmaf(av[kk], b[kk].x, acc[i][0]);
          acc[i][1] = fmaf(av[kk], b[kk].y, acc[i][1]);
          acc[i][2] = fmaf(av[kk], b[kk].z, acc[i][2]);
          acc[i][3] = fmaf(av[kk], b[kk].w, acc[i][3]);
        }
      }
    }
    const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = make_float4(
          fmaxf(acc[i][0] + bv.x, 0.0f), fmaxf(acc[i][1] + bv.y, 0.0f),
          fmaxf(acc[i][2] + bv.z, 0.0f), fmaxf(acc[i][3] + bv.w, 0.0f));
      if (o.pool == nullptr) {
        *reinterpret_cast<float4*>(o.hout + (r0 + i) * so + c0) =
            ratrack::as_operand<Op>(v);
      } else {
        sink_pool(o, r0 + i, c0, v.x);
        sink_pool(o, r0 + i, c0 + 1, v.y);
        sink_pool(o, r0 + i, c0 + 2, v.z);
        sink_pool(o, r0 + i, c0 + 3, v.w);
      }
    }
  }
}

// Shared scratch of the per-scale body.
struct Work {
  float* act0;   // two activation tiles of kChunkFloats-ish floats
  float* act1;
  int* pool;     // (tile, kMaxC) running max, as float bits
  int* start;    // (tile + 1) first row of each center
  int* rowpt;    // (tile * ns) point of each row
  int* rowct;    // (tile * ns) tile-local center of each row
};

// The staged weights W_l (not the biases) as Op operands, each thread
// the elements it copied in stage_weights, once its copies have landed.
template <typename Op>
__device__ __forceinline__ void round_weights(const Scale& s, float* dst) {
  if constexpr (ratrack::kBf16<Op>) {
    int off = 0;
#pragma unroll
    for (int l = 0; l < kMaxRest; ++l) {
      if (l >= s.n_rest) break;
      const int nw = s.pdims[l] * w_stride(s.pdims[l + 1]);
      for (int e = threadIdx.x; e < nw; e += kThreads)
        dst[off + e] = ratrack::as_operand<Op>(dst[off + e]);
      off += nw + s.pdims[l + 1];
    }
  }
}

// One scale over the block's nc centers: compaction, row chunks through
// the layers, max-pool, outputs.
template <typename Op>
__device__ __forceinline__ void run_scale(const Scale& s, float* sw,
                                          const int* slots, const int* hits,
                                          int nc, int bi, int c_first, int n,
                                          int m, const Work& wk) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  ratrack::corr::cp_wait<0>();   // this thread's weight copies
  round_weights<Op>(s, sw);       // seen by all after the barrier below
  if (warp == 0) {   // exclusive prefix sum of max(hits, 1)
    int carry = 0;
    for (int base = 0; base < nc; base += 32) {
      const int c = base + lane;
      const int rows = c < nc ? max(hits[c], 1) : 0;
      int incl = rows;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(ratrack::kFullMask, incl, off);
        if (lane >= off) incl += v;
      }
      if (c < nc) wk.start[c] = carry + incl - rows;
      carry += __shfl_sync(ratrack::kFullMask, incl, 31);
    }
    if (lane == 0) wk.start[nc] = carry;
  }
  for (int e = tid; e < nc * kMaxC; e += kThreads) wk.pool[e] = 0;   // +0.0
  __syncthreads();
  for (int c = warp; c < nc; c += kWarps) {
    const int h = hits[c], s0 = wk.start[c], rows = max(h, 1);
    for (int t = lane; t < rows; t += 32) {
      wk.rowpt[s0 + t] = h > 0 ? slots[c * s.ns + t] : 0;
      wk.rowct[s0 + t] = c;
    }
  }
  __syncthreads();

  const int total = wk.start[nc];
  const int c1 = s.dims[0], pc1 = s.pdims[0], cout = s.cout;
  const float* p1 = s.p1 + (size_t)bi * n * c1;
  const float* cwb = s.cw + ((size_t)bi * m + c_first) * c1;
  const bool vec = (c1 & 3) == 0;
  for (int r0 = 0; r0 < (kSkeleton ? 0 : total); r0 += s.chunk_rows) {
    const int nr = min(s.chunk_rows, total - r0);
    {   // layer 1: relu(P1[j] - CW[i]), zero past C1; each thread issues
        // kBatch rows' loads before it stores any (the stores to shared
        // memory would otherwise wait for each load in turn)
      const int s1 = act_stride(pc1), q4 = pc1 / 4, items = nr * q4;
      for (int e0 = tid; e0 < items; e0 += kBatch * kThreads) {
        float4 av[kBatch], bv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, r = e / q4, c = (e % q4) * 4;
          av[u] = bv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (e < items && vec && c < c1) {
            av[u] = *reinterpret_cast<const float4*>(
                p1 + (size_t)wk.rowpt[r0 + r] * c1 + c);
            bv[u] = *reinterpret_cast<const float4*>(
                cwb + (size_t)wk.rowct[r0 + r] * c1 + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, r = e / q4, c = (e % q4) * 4;
          if (e >= items) break;
          // a gathered row is an Op operand; a no-hit center's is not
          bool gathered = false;
          if constexpr (ratrack::kBf16<Op>) {
            gathered = hits[wk.rowct[r0 + r]] > 0;
            if (gathered) av[u] = ratrack::as_operand<Op>(av[u]);
          }
          float4 v = make_float4(fmaxf(__fsub_rn(av[u].x, bv[u].x), 0.0f),
                                 fmaxf(__fsub_rn(av[u].y, bv[u].y), 0.0f),
                                 fmaxf(__fsub_rn(av[u].z, bv[u].z), 0.0f),
                                 fmaxf(__fsub_rn(av[u].w, bv[u].w), 0.0f));
          if (!vec) {
            const float* pj = p1 + (size_t)wk.rowpt[r0 + r] * c1;
            const float* ci = cwb + (size_t)wk.rowct[r0 + r] * c1;
            float t4[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              float pv = c + w < c1 ? pj[c + w] : 0.0f;
              if (gathered) pv = ratrack::as_operand<Op>(pv);
              t4[w] = c + w < c1 ? fmaxf(__fsub_rn(pv, ci[c + w]), 0.0f)
                                 : 0.0f;
            }
            v = make_float4(t4[0], t4[1], t4[2], t4[3]);
          }
          if (s.n_rest > 0) {
            *reinterpret_cast<float4*>(wk.act0 + r * s1 + c) =
                ratrack::as_operand<Op>(v);
          } else {   // layer 1 is the last: pool it
            const Sink o{nullptr, wk.pool, wk.rowct + r0, c1, nr};
            sink_pool(o, r, c, v.x);
            sink_pool(o, r, c + 1, v.y);
            sink_pool(o, r, c + 2, v.z);
            sink_pool(o, r, c + 3, v.w);
          }
        }
      }
    }
    __syncthreads();
    float* hin = wk.act0;
    float* hout = wk.act1;
    const float* wp = sw;
#pragma unroll
    for (int l = 0; l < kMaxRest; ++l) {
      if (l >= s.n_rest) break;
      const int pci = s.pdims[l], pco = s.pdims[l + 1];
      const float* bl = wp + pci * w_stride(pco);
      const Sink o{hout, l + 1 == s.n_rest ? wk.pool : nullptr,
                   wk.rowct + r0, cout, nr};
      layer_registers<Op>(hin, pci, wp, bl, pco, o);
      __syncthreads();
      wp = bl + pco;
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
  }
  float* out = s.out + ((size_t)bi * m + c_first) * cout;
  for (int e = tid; e < nc * cout; e += kThreads)
    out[e] = __int_as_float(wk.pool[(e / cout) * kMaxC + e % cout]);
  if (s.idx != nullptr) {
    int* idx = s.idx + ((size_t)bi * m + c_first) * s.ns;
    for (int e = tid; e < nc * s.ns; e += kThreads) {
      const int c = e / s.ns, t = e % s.ns, h = hits[c];
      idx[e] = h > 0 ? slots[c * s.ns + (t < h ? t : 0)] : 0;
    }
  }
  __syncthreads();   // start / rows / pool are reused by the next scale
}

// Floats of one activation tile of a scale.
__host__ __device__ inline int act_floats(const Scale& s) {
  int pmax = 0;
  for (int l = 0; l <= s.n_rest; ++l) pmax = max(pmax, s.pdims[l]);
  return s.chunk_rows * act_stride(pmax);
}

// Ball query of the block's nc centers (tile-local c: centers ctr[3c..])
// at both radii: the first nsa (nsb) valid points of the stream's cloud
// with d^2 < r2a (r2b), in index order, into slots_a (slots_b) rows of
// their center; filled counts into hits[c] / hits[tile + c]. The cloud
// passes through shared memory (`cloud`, kCloud float4: x, y, z, |x|^2 or
// -1 for an invalid point) kCloud points at a time, so that a step of a
// warp's scan reads shared memory, not device memory; a warp scans for
// each of its centers 32 points a step, ranks every hit at both radii
// with a ballot and __popc, and stops once both lists are full, and the
// block stops staging once every center is full. The same comparisons as
// common.cuh::ball_query_pair, in the same order: the same slots.
__device__ void ball_query_tile(const float* xb, const unsigned char* mb,
                                int n, const float* ctr, int nc, float r2a,
                                int nsa, float r2b, int nsb, int* slots_a,
                                int* slots_b, int* hits, int tile,
                                float4* cloud) {
  constexpr int kPer = kMaxTile / kWarps;   // centers a warp at most
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  float cx[kPer], cy[kPer], cz[kPer], sqc[kPer];
  int cnt_a[kPer], cnt_b[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = warp + i * kWarps;
    cx[i] = cy[i] = cz[i] = sqc[i] = 0.0f;
    cnt_a[i] = c < nc ? 0 : nsa;      // a center past the tile is full
    cnt_b[i] = c < nc ? 0 : nsb;
    if (c < nc) {
      cx[i] = ctr[3 * c];
      cy[i] = ctr[3 * c + 1];
      cz[i] = ctr[3 * c + 2];
      sqc[i] = ratrack::sq_norm3(cx[i], cy[i], cz[i]);
    }
  }
  for (int base = 0; base < n; base += kCloud) {
    bool done = true;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      done = done && cnt_a[i] >= nsa && cnt_b[i] >= nsb;
    if (__syncthreads_and(done)) break;   // also: the last stage is read
    const int cnt = min(kCloud, n - base);
    for (int e0 = tid; e0 < cnt; e0 += kBatch * kThreads) {
      float4 v[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, j = base + e;
        ok[u] = e < cnt;
        if (ok[u]) {
          v[u] = make_float4(xb[3 * j], xb[3 * j + 1], xb[3 * j + 2], 0.0f);
          ok[u] = mb == nullptr || mb[j] != 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= cnt) break;
        v[u].w = ok[u] ? ratrack::sq_norm3(v[u].x, v[u].y, v[u].z) : -1.0f;
        cloud[e] = v[u];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = warp + i * kWarps;
      // two 32-point steps at a time (independent distance chains); the
      // ranks run in index order, so the slots are those of one step at a
      // time, and hits past a full list are counted and dropped
      for (int sub = 0; sub < cnt; sub += 64) {
        if (cnt_a[i] >= nsa && cnt_b[i] >= nsb) break;
        bool ha[2], hb[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = sub + 32 * u + lane;
          ha[u] = hb[u] = false;
          if (e < cnt) {
            const float4 p = cloud[e];
            if (p.w >= 0.0f) {
              const float d = ratrack::sq_dist(cx[i], cy[i], cz[i], sqc[i],
                                               p.x, p.y, p.z, p.w);
              ha[u] = d < r2a;
              hb[u] = d < r2b;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = sub + 32 * u + lane;
          const unsigned bal_a = __ballot_sync(ratrack::kFullMask, ha[u]);
          const unsigned bal_b = __ballot_sync(ratrack::kFullMask, hb[u]);
          if (ha[u]) {
            const int r = cnt_a[i] + __popc(bal_a & below);
            if (r < nsa) slots_a[c * nsa + r] = base + e;
          }
          if (hb[u]) {
            const int r = cnt_b[i] + __popc(bal_b & below);
            if (r < nsb) slots_b[c * nsb + r] = base + e;
          }
          cnt_a[i] += __popc(bal_a);
          cnt_b[i] += __popc(bal_b);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = warp + i * kWarps;
    if (lane == 0 && c < nc) {
      hits[c] = min(cnt_a[i], nsa);
      hits[tile + c] = min(cnt_b[i], nsb);
    }
  }
  __syncthreads();
}

// kTwo: both scales of a level (B1); otherwise scale a alone (B1'), sb
// unread. Op: the products' operand type. Grid: (center tiles, streams).
template <bool kTwo, typename Op>
__global__ void __launch_bounds__(kThreads)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
          const unsigned char* __restrict__ mask, int n, int m, int tile,
          int act, Scale sa, Scale sb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ns_b = kTwo ? sb.ns : 0;
  const int ns_max = max(sa.ns, ns_b);
  float* swa = smem;
  float* swb = swa + sa.wsize;
  Work wk;
  wk.act0 = swb + (kTwo ? sb.wsize : 0);
  wk.act1 = wk.act0 + act;
  wk.pool = reinterpret_cast<int*>(wk.act1 + act);
  int* slots_a = wk.pool + tile * kMaxC;
  int* slots_b = slots_a + tile * sa.ns;
  int* hits = slots_b + tile * ns_b;        // (2, tile)
  wk.start = hits + 2 * tile;
  wk.rowpt = wk.start + tile + 1;
  wk.rowct = wk.rowpt + tile * ns_max;

  stage_weights(sa, swa);
  if (kTwo) stage_weights(sb, swb);

  const int bi = blockIdx.y, c_first = blockIdx.x * tile;
  const int nc = min(tile, m - c_first);
  const float* xb = xyz + (size_t)bi * n * 3;
  const unsigned char* mb = mask != nullptr ? mask + (size_t)bi * n : nullptr;
  // the activation tiles are free until the layers run: the staged cloud
  ball_query_tile(xb, mb, n, centers + ((size_t)bi * m + c_first) * 3, nc,
                  sa.r2, sa.ns, kTwo ? sb.r2 : -1.0f, ns_b, slots_a, slots_b,
                  hits, tile, reinterpret_cast<float4*>(wk.act0));
  run_scale<Op>(sa, swa, slots_a, hits, nc, bi, c_first, n, m, wk);
  if (kTwo)
    run_scale<Op>(sb, swb, slots_b, hits + tile, nc, bi, c_first, n, m, wk);
}

// Centers a block unless forced (read off kernels/tune.py --sa-eval): 16
// from 2048 centers a launch on (8 x 512 centers: 256 blocks, one wave of
// two a SM), 8 below (512 centers at 8192 points: the ball query's warps
// are the work, and 16 would leave most SMs idle).
int default_tile(int nb, int m) { return (long long)nb * m >= 2048 ? 16 : 8; }

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
  int pmax = 0;
  for (int l = 0; l <= n_rest; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxC) return false;
    s->dims[l] = dims[l];
    s->pdims[l] = pad8(dims[l]);
    pmax = pmax > s->pdims[l] ? pmax : s->pdims[l];
  }
  s->cout = dims[n_rest];
  for (int l = 0; l < n_rest; ++l) {
    s->w[l] = w[l];
    s->b[l] = b[l];
    s->wsize += s->pdims[l] * w_stride(s->pdims[l + 1]) + s->pdims[l + 1];
  }
  const int rows = (kChunkFloats / pmax) & ~15;   // a multiple of 16
  s->chunk_rows = rows < kMaxChunkRows ? rows : kMaxChunkRows;
  return true;
}

template <bool kTwo, typename Op>
int launch_sa(const float* xyz, const float* centers,
              const unsigned char* mask, int nb, int n, int m, Scale& sa,
              Scale& sb, int tile, void* stream) {
  if (tile == 0) tile = default_tile(nb, m);
  if (tile != 8 && tile != 16 && tile != kMaxTile)
    return (int)cudaErrorInvalidValue;
  // the two activation tiles also hold the staged cloud
  const int act =
      max(max(act_floats(sa), kTwo ? act_floats(sb) : 0), 2 * kCloud);
  const int ns_b = kTwo ? sb.ns : 0;
  const int ns_max = max(sa.ns, ns_b);
  const size_t smem =
      sizeof(float) * (sa.wsize + (kTwo ? sb.wsize : 0) + 2 * act +
                       tile * kMaxC) +
      sizeof(int) * (tile * (sa.ns + ns_b) + 2 * tile + tile + 1 +
                     2 * tile * ns_max);
  cudaError_t err = cudaFuncSetAttribute(
      sa_kernel<kTwo, Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + tile - 1) / tile, nb);
  sa_kernel<kTwo, Op><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xyz, centers, mask, n, m, tile, act, sa, sb);
  return (int)cudaGetLastError();
}

template <typename Op>
int sa_pair_entry(
    const float* xyz, const float* centers, const unsigned char* mask, int nb,
    int n, int m,
    const float* p1a, const float* cwa, const float* const* wa,
    const float* const* ba, const int* dims_a, int n_rest_a, float r2a,
    int nsa, float* out_a, int* idx_a,
    const float* p1b, const float* cwb, const float* const* wb,
    const float* const* bb, const int* dims_b, int n_rest_b, float r2b,
    int nsb, float* out_b, int* idx_b, int tile, void* stream) {
  Scale sa, sb;
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 ||
      !make_scale(&sa, p1a, cwa, wa, ba, dims_a, n_rest_a, r2a, nsa, out_a,
                  idx_a) ||
      !make_scale(&sb, p1b, cwb, wb, bb, dims_b, n_rest_b, r2b, nsb, out_b,
                  idx_b))
    return (int)cudaErrorInvalidValue;
  return launch_sa<true, Op>(xyz, centers, mask, nb, n, m, sa, sb, tile,
                             stream);
}

template <typename Op>
int sa_scale_entry(
    const float* xyz, const float* centers, const unsigned char* mask, int nb,
    int n, int m, const float* p1, const float* cw, const float* const* w,
    const float* const* b, const int* dims, int n_rest, float r2, int ns,
    float* out, int* idx, int tile, void* stream) {
  Scale s;
  if (nb < 1 || nb > 65535 || n < 1 || m < 1 ||
      !make_scale(&s, p1, cw, w, b, dims, n_rest, r2, ns, out, idx))
    return (int)cudaErrorInvalidValue;
  return launch_sa<false, Op>(xyz, centers, mask, nb, n, m, s, s, tile,
                              stream);
}

}  // namespace

#define RATRACK_SA_PAIR_ARGS                                                  \
  const float *xyz, const float *centers, const unsigned char *mask, int nb,  \
      int n, int m, const float *p1a, const float *cwa,                      \
      const float *const *wa, const float *const *ba, const int *dims_a,     \
      int n_rest_a, float r2a, int nsa, float *out_a, int *idx_a,            \
      const float *p1b, const float *cwb, const float *const *wb,            \
      const float *const *bb, const int *dims_b, int n_rest_b, float r2b,    \
      int nsb, float *out_b, int *idx_b, int tile, void *stream
#define RATRACK_SA_PAIR_CALL                                                  \
  xyz, centers, mask, nb, n, m, p1a, cwa, wa, ba, dims_a, n_rest_a, r2a, nsa, \
      out_a, idx_a, p1b, cwb, wb, bb, dims_b, n_rest_b, r2b, nsb, out_b,     \
      idx_b, tile, stream
#define RATRACK_SA_SCALE_ARGS                                                 \
  const float *xyz, const float *centers, const unsigned char *mask, int nb,  \
      int n, int m, const float *p1, const float *cw, const float *const *w, \
      const float *const *b, const int *dims, int n_rest, float r2, int ns,  \
      float *out, int *idx, int tile, void *stream
#define RATRACK_SA_SCALE_CALL                                                 \
  xyz, centers, mask, nb, n, m, p1, cw, w, b, dims, n_rest, r2, ns, out, idx, \
      tile, stream

// tile: centers a block (8, 16 or 32; 0: default_tile).
extern "C" int ratrack_sa_pair(RATRACK_SA_PAIR_ARGS) {
  return sa_pair_entry<float>(RATRACK_SA_PAIR_CALL);
}

// Kernel B1 with bfloat16 operands (see the header).
extern "C" int ratrack_sa_pair_bf16(RATRACK_SA_PAIR_ARGS) {
  return sa_pair_entry<__nv_bfloat16>(RATRACK_SA_PAIR_CALL);
}

// Kernel B1': one scale of a level; tile as ratrack_sa_pair.
extern "C" int ratrack_sa_scale(RATRACK_SA_SCALE_ARGS) {
  return sa_scale_entry<float>(RATRACK_SA_SCALE_CALL);
}

// Kernel B1' with bfloat16 operands.
extern "C" int ratrack_sa_scale_bf16(RATRACK_SA_SCALE_ARGS) {
  return sa_scale_entry<__nv_bfloat16>(RATRACK_SA_SCALE_CALL);
}

extern "C" const char* ratrack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
