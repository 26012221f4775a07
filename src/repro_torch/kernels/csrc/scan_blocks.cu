// The block walk of the scan and progressive searches on Hopper (sm_90a).
//
// Replaces: src/repro/core/search_device.py `_scan_blocks` (the `lax.scan`
// body at :441) and `search_batch_progressive` (the body at :611). Neither
// is a Pallas kernel: XLA compiles each loop into one program. Run eagerly,
// a round of the walk would be about ten launches per step and up to NB
// steps (125,000 at n = 1M), so the walk is one kernel call instead.
//
// The function (`ref.scan_blocks_ref`): each query walks its blocks in the
// given order, `budget` steps at most (scan: at most n_sel). A step is live
// while Condition A has not stopped the walk and, in scan mode, t < n_sel;
// in progressive mode, while the block qualifies under the running k-th
// score s_k:
//   r = sqrt(max(x_p * (M_blk + |q|^2 - 2 max(s_k, -1e30) / c), 0)),
//   r = -1 if cs_prune and sqrt(M_blk) * sqrt(|q|^2) < s_k,
//   live iff gap_blk <= r and r >= 0
// (`search_common.adaptive_radii` + `gap_select`, each operation an IEEE
// intrinsic in the same order as the f32 plain version). A live step merges
// the block's valid rows into the top-k as `lax.top_k` over [carried, new
// rows] does: a row enters only when its score beats the k-th strictly,
// after every entry it ties. The carried top-k is sorted descending.
//
// The design splits each query's walk into segments of S = 256 / page_rows
// steps (one 256-row tile) and spreads them over every SM; the rows are
// scored apart from the sequential part, which reads per-step and
// per-segment records and row scores instead of rows. Three launches on one
// stream:
//   1. memset of the segment flags and counters;
//   2. setup (one block per query): the output top-k = the carried one,
//      pages = cand = 0, done = Condition A on the carried k-th, the carried
//      entries >= c_half; the walk's length, its segment count (0 for a
//      query done at the start), and the queries ranked by segment count
//      for the work list;
//   3. walk (a persistent grid, `resident_blocks` per SM): each block takes
//      work items (query, segment) from one atomic counter, segment-major in
//      walk order over the queries ranked longest first, so a long walk gets
//      as many SMs as it has segments and B < 132 leaves none idle. An item
//        - reads the segment's order entries (and, in progressive mode, its
//          gaps and block norms) at once and picks the blocks to score: in
//          scan mode every step, in progressive mode the blocks that qualify
//          under the s_k the replay last published. s_k only grows and the
//          radius only shrinks with it (each rounded operation is monotone),
//          so a block that fails under an earlier s_k fails at its step too:
//          the scored blocks are a superset of the live ones;
//        - skips the segment when the chain has published the query's
//          Condition-A stop, so the pages read past the stop are only those
//          already in flight;
//        - stages the chosen rows in 32-deep slices (16-byte cp.async.cg
//          when d % 4 == 0, else 4-byte copies) through a two-stage ring:
//          the next slice, or the next item's first slice, is in flight while
//          one is scored and merged. Each staged 128-byte row slice is
//          XOR-swizzled by 16-byte unit (unit c of row r at c ^ (r & 7)), so
//          the thread-per-row float4 reads are free of bank conflicts; the
//          query's slice travels with the rows;
//        - writes each row's score (-inf on padding rows) and one record a
//          step (progressive: gap, block norm, max valid score, valid rows or
//          -1 if not scored; scan: valid rows >= c_half and valid rows), in
//          scan mode also the segment's (max valid score, rows >= c_half,
//          valid rows), then marks the segment READY.
//      Each query's sequential part is a chain through its segments in
//      order. The block that scores segment 0, or that finds the chain
//      waiting for its segment (WANT), carries it on; when the next segment
//      is not READY it writes the state back and sets WANT with a
//      compare-and-swap, and the segment's scorer, whose exchange to READY
//      sees WANT, takes the chain over. No block ever waits on another.
//        - Scan mode (`count_walk`) finds the stop by counting: the top-k's
//          k-th score reaches c_half at the first step at which the carried
//          entries >= c_half plus the valid rows >= c_half walked reach k.
//          Over up to 32 READY segments, one a lane, a prefix sum of the
//          segments' counts finds the stop segment, and the stop is
//          published at once; a prefix sum of its steps' counts finds the
//          stop step. The top-k is the top k of [carried, rows walked] by
//          score, then walk position: the block stages the segments before
//          the stop whose max beats the running k-th score, and the stop
//          segment, in the ring stage it has just scored, and warp 0 merges
//          their rows (the stop segment's up to the stop step) in walk
//          order.
//        - Progressive mode (`replay`) replays: liveness depends on the
//          running k-th score. A window runs from the next step over the
//          READY segments that follow, at most 1,024 steps, cut where its
//          candidate steps (those whose max beats s_k at the window's start)
//          pass 2,048 rows; the block stages its records, then the
//          candidates' row scores and order entries, in the ring stage it
//          has just scored, and warp 0 walks it 32 steps at a time: while
//          s_k holds, one ballot evaluates 32 steps' liveness and finds the
//          first live step whose max beats s_k, whose rows are then merged
//          in row order.
// Both merges are the plain walk's insertion (a row enters when it beats
// the k-th strictly, after every entry it ties), so top_s / top_r, pages,
// cand and done are those of the sequential walk bit for bit.
//
// Every score is one fmaf chain from 0.f over depth 0..d-1 in order, the
// order of the GEMM plain version on the card. No tensor cores: TF32 would
// round the scores that decide the stop and the rows.
//
// What bounds it: the pages the walk reads, page_rows * d * 4 bytes each,
// at 3.35 TB/s (`launch/roofline.py` counts the union of the walked pages
// once). Each (query, page) pair is read once here; sharing a page between
// the queries that walk it is left for a later version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "launch_cache.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 256;             // rows a tile scores, one a thread
constexpr int DS = 32;             // depth slice staged at a time (8 x 16 B)
constexpr int STAGES = 2;
constexpr int STAGE_FLOATS = R * DS + DS;   // the rows' slice and q's
constexpr float MIN_SCORE = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;   // the H100's opt-in shared memory a block
constexpr int EMPTY = 0, READY = 1, WANT = 2;   // a segment's flag
constexpr int WIN_STEPS = 1024;    // steps a replay window holds at most
constexpr int WIN_ROWS = 2048;     // candidate row scores a window holds
static_assert(6 * WIN_STEPS + WIN_ROWS <= STAGE_FLOATS,
              "a replay window fits in one stage of the ring");
static_assert(WIN_STEPS % THREADS == 0, "whole steps a thread");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int ld_flag(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// A float's bits as an int whose signed order is the float order (-0 < +0).
__device__ __forceinline__ int fkey(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float fkey_inv(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

struct Args {
  const float* x;
  const int* ids;
  const float* q;
  const int* order;
  const int* n_sel;
  const float* gap;
  const float* blk_l2sq;
  const float* q_l2sq;
  const float* init_s;
  const int* init_r;
  const float* c_half;
  float* top_s;
  int* top_r;
  int* pages;
  int* cand;
  bool* done;
  int d, nb, k, pr, budget, progressive, cs_prune;
  float c, x_p;
};

// The scratch (`scan_blocks_scratch_bytes`), carved by the launcher.
struct Work {
  int* hdr;     // [0] setup blocks arrived, [1] next item, [2] items
  int* flag;    // (B, nseg_cap) EMPTY / READY / WANT
  int* nseg;    // (B,) segments of each walk
  int* lim;     // (B,) steps of each walk
  int* sn;      // (B + 1,) segment counts ranked descending (sn[B] = 0)
  int* sq;      // (B + 1,) the query of each rank
  int* ecum;    // (B + 1,) items before segment sn[j] (ecum[B] = 0)
  float* skp;   // (B,) the s_k the replay last published
  int* dnp;     // (B,) 1 once the chain has stopped the walk
  int* hcnt;    // (B,) scan: entries >= c_half so far (carried and walked)
  int4* segs;   // (B, nseg_cap) scan: max valid score, rows >= c_half, valid
                // rows of each segment
  float4* rec;  // (B, cap) per step: progressive: gap, norm, max valid
                // score, valid rows or -1; scan: rows >= c_half, -, -,
                // valid rows
  float* sc;    // (B, cap, page_rows) row scores of the scored steps
  int nq, nseg_cap, cap, seg;   // B; seg = S, steps a segment
};

__device__ __forceinline__ bool qualify(float gap, float m_l2sq, float s_k,
                                        float q_l2sq, float c, float x_p,
                                        bool cs_prune) {
  const float denom =
      __fsub_rn(__fadd_rn(m_l2sq, q_l2sq),
                __fdiv_rn(__fmul_rn(2.f, fmaxf(s_k, MIN_SCORE)), c));
  float r = __fsqrt_rn(fmaxf(__fmul_rn(x_p, denom), 0.f));
  if (cs_prune && !(__fmul_rn(__fsqrt_rn(m_l2sq), __fsqrt_rn(q_l2sq)) >= s_k))
    r = -1.f;
  return gap <= r && r >= 0.f;
}

// Insert (s, row) into the descending top-k in shared memory, after every
// entry >= s. Called by all 32 lanes of one warp with the same arguments;
// the caller guarantees s > top_s[k - 1].
__device__ __forceinline__ void insert(float* top_s, int* top_r, int k,
                                       float s, int row, int lane) {
  int ge = 0;
  for (int j = lane; j < k; j += 32) ge += top_s[j] >= s;
  const int pos = __reduce_add_sync(FULL, ge);
  // shift [pos, k - 1) up by one, 32 targets at a time from the top
  for (int hi = k - 1; hi > pos; hi -= 32) {
    const int j = hi - lane;
    const bool act = j > pos;
    float vs = 0.f;
    int vr = 0;
    if (act) {
      vs = top_s[j - 1];
      vr = top_r[j - 1];
    }
    __syncwarp();
    if (act) {
      top_s[j] = vs;
      top_r[j] = vr;
    }
    __syncwarp();
  }
  if (lane == 0) {
    top_s[pos] = s;
    top_r[pos] = row;
  }
  __syncwarp();
}

// Merge rows 0..nrows-1 of a run (row rr's score score(rr), its row of x
// row(rr)) into the top-k in row order: each row that beats the k-th score
// strictly enters, as in the plain walk's step. Called by all 32 lanes.
template <class Score, class Row>
__device__ __forceinline__ void merge_rows(float* top_s, int* top_r, int k,
                                           int nrows, int lane, Score score,
                                           Row row) {
  for (int r0 = 0; r0 < nrows; r0 += 32) {
    const int rr = r0 + lane;
    const float sv = rr < nrows ? score(rr) : -CUDART_INF_F;
    unsigned mk = __ballot_sync(FULL, sv > top_s[k - 1]);
    while (mk) {
      const int src = __ffs(mk) - 1;
      const float v = __shfl_sync(FULL, sv, src);
      insert(top_s, top_r, k, v, row(r0 + src), lane);
      mk &= ~((2u << src) - 1u);
      mk &= __ballot_sync(FULL, sv > top_s[k - 1]);
    }
  }
}

__device__ __forceinline__ int walk_limit(const Args& a, int b) {
  const int cap = min(a.budget, a.nb);
  return max(0, a.progressive ? cap : min(cap, a.n_sel[b]));
}

__device__ __forceinline__ int walk_segments(const Args& a, const Work& w,
                                             int b) {
  if (a.init_s[static_cast<int64_t>(b) * a.k + a.k - 1] >= a.c_half[b])
    return 0;                                 // done before its first step
  return (walk_limit(a, b) + w.seg - 1) / w.seg;
}

// ---------------------------------------------------------------- setup

__global__ void __launch_bounds__(THREADS)
scan_setup_kernel(const Args a, const Work w) {
  const int b = blockIdx.x, tid = threadIdx.x, B = gridDim.x, k = a.k;
  __shared__ int red[WARPS], redh[WARPS];
  __shared__ int s_last;
  __shared__ int buf[THREADS];
  const int64_t o = static_cast<int64_t>(b) * k;
  for (int j = tid; j < k; j += THREADS) {
    a.top_s[o + j] = a.init_s[o + j];
    a.top_r[o + j] = a.init_r[o + j];
  }
  const int mine = walk_segments(a, w, b);
  int before = 0;
  for (int bb = tid; bb < B; bb += THREADS) {
    const int other = walk_segments(a, w, bb);
    before += other > mine || (other == mine && bb < b);
  }
  before = __reduce_add_sync(FULL, before);
  int hits = 0;                    // the carried entries >= c_half
  for (int j = tid; j < k; j += THREADS) hits += a.init_s[o + j] >= a.c_half[b];
  hits = __reduce_add_sync(FULL, hits);
  if ((tid & 31) == 0) {
    red[tid >> 5] = before;
    redh[tid >> 5] = hits;
  }
  __syncthreads();
  if (tid == 0) {
    int rank = 0;
    hits = 0;
    for (int i = 0; i < WARPS; ++i) {
      rank += red[i];
      hits += redh[i];
    }
    const float s0 = a.init_s[o + k - 1];
    const bool dn = s0 >= a.c_half[b];
    a.pages[b] = 0;
    a.cand[b] = 0;
    a.done[b] = dn;
    w.dnp[b] = dn;
    w.hcnt[b] = hits;
    w.skp[b] = s0;
    w.nseg[b] = mine;
    w.lim[b] = walk_limit(a, b);
    w.sn[rank] = mine;
    w.sq[rank] = b;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&w.hdr[0], 1) == B - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: ecum[j] = (j + 1) sn[j] + sum_{j' > j} sn[j'], the items
  // of the segments below sn[j], by chunks of THREADS ranks from the top
  int carry = 0;
  for (int hi = B; hi > 0; hi -= THREADS) {
    const int lo = max(0, hi - THREADS);
    const int j = lo + tid;
    const int v = j < hi ? __ldcg(&w.sn[j]) : 0;
    buf[tid] = v;
    __syncthreads();
    // inclusive suffix sum over buf (Hillis-Steele)
    for (int off = 1; off < THREADS; off <<= 1) {
      const int add = tid + off < THREADS ? buf[tid + off] : 0;
      __syncthreads();
      buf[tid] += add;
      __syncthreads();
    }
    if (j < hi) w.ecum[j] = (j + 1) * v + (buf[tid] - v) + carry;
    carry += buf[0];
    __syncthreads();
  }
  if (tid == 0) {
    w.sn[B] = 0;
    w.sq[B] = 0;
    w.ecum[B] = 0;
    w.hdr[2] = carry;     // every item: ecum[0]
  }
}

// ---------------------------------------------------------------- walk

struct Item {
  int b, s, t0, tn, rows, nsl, end;
  float s_lb;
};

struct Smem {
  float* stage;            // STAGES x STAGE_FLOATS
  float* ts;               // k
  int* tr;                 // k
  // per item, two of each (the item scored and the next one)
  int* blk[2];             // R: each step's block
  int* skey[2];            // R: each step's max valid score (fkey;
                           // progressive) or its rows >= c_half (scan)
  int* vc[2];              // R: each step's valid rows, -1 if not scored
  int* rowg[2];            // R: each tile row's row of x
  unsigned char* need[2];  // R: the tile's steps, compacted
  unsigned char* rval[2];  // R: each tile row valid
  int* sum;                // 4, scan: the finishing segment's max valid score
                           // (fkey), rows >= c_half and valid rows
};

__device__ __forceinline__ void carve(Smem& m, unsigned char* base, int k) {
  float* f = reinterpret_cast<float*>(base);
  m.stage = f;
  f += STAGES * STAGE_FLOATS;
  int* i = reinterpret_cast<int*>(f);
  for (int p = 0; p < 2; ++p) {
    m.blk[p] = i;
    m.skey[p] = i + R;
    m.vc[p] = i + 2 * R;
    m.rowg[p] = i + 3 * R;
    i += 4 * R;
  }
  unsigned char* c = reinterpret_cast<unsigned char*>(i);
  for (int p = 0; p < 2; ++p) {
    m.need[p] = c;
    m.rval[p] = c + R;
    c += 2 * R;
  }
  m.sum = reinterpret_cast<int*>(c);
  m.ts = reinterpret_cast<float*>(m.sum + 4);
  m.tr = reinterpret_cast<int*>(m.ts + k);
}

// Claim the next item that is not already stopped, and pick and lay out the
// blocks it scores. Called by every thread.
template <bool PROG>
__device__ void prepare(const Args& a, const Work& w, const Smem& m,
                        Item* items, int p, int total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int cnt[WARPS];
  if (tid == 0) {
    Item it{};
    for (;;) {
      const int i = atomicAdd(&w.hdr[1], 1);
      if (i >= total) {
        it.end = 1;
        break;
      }
      // the smallest j >= 1 with ecum[j] <= i: segments [sn[j], sn[j - 1])
      // hold the j longest walks
      int lo = 1, hi = w.nq;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(&w.ecum[mid]) <= i) hi = mid;
        else lo = mid + 1;
      }
      const int off = i - __ldg(&w.ecum[lo]);
      const int b = __ldg(&w.sq[off % lo]);
      if (__ldcg(&w.dnp[b])) continue;        // stopped: read nothing
      it.b = b;
      it.s = __ldg(&w.sn[lo]) + off / lo;
      it.t0 = it.s * w.seg;
      it.tn = min(w.seg, __ldg(&w.lim[b]) - it.t0);
      it.s_lb = __ldcg(&w.skp[b]);
      break;
    }
    items[p] = it;
  }
  __syncthreads();
  const Item it = items[p];
  if (it.end) return;
  const int b = it.b;
  bool need = false;
  if (tid < it.tn) {
    const int t = it.t0 + tid;
    const int blk = __ldg(&a.order[static_cast<int64_t>(b) * a.nb + t]);
    need = true;
    if (PROG) {
      const float g = __ldg(&a.gap[static_cast<int64_t>(b) * a.nb + blk]);
      const float ml = __ldg(&a.blk_l2sq[blk]);
      need = qualify(g, ml, it.s_lb, __ldg(&a.q_l2sq[b]), a.c, a.x_p,
                     a.cs_prune != 0);
      *reinterpret_cast<float2*>(&w.rec[static_cast<int64_t>(b) * w.cap + t]) =
          make_float2(g, ml);
    }
    m.blk[p][tid] = blk;
    m.skey[p][tid] = PROG ? fkey(-CUDART_INF_F) : 0;
    m.vc[p][tid] = need ? 0 : -1;
  }
  const unsigned bal = __ballot_sync(FULL, need);
  if (lane == 0) cnt[warp] = __popc(bal);
  __syncthreads();
  int pos = __popc(bal & ((1u << lane) - 1u)), nneed = 0;
  for (int i = 0; i < WARPS; ++i) {
    if (i < warp) pos += cnt[i];
    nneed += cnt[i];
  }
  if (need) m.need[p][pos] = static_cast<unsigned char>(tid);
  __syncthreads();
  const int rows = nneed * a.pr;
  if (tid < rows) {
    const int i = m.need[p][tid / a.pr];
    const int rg = m.blk[p][i] * a.pr + tid % a.pr;
    m.rowg[p][tid] = rg;
    m.rval[p][tid] = __ldg(&a.ids[rg]) >= 0;
  }
  if (tid == 0) {
    items[p].rows = rows;
    items[p].nsl = rows ? (a.d + DS - 1) / DS : 1;   // 1: an empty task
  }
  __syncthreads();
}

// Issue the copies of slice j of item p into stage `st`, and commit them.
__device__ __forceinline__ void issue(const Args& a, const Smem& m,
                                      const Item& it, int p, int j, int st,
                                      bool vec) {
  const int tid = threadIdx.x;
  float* dst = m.stage + st * STAGE_FLOATS;
  float* qd = dst + R * DS;
  const int d0 = j * DS, wd = min(DS, a.d - d0);
  const float* qs = a.q + static_cast<int64_t>(it.b) * a.d + d0;
  if (it.rows) {
    if (vec) {
      const int nch = wd >> 2;
      for (int id = tid; id < it.rows * 8; id += THREADS) {
        const int r = id >> 3, c = id & 7;
        if (c < nch)
          cp_async16(dst + r * DS + ((c ^ (r & 7)) << 2),
                     a.x + static_cast<int64_t>(m.rowg[p][r]) * a.d + d0 + 4 * c);
      }
      if (tid < nch) cp_async16(qd + 4 * tid, qs + 4 * tid);
    } else {
      for (int id = tid; id < it.rows * DS; id += THREADS) {
        const int r = id >> 5, e = id & 31;
        if (e < wd)
          cp_async4(dst + r * DS + ((((e >> 2) ^ (r & 7)) << 2) | (e & 3)),
                    a.x + static_cast<int64_t>(m.rowg[p][r]) * a.d + d0 + e);
      }
      if (tid < wd) cp_async4(qd + tid, qs + tid);
    }
  }
  cp_async_commit();
}

// Add slice j (staged in `st`) to this thread's row score.
__device__ __forceinline__ float score(const Args& a, const Smem& m,
                                       const Item& it, int j, int st,
                                       float acc) {
  const int tid = threadIdx.x;
  if (tid >= it.rows) return acc;
  const float* row = m.stage + st * STAGE_FLOATS + tid * DS;
  const float* qd = m.stage + st * STAGE_FLOATS + R * DS;
  const int sw = tid & 7, wd = min(DS, a.d - j * DS);
  if (wd == DS) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(row + ((c ^ sw) << 2));
      const float4 u = *reinterpret_cast<const float4*>(qd + 4 * c);
      acc = fmaf(v.x, u.x, acc);
      acc = fmaf(v.y, u.y, acc);
      acc = fmaf(v.z, u.z, acc);
      acc = fmaf(v.w, u.w, acc);
    }
  } else {
    for (int e = 0; e < wd; ++e)
      acc = fmaf(row[(((e >> 2) ^ sw) << 2) | (e & 3)], qd[e], acc);
  }
  return acc;
}

// Exclusive prefix sum of v over the block (every thread calls it); *total
// receives the sum.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int wsum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < WARPS; ++i) {
    if (i < warp) before += wsum[i];
    all += wsum[i];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Progressive mode: replay query b's walk from segment s (held by this
// block) on, window by window. A window starts at the next step to replay
// and runs over the READY segments that follow, at most WIN_STEPS steps, cut where its
// candidate steps (those whose max beats s_k at the window's start; s_k only
// grows, so no other step can beat it later) pass WIN_ROWS rows. The block
// stages the window in the free stage of the ring (`spare`): the step
// records, then the row scores and order entries of the candidates. Warp 0
// walks it 32 steps at a time: while s_k holds, one ballot finds the first
// live step whose max beats s_k, the live steps up to it are counted, and
// its rows are merged in row order. The walk ends when it stops or runs out
// (the outputs written), or when the next segment is not scored yet (the
// state written back and the chain handed to that segment's scorer).
// Called by every thread.
__device__ void replay(const Args& a, const Work& w, const Smem& m, int b,
                       int s, float* spare) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = a.k, pr = a.pr, S = w.seg;
  const int nwin = min(32, max(1, WIN_STEPS / S));     // segments to look at
  float4* wrec = reinterpret_cast<float4*>(spare);                // WIN_STEPS
  int* woff = reinterpret_cast<int*>(spare + 4 * WIN_STEPS);      // WIN_STEPS
  int* word = woff + WIN_STEPS;                                   // WIN_STEPS
  float* wsc = spare + 6 * WIN_STEPS;                             // WIN_ROWS
  __shared__ int sh_n, sh_flag, sh_done, sh_cut;
  __shared__ float sh_sk;
  const int64_t o = static_cast<int64_t>(b) * k;
  for (int j = tid; j < k; j += THREADS) {
    m.ts[j] = __ldcg(&a.top_s[o + j]);
    m.tr[j] = __ldcg(&a.top_r[o + j]);
  }
  // warp 0's tally (every lane holds it)
  int pages = __ldcg(&a.pages[b]), cand = __ldcg(&a.cand[b]);
  const int lim = __ldg(&w.lim[b]), nseg = __ldg(&w.nseg[b]);
  const float c_half = __ldg(&a.c_half[b]);
  const float ql = __ldg(&a.q_l2sq[b]);
  const bool cs = a.cs_prune != 0;
  const int* flag = w.flag + static_cast<int64_t>(b) * w.nseg_cap;
  const float4* rec = w.rec + static_cast<int64_t>(b) * w.cap;
  const float* sc = w.sc + static_cast<int64_t>(b) * w.cap * pr;
  const int* order = a.order + static_cast<int64_t>(b) * a.nb;
  __syncthreads();
  float s_k = m.ts[k - 1];
  bool done = false;
  int t = s * S;                           // the next step to replay
  for (;;) {
    // the run of READY segments from t's on (t's is READY when the block
    // holds it, or when t is inside a segment; none hands the chain over)
    s = t / S;
    if (warp == 0) {
      const int sg = s + lane;
      const bool ok = lane < nwin && sg < nseg && ld_flag(&flag[sg]) == READY;
      const unsigned run = ~__ballot_sync(FULL, ok);    // first not READY
      if (lane == 0) {
        sh_n = run ? __ffs(run) - 1 : 32;
        sh_cut = WIN_STEPS;
      }
    }
    __syncthreads();
    if (sh_n == 0) {
      // write the state back for the next holder and hand the chain over
      for (int j = tid; j < k; j += THREADS) {
        a.top_s[o + j] = m.ts[j];
        a.top_r[o + j] = m.tr[j];
      }
      if (tid == 0) {
        a.pages[b] = pages;
        a.cand[b] = cand;
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) sh_flag = atomicCAS(const_cast<int*>(&flag[s]), EMPTY, WANT);
      __syncthreads();
      if (sh_flag != READY) return;       // its scorer takes the chain over
      continue;
    }
    __threadfence();
    int nst = min(min((s + sh_n) * S, lim) - t, WIN_STEPS);
    for (int j = tid; j < nst; j += THREADS) wrec[j] = __ldcg(&rec[t + j]);
    __syncthreads();
    // the candidates, laid out in row order; the window cut where they
    // would pass WIN_ROWS rows
    constexpr int PER = WIN_STEPS / THREADS;
    bool is_c[PER];
    int mine = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = tid * PER + q;
      const float4 r = j < nst ? wrec[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      is_c[q] = j < nst && __float_as_int(r.w) >= 0 && r.z > s_k;
      mine += is_c[q];
    }
    int total = 0;
    int off = block_scan(mine, &total) * pr;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = tid * PER + q;
      if (j < nst) {
        woff[j] = is_c[q] ? off : -1;
        if (is_c[q] && off + pr > WIN_ROWS) atomicMin(&sh_cut, j);
        off += is_c[q] ? pr : 0;
      }
    }
    __syncthreads();
    nst = min(nst, sh_cut);
    for (int j = tid; j < nst; j += THREADS) {
      const int wo = woff[j];
      if (wo >= 0) {
        word[j] = __ldg(&order[t + j]);
        const float* src = sc + static_cast<int64_t>(t + j) * pr;
        for (int rr = 0; rr < pr; ++rr) wsc[wo + rr] = __ldcg(&src[rr]);
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int c0 = 0; c0 < nst && !done; c0 += 32) {
        const int i = c0 + lane;
        const float4 r = i < nst ? wrec[i]
                                 : make_float4(0.f, 0.f, -CUDART_INF_F,
                                               __int_as_float(-1));
        const int vc = __float_as_int(r.w);
        bool pend = i < nst && vc >= 0;
        for (;;) {
          const bool live = pend && qualify(r.x, r.y, s_k, ql, a.c, a.x_p,
                                            cs);
          const unsigned bt = __ballot_sync(FULL, live && r.z > s_k);
          const int f = bt ? __ffs(bt) - 1 : 32;
          const bool in = live && lane <= f;
          pages += __popc(__ballot_sync(FULL, in));
          cand += __reduce_add_sync(FULL, in ? vc : 0);
          if (!bt) break;
          // merge step t + c0 + f: its rows in order
          const int blk = word[c0 + f];
          const float* srow = wsc + woff[c0 + f];
          merge_rows(m.ts, m.tr, k, pr, lane,
                     [&](int rr) { return srow[rr]; },
                     [&](int rr) { return blk * pr + rr; });
          s_k = m.ts[k - 1];
          pend = pend && lane > f;
          if (s_k >= c_half) {
            done = true;
            break;
          }
        }
      }
      if (lane == 0) {
        sh_sk = s_k;
        sh_done = done;
      }
    }
    __syncthreads();
    s_k = sh_sk;
    done = sh_done != 0;
    t += nst;
    if (tid == 0) *reinterpret_cast<volatile float*>(&w.skp[b]) = s_k;
    if (done || t >= lim) {             // the walk's end: the outputs
      for (int j = tid; j < k; j += THREADS) {
        a.top_s[o + j] = m.ts[j];
        a.top_r[o + j] = m.tr[j];
      }
      if (tid == 0) {
        a.pages[b] = pages;
        a.cand[b] = cand;
        a.done[b] = done;
        if (done) *reinterpret_cast<volatile int*>(&w.dnp[b]) = 1;
      }
      return;
    }
  }
}

// Scan mode: carry query b's chain from segment s (held by this block) on,
// window by window, finding the stop by counting. A window is the run of
// READY segments from the next one, at most 32, one a lane of warp 0: an
// inclusive prefix sum of the segments' rows >= c_half, added to the count
// so far (the carried entries >= c_half and the rows walked), finds the
// first segment at which it reaches k, and the stop is published at once.
// The candidates are the segments before it whose max beats the k-th score
// s_k at the window's start (s_k only grows, so no other can beat it later)
// and the stop segment; the window is cut before the candidate that would
// pass what the free ring stage (`spare`) holds. The block stages the
// candidates' row scores and blocks there, and warp 0 merges them in walk
// order, each segment whose max still beats s_k row by row; in the stop
// segment a prefix sum of its steps' counts finds the stop step, the step
// at which the top-k's k-th score reaches c_half, and the rows up to it are
// merged. The same hand-over as `replay` when the next segment is not
// READY. Called by every thread.
__device__ void count_walk(const Args& a, const Work& w, const Smem& m, int b,
                           int s, float* spare) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = a.k, pr = a.pr, S = w.seg;
  const int cap = STAGE_FLOATS / (R + S);       // candidates a window stages
  float* wsc = spare;                                      // cap x R scores
  int* wblk = reinterpret_cast<int*>(spare + cap * R);     // cap x S blocks
  __shared__ int sh_n, sh_nc, sh_flag, sh_done;
  __shared__ int sh_cand[32];      // the candidates' places in the window
  const int64_t o = static_cast<int64_t>(b) * k;
  for (int j = tid; j < k; j += THREADS) {
    m.ts[j] = __ldcg(&a.top_s[o + j]);
    m.tr[j] = __ldcg(&a.top_r[o + j]);
  }
  // warp 0's tally (every lane holds it)
  int pages = __ldcg(&a.pages[b]), cand = __ldcg(&a.cand[b]);
  int cnt = __ldcg(&w.hcnt[b]);
  const int lim = __ldg(&w.lim[b]), nseg = __ldg(&w.nseg[b]);
  int* flag = w.flag + static_cast<int64_t>(b) * w.nseg_cap;
  const int4* segs = w.segs + static_cast<int64_t>(b) * w.nseg_cap;
  const float4* rec = w.rec + static_cast<int64_t>(b) * w.cap;
  const float* sc = w.sc + static_cast<int64_t>(b) * w.cap * pr;
  const int* order = a.order + static_cast<int64_t>(b) * a.nb;
  __syncthreads();
  for (;;) {
    int4 r = make_int4(0, 0, 0, 0);
    int incl = 0, fs = 0, n = 0;
    bool reach = false;
    if (warp == 0) {
      const int g = s + lane;
      const bool ok = g < nseg && ld_flag(&flag[g]) == READY;
      const unsigned run = ~__ballot_sync(FULL, ok);    // first not READY
      n = run ? __ffs(run) - 1 : 32;
      if (n) {
        __threadfence();
        if (lane < n) r = __ldcg(&segs[g]);
        incl = r.y;
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += y;
        }
        const unsigned hit = __ballot_sync(FULL, lane < n && cnt + incl >= k);
        reach = hit != 0;
        fs = reach ? __ffs(hit) - 1 : n;
        const float s_k = m.ts[k - 1];
        unsigned cb = __ballot_sync(
            FULL, (lane < fs && __int_as_float(r.x) > s_k) || (reach && lane == fs));
        if (__popc(cb) > cap) {     // cut before the candidate past the stage
          unsigned c = cb;
          for (int i = 0; i < cap; ++i) c &= c - 1;
          n = __ffs(c) - 1;
          cb &= (1u << n) - 1u;
          if (fs >= n) {
            reach = false;
            fs = n;
          }
        }
        if (reach && lane == 0)     // the later items read nothing from now
          *reinterpret_cast<volatile int*>(&w.dnp[b]) = 1;
        if (cb >> lane & 1u) sh_cand[__popc(cb & ((1u << lane) - 1u))] = lane;
        if (lane == 0) sh_nc = __popc(cb);
      }
      if (lane == 0) sh_n = n;
    }
    __syncthreads();
    if (sh_n == 0) {
      // write the state back for the next holder and hand the chain over
      for (int j = tid; j < k; j += THREADS) {
        a.top_s[o + j] = m.ts[j];
        a.top_r[o + j] = m.tr[j];
      }
      if (tid == 0) {
        a.pages[b] = pages;
        a.cand[b] = cand;
        w.hcnt[b] = cnt;
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) sh_flag = atomicCAS(&flag[s], EMPTY, WANT);
      __syncthreads();
      if (sh_flag != READY) return;       // its scorer takes the chain over
      continue;
    }
    // stage the candidates' row scores and blocks
    const int nc = sh_nc;
    for (int id = tid; id < nc * R; id += THREADS) {
      const int j = id / R, rr = id % R, t0 = (s + sh_cand[j]) * S;
      if (rr < min(S, lim - t0) * pr)
        wsc[id] = __ldcg(&sc[static_cast<int64_t>(t0) * pr + rr]);
    }
    for (int id = tid; id < nc * S; id += THREADS) {
      const int j = id / S, i = id % S, t0 = (s + sh_cand[j]) * S;
      if (i < min(S, lim - t0)) wblk[id] = __ldg(&order[t0 + i]);
    }
    __syncthreads();
    if (warp == 0) {
      const int g = s + lane;
      pages += __reduce_add_sync(FULL, lane < fs ? min(S, lim - g * S) : 0);
      cand += __reduce_add_sync(FULL, lane < fs ? r.z : 0);
      const float smax = __int_as_float(r.x);
      for (int j = 0; j < nc; ++j) {
        const int sj = sh_cand[j], t0 = (s + sj) * S, tn = min(S, lim - t0);
        int nrows = tn * pr;
        if (reach && sj == fs) {
          // the stop segment: its steps up to the one where the count
          // reaches k
          int before = cnt + __shfl_sync(FULL, incl - r.y, fs), stop = -1;
          for (int c0 = 0; c0 < tn && stop < 0; c0 += 32) {
            const int i = c0 + lane;
            const float4 e = i < tn ? __ldcg(&rec[t0 + i])
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
            int inc = __float_as_int(e.x);
            for (int off = 1; off < 32; off <<= 1) {
              const int y = __shfl_up_sync(FULL, inc, off);
              if (lane >= off) inc += y;
            }
            const unsigned hit = __ballot_sync(FULL, i < tn && before + inc >= k);
            const int f = hit ? __ffs(hit) - 1 : 32;
            cand += __reduce_add_sync(FULL, i < tn && lane <= f
                                                ? __float_as_int(e.w) : 0);
            if (hit) stop = c0 + f;
            before += __shfl_sync(FULL, inc, 31);
          }
          pages += stop + 1;
          nrows = (stop + 1) * pr;
        } else if (!(__shfl_sync(FULL, smax, sj) > m.ts[k - 1])) {
          continue;
        }
        const float* rs = wsc + j * R;
        const int* rb = wblk + j * S;
        merge_rows(m.ts, m.tr, k, nrows, lane, [&](int rr) { return rs[rr]; },
                   [&](int rr) { return rb[rr / pr] * pr + rr % pr; });
      }
      if (!reach) cnt += __shfl_sync(FULL, incl, n - 1);
      if (lane == 0) sh_done = reach;
    }
    __syncthreads();
    s += sh_n;
    if (sh_done || s >= nseg) {          // the walk's end: the outputs
      for (int j = tid; j < k; j += THREADS) {
        a.top_s[o + j] = m.ts[j];
        a.top_r[o + j] = m.tr[j];
      }
      if (tid == 0) {
        a.pages[b] = pages;
        a.cand[b] = cand;
        a.done[b] = sh_done != 0;
      }
      return;
    }
  }
}

__device__ __forceinline__ void reset_sum(const Smem& m) {
  m.sum[0] = fkey(-CUDART_INF_F);
  m.sum[1] = 0;
  m.sum[2] = 0;
}

// Write item p's row scores, step records and (scan) segment summary, mark
// its segment READY and, if the chain waits for it (or it is segment 0),
// carry the chain on in `spare`, the stage just scored (the next task's
// copies go to the other one): progressive mode replays, scan mode counts.
template <bool PROG>
__device__ void finish(const Args& a, const Work& w, const Smem& m,
                       const Item& it, int p, float acc, float* spare) {
  const int tid = threadIdx.x, pr = a.pr;
  __shared__ int sh_old;
  const int64_t base = static_cast<int64_t>(it.b) * w.cap + it.t0;
  const float c_half = PROG ? 0.f : __ldg(&a.c_half[it.b]);
  const bool v = tid < it.rows && m.rval[p][tid];
  if (tid < it.rows) {
    const int i = m.need[p][tid / pr];
    w.sc[(base + i) * pr + tid % pr] = v ? acc : -CUDART_INF_F;
    if (v) {
      if (PROG) atomicMax(&m.skey[p][i], fkey(acc));
      else if (acc >= c_half) atomicAdd(&m.skey[p][i], 1);
      atomicAdd(&m.vc[p][i], 1);
    }
  }
  if constexpr (!PROG) {      // the segment's summary
    const int mx = __reduce_max_sync(FULL, v ? fkey(acc) : fkey(-CUDART_INF_F));
    const int hits = __reduce_add_sync(FULL, v && acc >= c_half);
    const int nv = __reduce_add_sync(FULL, v);
    if ((tid & 31) == 0) {
      atomicMax(&m.sum[0], mx);
      atomicAdd(&m.sum[1], hits);
      atomicAdd(&m.sum[2], nv);
    }
  }
  __syncthreads();
  if (tid < it.tn) {
    const int vc = m.vc[p][tid];
    if constexpr (PROG)
      *reinterpret_cast<float2*>(&w.rec[base + tid].z) = make_float2(
          vc >= 0 ? fkey_inv(m.skey[p][tid]) : -CUDART_INF_F,
          __int_as_float(vc));
    else
      w.rec[base + tid] = make_float4(__int_as_float(m.skey[p][tid]), 0.f,
                                      0.f, __int_as_float(vc));
  }
  if (!PROG && tid == 0) {
    w.segs[static_cast<int64_t>(it.b) * w.nseg_cap + it.s] = make_int4(
        __float_as_int(fkey_inv(m.sum[0])), m.sum[1], m.sum[2], 0);
    reset_sum(m);       // for the next item; read by no one before that
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int old = atomicExch(&w.flag[static_cast<int64_t>(it.b) * w.nseg_cap
                                       + it.s], READY);
    sh_old = it.s == 0 || old == WANT;
  }
  __syncthreads();
  if (sh_old) {
    __threadfence();     // the chain's state, written back before its WANT
    if constexpr (PROG) replay(a, w, m, it.b, it.s, spare);
    else count_walk(a, w, m, it.b, it.s, spare);
  }
}

// One instantiation a mode, so that neither carries the other's chain.
template <bool PROG>
__global__ void __launch_bounds__(THREADS, 3)
scan_walk_kernel(const Args a, const Work w, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Item items[2];
  __shared__ int s_total;
  Smem m;
  carve(m, smem, a.k);
  if (threadIdx.x == 0) {
    s_total = __ldcg(&w.hdr[2]);
    reset_sum(m);
  }
  __syncthreads();
  const int total = s_total;
  prepare<PROG>(a, w, m, items, 0, total);
  if (items[0].end) return;
  issue(a, m, items[0], 0, 0, 0, vec != 0);
  int p = 0, j = 0, st = 0;
  float acc = 0.f;
  for (;;) {
    if (j == 0) {
      acc = 0.f;
      prepare<PROG>(a, w, m, items, p ^ 1, total);   // the next item
    }
    const Item it = items[p];
    const bool last = j + 1 >= it.nsl;
    const int np = last ? p ^ 1 : p, nj = last ? 0 : j + 1;
    const bool more = !(last && items[p ^ 1].end);
    if (more) issue(a, m, items[np], np, nj, st ^ 1, vec != 0);
    else cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    acc = score(a, m, it, j, st, acc);
    __syncthreads();
    if (last) finish<PROG>(a, w, m, it, p, acc, m.stage + st * STAGE_FLOATS);
    if (!more) break;
    p = np;
    j = nj;
    st ^= 1;
  }
}

// The scratch layout for B queries over NB blocks: section offsets in ints.
struct Layout {
  long long hdr, flag, nseg, lim, sn, sq, ecum, skp, dnp, hcnt, segs, rec, sc,
      end;
  int nseg_cap, cap, seg;
};

Layout layout(int b, int nb, int pr, int budget) {
  Layout l{};
  l.seg = R / pr;
  const int steps = max(0, min(budget, nb));
  l.nseg_cap = (steps + l.seg - 1) / l.seg;
  l.cap = l.nseg_cap * l.seg;
  auto up = [](long long v) { return (v + 3) & ~3LL; };   // 16-byte sections
  long long o = 0;
  l.hdr = o;  o = up(o + 4);
  l.flag = o; o = up(o + static_cast<long long>(b) * l.nseg_cap);
  l.nseg = o; o = up(o + b);
  l.lim = o;  o = up(o + b);
  l.sn = o;   o = up(o + b + 1);
  l.sq = o;   o = up(o + b + 1);
  l.ecum = o; o = up(o + b + 1);
  l.skp = o;  o = up(o + b);
  l.dnp = o;  o = up(o + b);
  l.hcnt = o; o = up(o + b);
  l.segs = o; o = up(o + 4LL * b * l.nseg_cap);
  l.rec = o;  o = up(o + 4LL * b * l.cap);
  l.sc = o;   o = up(o + static_cast<long long>(b) * l.cap * pr);
  l.end = o;
  return l;
}

long long smem_bytes(int k) {
  return 4LL * STAGES * STAGE_FLOATS + 2LL * (4 * R * 4 + 2 * R) + 16 +
         8LL * k;
}

}  // namespace

// Dynamic shared memory of one walk block for depth d and k.
extern "C" long long scan_blocks_smem_bytes(int d, int k) {
  (void)d;
  return smem_bytes(k);
}

// The most dynamic shared memory a walk block may have: the opt-in limit
// less the kernel's static shared memory; 0 if the runtime cannot say.
extern "C" int scan_blocks_max_smem() {
  cudaFuncAttributes scan, prog;
  if (cudaFuncGetAttributes(&scan, scan_walk_kernel<false>) != cudaSuccess ||
      cudaFuncGetAttributes(&prog, scan_walk_kernel<true>) != cudaSuccess)
    return 0;
  return SMEM_MAX - static_cast<int>(
                        std::max(scan.sharedSizeBytes, prog.sharedSizeBytes));
}

// Bytes of scratch the launcher needs for B queries over NB blocks.
extern "C" long long scan_blocks_scratch_bytes(int b, int nb, int pr,
                                               int budget) {
  if (b < 1 || nb < 1 || pr < 1 || pr > R) return -1;
  return 4 * layout(b, nb, pr, budget).end;
}

extern "C" int scan_blocks_launch(
    const float* x, const int* ids, const float* q, const int* order,
    const int* n_sel, const float* gap, const float* blk_l2sq,
    const float* q_l2sq, const float* init_s, const int* init_r,
    const float* c_half, float* top_s, int* top_r, int* pages, int* cand,
    bool* done, int b, int d, int nb, int k, int pr, int budget,
    int progressive, int cs_prune, float c, float x_p, void* scratch,
    long long scratch_bytes, cudaStream_t stream) {
  if (b < 1 || d < 1 || nb < 1 || k < 1 || pr < 1 || pr > R || budget < 0)
    return cudaErrorInvalidValue;
  const long long smem = smem_bytes(k);
  if (smem > scan_blocks_max_smem()) return cudaErrorInvalidValue;
  const Layout l = layout(b, nb, pr, budget);
  if (scratch == nullptr || scratch_bytes < 4 * l.end ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return cudaErrorInvalidValue;
  static LaunchCache scan_cache, prog_cache;
  int resident = 0;
  cudaError_t err =
      progressive ? resident_blocks(prog_cache, scan_walk_kernel<true>, THREADS,
                                    static_cast<int>(smem), &resident)
                  : resident_blocks(scan_cache, scan_walk_kernel<false>,
                                    THREADS, static_cast<int>(smem), &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  int* base = static_cast<int*>(scratch);
  Work w{};
  w.hdr = base + l.hdr;
  w.flag = base + l.flag;
  w.nseg = base + l.nseg;
  w.lim = base + l.lim;
  w.sn = base + l.sn;
  w.sq = base + l.sq;
  w.ecum = base + l.ecum;
  w.skp = reinterpret_cast<float*>(base + l.skp);
  w.dnp = base + l.dnp;
  w.hcnt = base + l.hcnt;
  w.segs = reinterpret_cast<int4*>(base + l.segs);
  w.rec = reinterpret_cast<float4*>(base + l.rec);
  w.sc = reinterpret_cast<float*>(base + l.sc);
  w.nq = b;
  w.nseg_cap = l.nseg_cap;
  w.cap = l.cap;
  w.seg = l.seg;
  Args a{x,     ids,   q,     order, n_sel, gap,  blk_l2sq, q_l2sq,
         init_s, init_r, c_half, top_s, top_r, pages, cand, done,
         d,     nb,    k,     pr,    budget, progressive, cs_prune, c, x_p};
  err = cudaMemsetAsync(scratch, 0, 4 * l.nseg, stream);   // hdr and flags
  if (err != cudaSuccess) return err;
  scan_setup_kernel<<<b, THREADS, 0, stream>>>(a, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (progressive)
    scan_walk_kernel<true><<<resident, THREADS, static_cast<int>(smem),
                             stream>>>(a, w, vec ? 1 : 0);
  else
    scan_walk_kernel<false><<<resident, THREADS, static_cast<int>(smem),
                              stream>>>(a, w, vec ? 1 : 0);
  return cudaGetLastError();
}
