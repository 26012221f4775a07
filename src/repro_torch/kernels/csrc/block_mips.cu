// One fused ProMIPS verification round on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_mips.py::block_mips (Pallas body
// `_kernel`, streaming top-k `_rank_topk`). The TPU grid walks the slot list
// in order and carries the per-query hit count from page to page. Hopper
// runs blocks in no order, so the contract is split the way
// src/repro/kernels/ref.py::_verify_core already splits it, into four
// launches on one stream:
//   1. count  (grid: slot chunks x query tiles) scores each selected page
//             against the query tile and writes cnt[b, slot], the valid rows
//             scoring >= c_half[b], times sel (past the stop too, as on TPU);
//   2. scan   (one block per query) exclusive scan of cnt over the slots from
//             n0 = #(init >= c_half): live = sel & (n0 + prefix < k), and the
//             pages / candidates of the live slots;
//   3. top-k  (grid as in 1) re-scores the chunks that hold a live slot and
//             keeps each (chunk, query) top-min(k, rows) in rank order;
//   4. merge  (one block per query) merges the chunk partials after the
//             carried entries under the key (score desc, position asc), where
//             carried entries take positions 0..k-1 and tile row t takes k + t
//             (slots ascend, so that is ascending row order) -- the
//             `lax.top_k` tie rule of the TPU kernel. For k <= KMAX the pool
//             is rank-selected in shared memory; above it (the streaming
//             index's over-fetch) the merge runs in device memory: a radix
//             select on a 64-bit key that encodes the same order finds the
//             k-th entry, the entries at or above it are compacted, and a
//             bitonic network sorts them.
// The (B, R) score matrix never exists in device memory: pages are scored
// twice (passes 1 and 3) instead.
//
// What bounds it: every (query, selected page) pair is scored in fp32 FMA
// (2 * page_rows * d operations) and every page any query selects is read
// once. At the main path's batch (B = 64, d = 128, 4-KB pages) a page holds
// 32 operations per byte read, above the card's 67 TFLOP/s : 3.35 TB/s = 20,
// so a dense round is bound by fp32 operations, a sparse one by its page
// gathers. What the design does about it: each block stages one 64-row tile
// of pages and 64 queries in shared memory in 32-wide depth slices, and
// every thread keeps a 4 x 4 (row, query) tile of sums in registers, so a
// page is read from device memory once per pass for all 64 queries, and a
// chunk that no query selects (pass 1) or where no slot is live (pass 3) is
// skipped after reading its flags. Tensor cores, TMA and a one-pass design
// are left for later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;             // queries per block tile
constexpr int RT = 64;             // rows per block tile: spc * page_rows <= RT
constexpr int DK = 32;             // depth slice staged in shared memory
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 register tiles
constexpr int SCAN_THREADS = 1024;
constexpr int MERGE_THREADS = 256;
constexpr int LARGE_THREADS = 1024;
constexpr int QCAP = 2048;         // merge queue entries per round
constexpr int KMAX = 1024;         // largest k the shared-memory merge holds
constexpr unsigned FULL = 0xffffffffu;

// Per-thread 4 x 4 tile of <x[row], q[query]> over rows tr + 16 i and
// queries qt0 + tq + 16 j, summed over depth in order 0..d-1 with fmaf.
// rowid_s[rr] is the global row of tile row rr, or -1.
__device__ __forceinline__ void score_tile(
    const float* __restrict__ x, const float* __restrict__ q,
    const int* rowid_s, int qt0, int B, int d,
    float (*xs)[DK + 1], float (*qs)[DK + 1], float acc[4][4]) {
  const int tid = threadIdx.x, tq = tid & 15, tr = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += DK) {
    __syncthreads();  // the previous slice is consumed
    for (int idx = tid; idx < RT * DK; idx += THREADS) {
      const int rr = idx / DK, c = idx % DK;
      const int row = rowid_s[rr];
      const bool in_d = d0 + c < d;
      xs[rr][c] = (row >= 0 && in_d) ? x[(size_t)row * d + d0 + c] : 0.f;
      const int b = qt0 + rr;  // QT == RT: the same loop stages the queries
      qs[rr][c] = (b < B && in_d) ? q[(size_t)b * d + d0 + c] : 0.f;
    }
    __syncthreads();
    const int cmax = min(DK, d - d0);
#pragma unroll 8
    for (int c = 0; c < cmax; ++c) {
      float xv[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[tr + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = qs[tq + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], qv[j], acc[i][j]);
    }
  }
}

// Rows of one chunk of slots: rowid_s / rvalid_s for the RT tile rows.
__device__ __forceinline__ void chunk_rows(
    const int* __restrict__ slots, const uint8_t* __restrict__ valid,
    int s0, int rows, int page_rows, int* rowid_s, uint8_t* rvalid_s) {
  const int tid = threadIdx.x;
  if (tid < RT) {
    int row = -1;
    if (tid < rows) row = slots[s0 + tid / page_rows] * page_rows + tid % page_rows;
    rowid_s[tid] = row;
    rvalid_s[tid] = row >= 0 ? valid[row] : 0;
  }
}

__global__ void __launch_bounds__(THREADS) bm_count_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ valid,
    const float* __restrict__ q, const int* __restrict__ slots,
    const uint8_t* __restrict__ sel, const float* __restrict__ c_half,
    int* __restrict__ cnt, int B, int d, int NS, int page_rows, int spc) {
  __shared__ float xs[RT][DK + 1];
  __shared__ float qs[QT][DK + 1];
  __shared__ int rowid_s[RT];
  __shared__ uint8_t rvalid_s[RT];
  __shared__ uint8_t sel_s[QT][RT];
  __shared__ int cnt_s[QT][RT];
  __shared__ float ch_s[QT];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * spc, ns = min(spc, NS - s0), rows = ns * page_rows;
  const int qt0 = blockIdx.y * QT;

  int any = 0;
  for (int idx = tid; idx < QT * spc; idx += THREADS) {
    const int qq = idx / spc, s = idx % spc;
    const uint8_t v = (s < ns && qt0 + qq < B) ? sel[(size_t)(qt0 + qq) * NS + s0 + s] : 0;
    sel_s[qq][s] = v;
    cnt_s[qq][s] = 0;
    any |= v;
  }
  chunk_rows(slots, valid, s0, rows, page_rows, rowid_s, rvalid_s);
  if (tid < QT) ch_s[tid] = qt0 + tid < B ? c_half[qt0 + tid] : 0.f;
  if (__syncthreads_or(any)) {
    float acc[4][4];
    score_tile(x, q, rowid_s, qt0, B, d, xs, qs, acc);
    const int tq = tid & 15, tr = tid >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = tr + 16 * i;
      if (rr >= rows || !rvalid_s[rr]) continue;
      const int sl = rr / page_rows;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qq = tq + 16 * j;
        if (qt0 + qq < B && sel_s[qq][sl] && acc[i][j] >= ch_s[qq])
          atomicAdd(&cnt_s[qq][sl], 1);
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < QT * spc; idx += THREADS) {
    const int qq = idx / spc, s = idx % spc;
    if (s < ns && qt0 + qq < B) cnt[(size_t)(qt0 + qq) * NS + s0 + s] = cnt_s[qq][s];
  }
}

__global__ void __launch_bounds__(SCAN_THREADS) bm_scan_kernel(
    const int* __restrict__ cnt, const uint8_t* __restrict__ sel,
    const uint8_t* __restrict__ valid, const int* __restrict__ slots,
    const float* __restrict__ init_s, const float* __restrict__ c_half,
    uint8_t* __restrict__ live, int* __restrict__ pages, int* __restrict__ cand,
    int NS, int k, int page_rows) {
  __shared__ int warp_sum[32];
  __shared__ int red_p[32], red_c[32];
  __shared__ int n0_s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) n0_s = 0;
  __syncthreads();
  {
    const float ch = c_half[b];
    int n0 = 0;
    for (int i = tid; i < k; i += SCAN_THREADS) n0 += init_s[(size_t)b * k + i] >= ch;
    if (n0) atomicAdd(&n0_s, n0);
  }
  __syncthreads();
  int carry = min(n0_s, k);  // saturates at k: only "carry + prefix < k" matters
  int my_pages = 0, my_cand = 0;
  for (int base = 0; base < NS; base += SCAN_THREADS) {
    const int s = base + tid;
    const size_t at = (size_t)b * NS + s;
    const int c = s < NS ? cnt[at] : 0;
    int v = c;  // inclusive scan within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w += t;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int excl = v - c + (warp > 0 ? warp_sum[warp - 1] : 0);
    if (s < NS) {
      const uint8_t lv = sel[at] && (carry + excl < k);
      live[at] = lv;
      if (lv) {
        const size_t row0 = (size_t)slots[s] * page_rows;
        int vc = 0;
        for (int r = 0; r < page_rows; ++r) vc += valid[row0 + r];
        my_pages += 1;
        my_cand += vc;
      }
    }
    carry = min(carry + warp_sum[31], k);
    __syncthreads();  // warp_sum is rewritten by the next tile
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    my_pages += __shfl_down_sync(FULL, my_pages, off);
    my_cand += __shfl_down_sync(FULL, my_cand, off);
  }
  if (lane == 0) {
    red_p[warp] = my_pages;
    red_c[warp] = my_cand;
  }
  __syncthreads();
  if (warp == 0) {
    int p = red_p[lane], c = red_c[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p += __shfl_down_sync(FULL, p, off);
      c += __shfl_down_sync(FULL, c, off);
    }
    if (lane == 0) {
      pages[b] = p;
      cand[b] = c;
    }
  }
}

__global__ void __launch_bounds__(THREADS) bm_topk_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ valid,
    const float* __restrict__ q, const int* __restrict__ slots,
    const uint8_t* __restrict__ live, float* __restrict__ part_s,
    int* __restrict__ part_p, int* __restrict__ part_n,
    int B, int d, int NS, int page_rows, int spc, int kc, int NC) {
  __shared__ float xs[RT][DK + 1];
  __shared__ float qs[QT][DK + 1];
  __shared__ int rowid_s[RT];
  __shared__ uint8_t rvalid_s[RT];
  __shared__ uint8_t live_s[QT][RT];
  __shared__ float S[QT][RT + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int s0 = chunk * spc, ns = min(spc, NS - s0), rows = ns * page_rows;
  const int qt0 = blockIdx.y * QT;

  int any = 0;
  for (int idx = tid; idx < QT * spc; idx += THREADS) {
    const int qq = idx / spc, s = idx % spc;
    const uint8_t v = (s < ns && qt0 + qq < B) ? live[(size_t)(qt0 + qq) * NS + s0 + s] : 0;
    live_s[qq][s] = v;
    any |= v;
  }
  chunk_rows(slots, valid, s0, rows, page_rows, rowid_s, rvalid_s);
  if (!__syncthreads_or(any)) {
    if (tid < QT && qt0 + tid < B) part_n[(size_t)(qt0 + tid) * NC + chunk] = 0;
    return;
  }
  float acc[4][4];
  score_tile(x, q, rowid_s, qt0, B, d, xs, qs, acc);
  const int tq = tid & 15, tr = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = tr + 16 * i;
    const bool row_ok = rr < rows && rvalid_s[rr];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = tq + 16 * j;
      S[qq][rr] = (row_ok && live_s[qq][rr / page_rows]) ? acc[i][j] : -CUDART_INF_F;
    }
  }
  __syncthreads();
  // one warp per query: rank each of the RT entries by (score desc, index
  // asc) and keep the finite ones of rank < kc, in rank order
  for (int qq = warp; qq < QT && qt0 + qq < B; qq += THREADS / 32) {
    const float v0 = S[qq][lane], v1 = S[qq][lane + 32];
    const int nf = __popc(__ballot_sync(FULL, v0 > -CUDART_INF_F)) +
                   __popc(__ballot_sync(FULL, v1 > -CUDART_INF_F));
    const int keep = min(kc, nf);
    int r0 = 0, r1 = 0;
    for (int e = 0; e < RT; ++e) {
      const float w = S[qq][e];
      r0 += (w > v0) || (w == v0 && e < lane);
      r1 += (w > v1) || (w == v1 && e < lane + 32);
    }
    const size_t base = ((size_t)(qt0 + qq) * NC + chunk) * kc;
    const int pos0 = s0 * page_rows;  // tile position of this chunk's first row
    if (v0 > -CUDART_INF_F && r0 < keep) {
      part_s[base + r0] = v0;
      part_p[base + r0] = pos0 + lane;
    }
    if (v1 > -CUDART_INF_F && r1 < keep) {
      part_s[base + r1] = v1;
      part_p[base + r1] = pos0 + lane + 32;
    }
    if (lane == 0) part_n[(size_t)(qt0 + qq) * NC + chunk] = keep;
  }
}

__device__ __forceinline__ bool better(float s1, int p1, float s2, int p2) {
  return s1 > s2 || (s1 == s2 && p1 < p2);
}

// Rank-select the n entries of the pool into out[0..k) in key order.
__device__ void pool_select(const float* ps, const int* pp, int n, int k,
                            float* out_s, int* out_p) {
  for (int e = threadIdx.x; e < n; e += MERGE_THREADS) {
    const float se = ps[e];
    const int pe = pp[e];
    int rank = 0;
    for (int e2 = 0; e2 < n; ++e2) rank += better(ps[e2], pp[e2], se, pe);
    if (rank < k) {
      out_s[rank] = se;
      out_p[rank] = pe;
    }
  }
}

__global__ void __launch_bounds__(MERGE_THREADS) bm_merge_kernel(
    const float* __restrict__ init_s, const int* __restrict__ init_r,
    const int* __restrict__ slots, const float* __restrict__ part_s,
    const int* __restrict__ part_p, const int* __restrict__ part_n,
    float* __restrict__ top_s, int* __restrict__ top_r,
    int k, int kc, int NC, int page_rows) {
  // pool[0..k) holds the running top-k in key order, pool[k..k+qn) the
  // partial entries of this round that beat its k-th entry
  __shared__ float pool_s[KMAX + QCAP];
  __shared__ int pool_p[KMAX + QCAP];
  __shared__ float out_s[KMAX];
  __shared__ int out_p[KMAX];
  __shared__ int qn;
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < k; i += MERGE_THREADS) {
    pool_s[i] = init_s[(size_t)b * k + i];
    pool_p[i] = i;
  }
  if (tid == 0) qn = 0;
  __syncthreads();
  pool_select(pool_s, pool_p, k, k, out_s, out_p);  // the carried entries may come unsorted
  __syncthreads();
  for (int i = tid; i < k; i += MERGE_THREADS) {
    pool_s[i] = out_s[i];
    pool_p[i] = out_p[i];
  }
  __syncthreads();

  const int per_round = min(MERGE_THREADS, QCAP / kc);
  for (int c0 = 0; c0 < NC; c0 += per_round) {
    const float thr_s = pool_s[k - 1];
    const int thr_p = pool_p[k - 1];
    const int c = c0 + tid;
    if (tid < per_round && c < NC) {
      const size_t at = (size_t)b * NC + c;
      const int n = part_n[at];
      for (int e = 0; e < n; ++e) {  // partials are in key order
        const float s = part_s[at * kc + e];
        const int p = part_p[at * kc + e] + k;
        if (!better(s, p, thr_s, thr_p)) break;
        const int slot = atomicAdd(&qn, 1);
        pool_s[k + slot] = s;
        pool_p[k + slot] = p;
      }
    }
    __syncthreads();
    const int n_new = qn;
    if (n_new > 0) {  // uniform across the block
      pool_select(pool_s, pool_p, k + n_new, k, out_s, out_p);
      __syncthreads();
      for (int i = tid; i < k; i += MERGE_THREADS) {
        pool_s[i] = out_s[i];
        pool_p[i] = out_p[i];
      }
      if (tid == 0) qn = 0;
    }
    __syncthreads();
  }
  for (int i = tid; i < k; i += MERGE_THREADS) {
    const int p = pool_p[i];
    int row;
    if (p < k) {
      row = init_r[(size_t)b * k + p];
    } else {
      const int t = p - k;
      row = slots[t / page_rows] * page_rows + t % page_rows;
    }
    top_s[(size_t)b * k + i] = pool_s[i];
    top_r[(size_t)b * k + i] = row;
  }
}

// The merge order as one 64-bit key, larger = better: the score's bits mapped
// to an unsigned order (-0 counted as +0, as a float compare does), then the
// position inverted, so the lower position wins a tie. Real keys are never 0.
__device__ __forceinline__ unsigned long long merge_key(float s, int p) {
  unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)p);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  unsigned u = (unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_pos(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)key);
}

// Calls f(ok, key) for every entry of query b's pool, 32 entries per call of
// a whole warp (ok = false on the lanes past the end, whose key is 0): the
// k carried entries, then each chunk's partial (one warp per chunk). The
// loop bounds are uniform across a warp, so f may use warp intrinsics.
template <class F>
__device__ __forceinline__ void for_each_key(
    const float* __restrict__ init_s, const float* __restrict__ part_s,
    const int* __restrict__ part_p, const int* __restrict__ part_n,
    int b, int k, int kc, int NC, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = warp * 32; i0 < k; i0 += LARGE_THREADS) {
    const int i = i0 + lane;
    f(i < k, i < k ? merge_key(init_s[(size_t)b * k + i], i) : 0ull);
  }
  for (int c = warp; c < NC; c += LARGE_THREADS / 32) {
    const size_t at = (size_t)b * NC + c;
    const int n = part_n[at];
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      f(e < n, e < n ? merge_key(part_s[at * kc + e], part_p[at * kc + e] + k)
                     : 0ull);
    }
  }
}

// Merge for k > KMAX, in device memory (one block per query). A radix select
// over the keys, 8 bits a pass from the top, fixes the digits of the k-th
// best key and stops once every key that shares the prefix found so far is
// taken; the keys at or above that prefix (exactly k, the keys are unique)
// are compacted into keys[b] (kp2 = next power of two >= k, the rest
// zero-filled), sorted ascending by a bitonic network and read out from the
// top.
__global__ void __launch_bounds__(LARGE_THREADS) bm_merge_large_kernel(
    const float* __restrict__ init_s, const int* __restrict__ init_r,
    const int* __restrict__ slots, const float* __restrict__ part_s,
    const int* __restrict__ part_p, const int* __restrict__ part_n,
    float* __restrict__ top_s, int* __restrict__ top_r,
    unsigned long long* keys, int k, int kc, int NC, int page_rows, int kp2) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long prefix_s;
  __shared__ int rem_s, shift_s, done_s, n_out;
  const int b = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    prefix_s = 0ull;
    rem_s = k;
    n_out = 0;
  }
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0u;
    __syncthreads();
    const unsigned long long prefix = prefix_s;
    const unsigned long long hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
    for_each_key(init_s, part_s, part_p, part_n, b, k, kc, NC,
                 [&](bool ok, unsigned long long key) {
                   // lanes of one digit add their count once (the top
                   // digits of near scores are shared by most entries)
                   const unsigned digit = ok && (key & hi) == prefix
                                              ? (unsigned)(key >> shift) & 255u
                                              : 256u;
                   const unsigned same = __match_any_sync(FULL, digit);
                   if (digit < 256u && (threadIdx.x & 31) == __ffs(same) - 1)
                     atomicAdd(&hist[digit], (unsigned)__popc(same));
                 });
    __syncthreads();
    if (tid == 0) {
      const unsigned rem = (unsigned)rem_s;
      unsigned above = 0;
      int digit = 255;
      for (; digit > 0 && above + hist[digit] < rem; --digit) above += hist[digit];
      prefix_s = prefix | ((unsigned long long)digit << shift);
      rem_s = (int)(rem - above);
      shift_s = shift;
      done_s = hist[digit] == rem - above;
    }
    __syncthreads();
    if (done_s) break;
  }
  const int shift = shift_s;
  const unsigned long long cut = prefix_s >> shift;
  unsigned long long* kb = keys + (size_t)b * kp2;
  for_each_key(init_s, part_s, part_p, part_n, b, k, kc, NC,
               [&](bool ok, unsigned long long key) {
                 if (ok && (key >> shift) >= cut) {
                   const int at = atomicAdd(&n_out, 1);
                   if (at < k) kb[at] = key;
                 }
               });
  for (int i = k + tid; i < kp2; i += LARGE_THREADS) kb[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= kp2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < kp2 / 2; i += LARGE_THREADS) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = kb[lo], c = kb[hi];
        if ((a > c) == ((lo & size) == 0)) {
          kb[lo] = c;
          kb[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += LARGE_THREADS) {
    const unsigned long long key = kb[kp2 - 1 - i];
    const int p = key_pos(key);
    float s;
    int row;
    if (p < k) {  // carried: its own bits (a -0 stays -0)
      s = init_s[(size_t)b * k + p];
      row = init_r[(size_t)b * k + p];
    } else {
      const int t = p - k;
      s = key_score(key);
      row = slots[t / page_rows] * page_rows + t % page_rows;
    }
    top_s[(size_t)b * k + i] = s;
    top_r[(size_t)b * k + i] = row;
  }
}

}  // namespace

extern "C" int block_mips_tile_rows() { return RT; }

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the four passes on `stream`. Scratch: live (B, NS) u8,
// part_s (B, NC, kc) f32, part_p (B, NC, kc) i32, part_n (B, NC) i32 with
// spc = RT / page_rows slots per chunk, NC = ceil(NS / spc),
// kc = min(k, spc * page_rows), and keys (B, kp2) u64 with kp2 the next
// power of two >= k (used when k > KMAX). Returns the first launch error,
// or 0.
extern "C" int block_mips_launch(
    const float* x, const uint8_t* valid, const float* q, const int* slots,
    const uint8_t* sel, const float* init_s, const int* init_r,
    const float* c_half, float* top_s, int* top_r, int* cnt, int* pages,
    int* cand, uint8_t* live, float* part_s, int* part_p, int* part_n,
    unsigned long long* keys, int B, int d, int NS, int k, int page_rows,
    int spc, int kc, int NC, int kp2, void* stream_handle) {
  if (B < 1 || d < 1 || NS < 1 || k < 1 || page_rows < 1 ||
      page_rows > RT || spc != RT / page_rows || kc != min(k, spc * page_rows) ||
      NC != (NS + spc - 1) / spc || B > 65535 * QT || kp2 < k ||
      (kp2 & (kp2 - 1)) != 0 || kp2 >= 2 * k ||
      (long long)NS * page_rows + k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 grid(NC, (B + QT - 1) / QT);
  bm_count_kernel<<<grid, THREADS, 0, stream>>>(x, valid, q, slots, sel, c_half,
                                                cnt, B, d, NS, page_rows, spc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bm_scan_kernel<<<B, SCAN_THREADS, 0, stream>>>(cnt, sel, valid, slots, init_s,
                                                 c_half, live, pages, cand, NS,
                                                 k, page_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bm_topk_kernel<<<grid, THREADS, 0, stream>>>(x, valid, q, slots, live, part_s,
                                               part_p, part_n, B, d, NS,
                                               page_rows, spc, kc, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= KMAX)
    bm_merge_kernel<<<B, MERGE_THREADS, 0, stream>>>(init_s, init_r, slots, part_s,
                                                     part_p, part_n, top_s, top_r,
                                                     k, kc, NC, page_rows);
  else
    bm_merge_large_kernel<<<B, LARGE_THREADS, 0, stream>>>(
        init_s, init_r, slots, part_s, part_p, part_n, top_s, top_r, keys, k,
        kc, NC, page_rows, kp2);
  return static_cast<int>(cudaGetLastError());
}
