// The block walk of the scan and progressive searches on Hopper (sm_90a).
//
// Replaces: src/repro/core/search_device.py `_scan_blocks` (the `lax.scan`
// body at :441) and `search_batch_progressive` (the body at :611). Neither
// is a Pallas kernel: XLA compiles each loop into one program. Run eagerly,
// a round of the walk would be about ten launches per step and up to NB
// steps (125,000 at n = 1M), so the walk is one kernel instead.
//
// Grid: one block (CTA) per query. The CTA walks its query's blocks in the
// given order, `budget` steps at most (scan: at most n_sel), and keeps the
// running top-k in shared memory. A step is live while Condition A has not
// stopped the walk and, in scan mode, t < n_sel; in progressive mode, while
// the block qualifies under the running k-th score s_k:
//   r = sqrt(max(x_p * (M_blk + |q|^2 - 2 max(s_k, -1e30) / c), 0)),
//   r = -1 if cs_prune and sqrt(M_blk) * sqrt(|q|^2) < s_k,
//   live iff gap_blk <= r and r >= 0
// (`search_common.adaptive_radii` + `gap_select`, each operation an IEEE
// intrinsic in the same order as the f32 plain version, so no qualify
// differs from it). A live step merges the block's valid rows into the
// top-k as `lax.top_k` over [carried, new rows] does: a row enters only
// when its score beats the k-th strictly, after every entry it ties.
//
// The walk goes chunk by chunk: the CTA scores up to 256 rows (256 /
// page_rows blocks) in parallel, then one warp replays the chunk's steps in
// order. In progressive mode a block is scored only if it qualifies under
// the s_k of the chunk's start: s_k only grows and the radius only shrinks
// with it (each rounded operation is monotone), so a block that fails then
// fails at its step too. In scan mode every block before n_sel is scored,
// and the scores past the Condition-A stop are dropped.
//
// Every score is one fmaf chain from 0.f over depth 0..d-1 in order, the
// order of the GEMM plain version on the card. No tensor cores: TF32 would
// round the scores that decide the stop and the rows.
//
// What bounds it: the pages the walk reads, page_rows * d * 4 bytes each,
// at 3.35 TB/s. What this first version does about it: each chunk's rows
// are staged through shared memory in 64-deep slices, every copy of a
// slice in flight at once (cp.async, coalesced by row), a staged row
// padded to an odd stride so the thread-per-row reads are free of bank
// conflicts. It does not overlap the loads with the merge, a query's CTA
// runs its steps alone (the batch waits for its longest walk), and one CTA
// per query leaves SMs idle below B = 132.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NR = 256;          // rows scored per chunk, one per thread
constexpr int DS = 64;           // depth slice staged at a time
constexpr int XS = DS + 1;       // a staged row's stride (odd)
constexpr float MIN_SCORE = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448; // the H100's opt-in shared memory a block

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__global__ void __launch_bounds__(THREADS)
scan_blocks_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, k = a.k, pr = a.pr, nb = a.nb;

  float* stage = reinterpret_cast<float*>(smem);        // NR * XS
  float* sc = stage + NR * XS;                          // NR
  float* qs = sc + NR;                                  // d
  float* ts = qs + d;                                   // k
  int* tr = reinterpret_cast<int*>(ts + k);             // k
  int* blk_s = tr + k;                                  // NR
  unsigned char* need_s = reinterpret_cast<unsigned char*>(blk_s + NR);  // NR
  unsigned char* vrow = need_s + NR;                    // NR
  __shared__ int s_done;

  const float* qg = a.q + static_cast<int64_t>(b) * d;
  for (int j = tid; j < d; j += THREADS) qs[j] = qg[j];
  for (int j = tid; j < k; j += THREADS) {
    ts[j] = a.init_s[static_cast<int64_t>(b) * k + j];
    tr[j] = a.init_r[static_cast<int64_t>(b) * k + j];
  }
  __syncthreads();
  const float c_half = a.c_half[b];
  const float ql = a.progressive ? a.q_l2sq[b] : 0.f;
  const bool prog = a.progressive != 0, cs = a.cs_prune != 0;
  if (tid == 0) s_done = ts[k - 1] >= c_half;
  const int limit = prog ? min(a.budget, nb) : min(a.budget, a.n_sel[b]);
  const int ch = NR / pr;                               // blocks per chunk
  const int* order = a.order + static_cast<int64_t>(b) * nb;
  const float* gap = prog ? a.gap + static_cast<int64_t>(b) * nb : nullptr;
  int pages = 0, cand = 0;                              // warp 0's tally
  __syncthreads();

  for (int t0 = 0; t0 < limit && !s_done; t0 += ch) {
    const int n = min(ch, limit - t0);
    const int rows = n * pr;
    // which of the chunk's blocks to score
    const float s_k0 = ts[k - 1];
    for (int i = tid; i < n; i += THREADS) {
      const int blk = order[t0 + i];
      blk_s[i] = blk;
      need_s[i] = prog ? qualify(gap[blk], a.blk_l2sq[blk], s_k0, ql, a.c,
                                 a.x_p, cs)
                       : 1;
    }
    __syncthreads();
    // score: thread `tid` owns row `tid` of the chunk
    const int my_i = tid / pr;
    const bool mine = tid < rows && need_s[my_i];
    const int64_t my_row =
        mine ? static_cast<int64_t>(blk_s[my_i]) * pr + tid % pr : 0;
    const bool my_valid = mine && a.ids[my_row] >= 0;
    float acc = 0.f;
    for (int d0 = 0; d0 < d; d0 += DS) {
      const int w = min(DS, d - d0);
      for (int rr = warp; rr < rows; rr += THREADS / 32) {
        const int i = rr / pr;
        if (!need_s[i]) continue;
        const float* src =
            a.x + (static_cast<int64_t>(blk_s[i]) * pr + rr % pr) * d + d0;
        for (int cc = lane; cc < w; cc += 32)
          cp_async4(&stage[rr * XS + cc], src + cc);
      }
      cp_async_wait_all();
      __syncthreads();
      if (mine) {
        const float* row = stage + tid * XS;
        for (int j = 0; j < w; ++j) acc = fmaf(row[j], qs[d0 + j], acc);
      }
      __syncthreads();
    }
    if (tid < rows) {
      sc[tid] = acc;
      vrow[tid] = my_valid;
    }
    __syncthreads();
    // replay the chunk's steps in order
    if (warp == 0) {
      bool done = false;
      for (int i = 0; i < n && !done; ++i) {
        if (!need_s[i]) continue;             // not live at its step either
        const int blk = blk_s[i];
        if (prog && !qualify(gap[blk], a.blk_l2sq[blk], ts[k - 1], ql, a.c,
                             a.x_p, cs))
          continue;
        ++pages;
        for (int r0 = 0; r0 < pr; r0 += 32) {
          const int r = r0 + lane;
          const bool v = r < pr && vrow[i * pr + r];
          const float s = v ? sc[i * pr + r] : -CUDART_INF_F;
          cand += __popc(__ballot_sync(FULL, v));
          unsigned m = __ballot_sync(FULL, v && s > ts[k - 1]);
          while (m) {
            const int src = __ffs(m) - 1;
            const float sv = __shfl_sync(FULL, s, src);
            insert(ts, tr, k, sv, blk * pr + r0 + src, lane);
            m &= ~((2u << src) - 1u);
            m &= __ballot_sync(FULL, v && s > ts[k - 1]);
          }
        }
        done = ts[k - 1] >= c_half;
      }
      if (lane == 0) s_done = done;
    }
    __syncthreads();
  }

  for (int j = tid; j < k; j += THREADS) {
    a.top_s[static_cast<int64_t>(b) * k + j] = ts[j];
    a.top_r[static_cast<int64_t>(b) * k + j] = tr[j];
  }
  if (tid == 0) {
    a.pages[b] = pages;
    a.cand[b] = cand;
    a.done[b] = s_done != 0;
  }
}

}  // namespace

// Dynamic shared memory of one CTA for depth d and k.
extern "C" long long scan_blocks_smem_bytes(int d, int k) {
  return static_cast<long long>(NR) * XS * 4 + NR * 4 + 4LL * d + 8LL * k +
         NR * 4 + 2 * NR;
}

extern "C" int scan_blocks_max_smem() { return SMEM_MAX; }

extern "C" int scan_blocks_launch(
    const float* x, const int* ids, const float* q, const int* order,
    const int* n_sel, const float* gap, const float* blk_l2sq,
    const float* q_l2sq, const float* init_s, const int* init_r,
    const float* c_half, float* top_s, int* top_r, int* pages, int* cand,
    bool* done, int b, int d, int nb, int k, int pr, int budget,
    int progressive, int cs_prune, float c, float x_p, cudaStream_t stream) {
  if (b < 1 || d < 1 || nb < 1 || k < 1 || pr < 1 || pr > NR)
    return cudaErrorInvalidValue;
  const long long smem = scan_blocks_smem_bytes(d, k);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  static LaunchCache cache;
  int resident = 0;
  cudaError_t err = resident_blocks(cache, scan_blocks_kernel, THREADS,
                                    static_cast<int>(smem), &resident);
  if (err != cudaSuccess) return err;
  Args a{x,     ids,   q,     order, n_sel, gap,  blk_l2sq, q_l2sq,
         init_s, init_r, c_half, top_s, top_r, pages, cand, done,
         d,     nb,    k,     pr,    budget, progressive, cs_prune, c, x_p};
  scan_blocks_kernel<<<b, THREADS, static_cast<int>(smem), stream>>>(a);
  return cudaGetLastError();
}
