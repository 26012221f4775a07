// One fused ProMIPS verification round on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_mips.py::block_mips (Pallas body
// `_kernel`, streaming top-k `_rank_topk`). The TPU grid walks the slot list
// in order and carries the per-query hit count from page to page. Hopper
// runs blocks in no order, so the round is split the way
// src/repro/kernels/ref.py::_verify_core splits it, into three launches on
// one stream:
//   1. plan (one thread per slot): per 64-query tile, a 64-bit mask of the
//      queries that select each slot, the list of the chunks (64 / page_rows
//      slots) that some query of the tile selects, cnt = 0 on the others,
//      and each slot's valid rows as a bit mask and a count.
//   2. score (persistent grid x query tiles): each selected page is read
//      from device memory once per tile, and each selected (query, page)
//      pair is scored once. The row scores of the selected pairs go to a
//      scratch buffer scr (B, NS, page_rows) (-inf on invalid rows), and
//      cnt[b, slot] = the valid rows scoring >= c_half[b], times sel (past
//      the stop too, as on TPU).
//   3. merge (one thread-block cluster per query): the Condition-A scan of
//      cnt over the slots from n0 = #(init >= c_half) gives one cut per
//      query -- live = sel & (slot < cut), since a query's live slots are a
//      prefix of its selected slots -- and the pages / candidates of the
//      live slots. Then one selection for every k under a 64-bit key
//      (merge_key: score desc, position asc; carried entries at positions
//      0..k-1, tile row t at k + t, the `lax.top_k` tie rule): a radix
//      select over the carried keys and the live stored scores finds the
//      k-th key, the keys at or above it (exactly k: keys are unique) are
//      compacted, and a bitonic network sorts them (in shared memory in
//      chunks of up to SORT_CH keys, across the cluster through device
//      memory above that).
//
// Every score is one fmaf chain from 0.f over depth 0..d-1 in order (the
// zero padding of a partial 4-wide unit adds +0 to a sum that is never -0),
// so a score does not depend on the path that computed it and
// integer-valued data gives exact scores, ties included. No tensor cores:
// TF32 would round the scores that decide the hits and the rows.
//
// What bounds it: the union of the selected pages is read once (round 1 at
// n = 1M: 25,980 4-KB pages, 0.035 ms at 3.35 TB/s), and 2 * page_rows * d
// fp32 operations per selected pair (round 2: 8.6 GFLOP, 0.129 ms at
// 67 TFLOP/s, below its 0.158 ms of bytes). What the design does about it:
//   * the score kernel is persistent: each block stages its 64 queries once
//     (in shared memory when they fit, else slice by slice with the pages)
//     and walks its share of the tile's chunk list in 128-deep slices
//     through a two-stage ring: the next item's rows (one bulk copy a row,
//     completed on the stage's mbarrier) and the plan's info of the chunk
//     two ahead (cp.async) are in flight while one is scored. Only the
//     pages some query of the tile selects are copied; chunks nobody
//     selects are not visited.
//   * a chunk with at most SPARSE_ITEMS selected (pair, row) scores is
//     scored pair by pair (one thread per row of a selected pair); a denser
//     chunk as a 64 x 64 tile with a 4 x 4 (row, query) register tile per
//     thread. Staged rows are padded by 16 bytes and the resident queries
//     XOR-swizzled by 16-byte unit, so both read float4s without bank
//     conflicts.
//   * the merge spreads a query over a cluster of CL blocks (the most of 8,
//     4, 2 and 1 with which all B clusters are resident at once): the
//     blocks split the scan and the candidates and add their radix
//     histograms through distributed shared memory. A block reads the live
//     stored scores from device memory until its candidates at or above the
//     prefix found so far fit in its shared memory (SORT_CH keys); its later
//     passes read only those. Tile keys below the smallest carried key are
//     skipped: the k carried keys already bound the k-th from below.
//
// Scratch: scr (B, NS, page_rows) f32 -- the (B, R) score matrix, written
// only at selected pairs -- keys (B, kp2) u64, and the plan's 21 bytes a
// slot per query tile. At the stream's state-B base round (B 64,
// NS 125,000, page_rows 8, k 2,058) that is 256 MB, 2 MB and 2.6 MB.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

#include "launch_cache.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int QT = 64;             // queries per score tile
constexpr int RT = 64;             // rows per chunk: spc * page_rows <= RT
constexpr int DS = 128;            // depth slice of a stage
constexpr int XS = DS + 4;         // a staged row's stride: 16 bytes of padding
constexpr int THREADS = 256;       // score kernel: 16 x 16, 4 x 4 tiles
constexpr int SPARSE_ITEMS = 1024; // pair rows a chunk may have to go sparse
constexpr int SPARSE_PER_THREAD = SPARSE_ITEMS / THREADS;
constexpr int Q_RES_BYTES = 64 * 1024;  // resident queries up to d = 256
constexpr int MT = 512;            // merge threads per block
constexpr int HBINS = 2048;        // radix digits of up to 11 bits
constexpr int SORT_CH = 8192;      // keys a block sorts in shared memory
constexpr int CL_MAX = 8;          // portable cluster size
constexpr unsigned FULL = 0xffffffffu;
static_assert(RT == 8 * (THREADS / 32) && QT == RT,
              "each warp of the score kernel copies 8 rows and 8 queries");

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
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

__device__ __forceinline__ void cp_async_wait(bool one_in_flight) {
  if (one_in_flight)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A load the compiler keeps where it is written (a plain load may sink to
// its first use, a chunk later, and put its latency back on the path).
__device__ __forceinline__ int ld_early(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Where depth c of staged row rr sits in its row: 16-byte unit c / 4 goes
// to unit (c / 4) ^ (rr % 8) within its group of 8 units, so 8 consecutive
// rows read 8 distinct bank groups at the same depth.
__device__ __forceinline__ int swz(int rr, int c) {
  return ((((c >> 2) ^ rr) & 7) | ((c >> 2) & ~7)) << 2 | (c & 3);
}

// swz(rr, 4 * u): where 16-byte unit u of a row with rr % 8 == r7 starts.
__device__ __forceinline__ int swz_unit(int u, int r7) {
  return (((u ^ r7) & 7) | (u & ~7)) << 2;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------- plan kernel

// Per query tile and chunk of spc slots (chunk c holds slots c * spc ..):
// masks[tile][s] = the tile's queries that select slot s (bit qq), the
// chunks some query of the tile selects appended to list[tile] (count[tile]
// of them, in no order), and cnt = 0 for every slot of the other chunks;
// from tile 0, vmask[s] = the valid rows of slot s (bit r) and vcnt[s]
// their count. One thread per slot, whole chunks per block.
__global__ void __launch_bounds__(THREADS) bm_plan_kernel(
    const uint8_t* __restrict__ sel, const int* __restrict__ slots,
    const uint8_t* __restrict__ valid, unsigned long long* __restrict__ masks,
    unsigned long long* __restrict__ vmask, int* __restrict__ vcnt,
    int* __restrict__ cnt, int* __restrict__ list, int* __restrict__ count,
    int B, int NS, int page_rows, int spc, int n_chunks) {
  __shared__ int any_s[THREADS];
  __shared__ int n_s, base_s;
  const int tid = threadIdx.x, tile = blockIdx.y, qt0 = tile * QT;
  const int cpb = THREADS / spc;  // chunks per block
  const int c = blockIdx.x * cpb + tid / spc;
  const int s = c * spc + tid % spc;
  const bool on = tid < cpb * spc && c < n_chunks && s < NS;
  if (tid < cpb) any_s[tid] = 0;
  if (tid == 0) n_s = 0;
  __syncthreads();
  unsigned long long m = 0ull;
  if (on) {
    const int qn = min(QT, B - qt0);
#pragma unroll 16
    for (int qq = 0; qq < qn; ++qq)
      m |= (unsigned long long)(sel[(size_t)(qt0 + qq) * NS + s] != 0) << qq;
    masks[(size_t)tile * NS + s] = m;
    if (tile == 0) {
      const size_t row0 = (size_t)slots[s] * page_rows;
      unsigned long long vm = 0ull;
#pragma unroll 8
      for (int r = 0; r < page_rows; ++r)
        vm |= (unsigned long long)(valid[row0 + r] != 0) << r;
      vmask[s] = vm;
      vcnt[s] = __popcll(vm);
    }
    if (m) any_s[tid / spc] = 1;
  }
  __syncthreads();
  int at = -1;
  if (tid < cpb && blockIdx.x * cpb + tid < n_chunks && any_s[tid])
    at = atomicAdd(&n_s, 1);
  __syncthreads();
  if (tid == 0 && n_s) base_s = atomicAdd(&count[tile], n_s);
  __syncthreads();
  if (at >= 0) list[(size_t)tile * n_chunks + base_s + at] = blockIdx.x * cpb + tid;
  if (on && !any_s[tid / spc]) {
    const int qn = min(QT, B - qt0);
    for (int qq = 0; qq < qn; ++qq) cnt[(size_t)(qt0 + qq) * NS + s] = 0;
  }
}

// ------------------------------------------------------------ score kernel

// What a block knows of one chunk: copied in two chunks ahead of its use.
struct ChunkInfo {
  unsigned long long mask[RT];   // per slot: the tile's selecting queries
  unsigned long long vmask[RT];  // per slot: its valid rows
  int slot[RT];                  // block id of each slot
  int chunk;
};

struct ScoreShared {
  unsigned long long bar[2];     // one per stage: its rows have landed
  ChunkInfo info[3];
  uint16_t pair[SPARSE_ITEMS];   // sparse chunk: (slot << 6) | query
  float ch[QT];
  int npairs;
};

// Shared memory (dynamic): q_s [QT][dq32] (swizzled) when the queries are
// resident, then two stages of [RT][XS] rows (+ [QT][XS] queries when they
// are not); the 16 bytes that pad each staged row put 8 consecutive rows at
// the same depth in 8 distinct bank groups. The score tile of a finished
// chunk is written over its stage. A block takes a contiguous range of its
// tile's chunk list; its work items are (chunk, 128-deep slice) in order.
// Each step issues the next item's rows -- one bulk copy a row, completed
// on the stage's barrier (4-byte cp.async copies when rows are not 16-byte
// aligned) -- and, at a chunk's first slice, cp.async copies of the info
// of the chunk two ahead. Two blocks an SM (what that shared memory allows
// at d <= 256): up to 128 registers.
__global__ void __launch_bounds__(THREADS, 2) bm_score_kernel(
    const float* __restrict__ x, const float* __restrict__ q,
    const int* __restrict__ slots, const float* __restrict__ c_half,
    const unsigned long long* __restrict__ masks,
    const unsigned long long* __restrict__ vmask,
    const int* __restrict__ list, const int* __restrict__ count,
    int* __restrict__ cnt, float* __restrict__ scr, int B, int d, int NS,
    int page_rows, int spc, int n_chunks, bool q_res, bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ScoreShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.y, qt0 = tile * QT;
  const int dq32 = (d + 31) & ~31;
  const int n_slices = (d + DS - 1) / DS;
  const int stage_floats = (RT + (q_res ? 0 : QT)) * XS;
  float* q_s = smem;
  float* ring = smem + (q_res ? QT * dq32 : 0);
  const int* tlist = list + (size_t)tile * n_chunks;
  const int n_list = count[tile];
  const int e_begin = (int)((long long)n_list * blockIdx.x / gridDim.x);
  const int e_end = (int)((long long)n_list * (blockIdx.x + 1) / gridDim.x);

  if (q_res) {
    for (int i = tid; i < QT * dq32; i += THREADS) {
      const int qq = i / dq32, c = i - qq * dq32, b = qt0 + qq;
      q_s[qq * dq32 + swz(qq, c)] = (b < B && c < d) ? q[(size_t)b * d + c] : 0.f;
    }
  }
  if (tid < QT) sh.ch[tid] = qt0 + tid < B ? c_half[qt0 + tid] : 0.f;

  // Copy the info of list entry e (chunk c) into slot e % 3.
  auto stage_info = [&](int e, int c) {
    ChunkInfo& in = sh.info[e % 3];
    const int s0 = c * spc, ns = min(spc, NS - s0);
    for (int i = tid; i < 3 * RT; i += THREADS) {
      const int kind = i / RT, sl = i - kind * RT;
      if (sl >= ns) {  // past the last slot: nobody selects it
        if (kind == 0 && sl < spc) in.mask[sl] = 0ull;
        continue;
      }
      if (kind == 0)
        cp_async8(&in.mask[sl], masks + (size_t)tile * NS + s0 + sl);
      else if (kind == 1)
        cp_async8(&in.vmask[sl], vmask + s0 + sl);
      else
        cp_async4(reinterpret_cast<float*>(&in.slot[sl]),
                  reinterpret_cast<const float*>(slots + s0 + sl));
    }
    if (tid == 0) in.chunk = c;
  };

  // Issue the copies of the rows (and non-resident queries) of slice `sl`
  // of list entry e into stage `st`: rows of slots nobody selects, and
  // queries past B, are not copied (their sums are never read).
  auto stage_rows = [&](int e, int sl, int st) {
    const ChunkInfo& in = sh.info[e % 3];
    float* xs = ring + st * stage_floats;
    float* qs = xs + RT * XS;
    const int c0 = sl * DS, cols = min(DS, d - c0);
    const int rows = min(spc, NS - in.chunk * spc) * page_rows;
    if (vec) {  // cols % 4 == 0: the compute reads no padding
      // warp w copies rows 8w..8w+7 (lanes 0-7) and, when the queries are
      // not resident, query rows 8w..8w+7 (lanes 8-15), and arrives once
      const int i = 8 * warp + (lane & 7);
      const bool take = lane < 8 ? i < rows && in.mask[i / page_rows] != 0
                      : lane < 16 && !q_res && qt0 + i < B;
      const unsigned m = __ballot_sync(FULL, take);
      const uint32_t bytes = 4u * cols;
      if (lane == 0) mbar_expect_tx(&sh.bar[st], __popc(m) * bytes);
      __syncwarp();
      if (take && lane < 8)
        bulk_copy(xs + i * XS,
                  x + ((size_t)in.slot[i / page_rows] * page_rows + i % page_rows) * d + c0,
                  bytes, &sh.bar[st]);
      else if (take)
        bulk_copy(qs + i * XS, q + (size_t)(qt0 + i) * d + c0, bytes, &sh.bar[st]);
    } else {  // 4-byte copies; the last partial unit zero-filled
      const int cpad = (cols + 3) & ~3;
      for (int i = tid; i < RT * cpad; i += THREADS) {
        const int rr = i / cpad, c = i - rr * cpad;
        if (rr >= rows || !in.mask[rr / page_rows]) continue;
        if (c < cols)
          cp_async4(xs + rr * XS + c, x + ((size_t)in.slot[rr / page_rows] * page_rows +
                                           rr % page_rows) * d + c0 + c);
        else
          xs[rr * XS + c] = 0.f;
      }
      if (!q_res)
        for (int i = tid; i < QT * cpad; i += THREADS) {
          const int qq = i / cpad, c = i - qq * cpad, b = qt0 + qq;
          if (b >= B) continue;
          if (c < cols)
            cp_async4(qs + qq * XS + c, q + (size_t)b * d + c0 + c);
          else
            qs[qq * XS + c] = 0.f;
        }
      if (lane == 0) mbar_expect_tx(&sh.bar[st], 0);  // no bytes to wait for
    }
  };

  if (e_begin >= e_end) return;
  if (tid == 0) {
    mbar_init(&sh.bar[0], THREADS / 32);  // one arrival per warp
    mbar_init(&sh.bar[1], THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // prologue: the info of the first two entries, then the first rows
  int pending = e_begin + 2 < e_end ? tlist[e_begin + 2] : -1;
  stage_info(e_begin, tlist[e_begin]);
  if (e_begin + 1 < e_end) stage_info(e_begin + 1, tlist[e_begin + 1]);
  cp_async_commit();
  cp_async_wait(false);
  __syncthreads();
  stage_rows(e_begin, 0, 0);
  cp_async_commit();

  float acc[4][4];
  bool sparse = false;
  int n_items = 0;
  int st = 0;
  unsigned phase = 0u;  // bit st: the parity of stage st's next phase
  for (int e = e_begin, sl = 0; e < e_end;) {
    cp_async_wait(false);
    mbar_wait(&sh.bar[st], (phase >> st) & 1u);
    phase ^= 1u << st;
    __syncthreads();  // this item's rows and the info copied so far have landed
    const ChunkInfo& in = sh.info[e % 3];
    // the next step's copies: the next item's rows, and at a chunk's first
    // slice the info of the entry two ahead
    if (sl == 0 && e + 2 < e_end) {
      stage_info(e + 2, pending);
      pending = e + 3 < e_end ? ld_early(tlist + e + 3) : -1;
    }
    const int e_n = sl + 1 < n_slices ? e : e + 1;
    const int sl_n = sl + 1 < n_slices ? sl + 1 : 0;
    if (e_n < e_end) stage_rows(e_n, sl_n, st ^ 1);
    cp_async_commit();

    const int s0 = in.chunk * spc, ns = min(spc, NS - s0);
    const int tq = tid & 15, tr = tid >> 4;
    float* xs = ring + st * stage_floats;
    if (sl == 0) {  // a new chunk: count its pairs, choose its path
      if (warp == 0) {
        int total = 0;
        for (int s = lane; s < spc; s += 32) total += __popcll(in.mask[s]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
        if (total * page_rows <= SPARSE_ITEMS) {  // the pair list, (slot, query) order
          int off = 0;
          for (int s0l = 0; s0l < spc; s0l += 32) {
            const int s = s0l + lane;
            const unsigned long long m = s < spc ? in.mask[s] : 0ull;
            const int n = __popcll(m);
            int incl = n;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int t = __shfl_up_sync(FULL, incl, o);
              if (lane >= o) incl += t;
            }
            int at = off + incl - n;
            for (unsigned long long mm = m; mm; mm &= mm - 1)
              sh.pair[at++] = static_cast<uint16_t>((s << 6) | (__ffsll(mm) - 1));
            off += __shfl_sync(FULL, incl, 31);
          }
        }
        if (lane == 0) sh.npairs = total;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      __syncthreads();
      n_items = sh.npairs * page_rows;
      sparse = n_items <= SPARSE_ITEMS;
    }
    const int c0 = sl * DS, units = (min(DS, d - c0) + 3) / 4;
    const float* qbase = q_res ? q_s : xs + RT * XS;
    const int qstride = q_res ? dq32 : XS, qu0 = q_res ? c0 / 4 : 0;
    const int qsw = q_res ? 7 : 0;  // resident queries are swizzled
    if (sparse) {
#pragma unroll
      for (int j = 0; j < SPARSE_PER_THREAD; ++j) {
        const int item = tid + j * THREADS;
        if (item >= n_items) break;
        const int pv = sh.pair[item / page_rows];
        const int rr = (pv >> 6) * page_rows + item % page_rows, qq = pv & 63;
        const float* xr = xs + rr * XS;
        const float* qr = qbase + qq * qstride;
        const int q7 = qq & qsw;
        float a = acc[j >> 2][j & 3];
#pragma unroll 4
        for (int u = 0; u < units; ++u) {
          const float4 xv = ld4(xr + 4 * u);
          const float4 qv = ld4(qr + swz_unit(qu0 + u, q7));
          a = fmaf(xv.x, qv.x, a);
          a = fmaf(xv.y, qv.y, a);
          a = fmaf(xv.z, qv.z, a);
          a = fmaf(xv.w, qv.w, a);
        }
        acc[j >> 2][j & 3] = a;
      }
    } else {
      // rows tr + 16 i and queries tq + 16 j share their swizzle (r % 8)
      const float* xb = xs + tr * XS;
      const float* qb = qbase + tq * qstride;
#pragma unroll 2
      for (int u = 0; u < units; ++u) {
        const int xo = 4 * u, qo = swz_unit(qu0 + u, tq & qsw);
        float4 xv[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = ld4(xb + 16 * i * XS + xo);
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = ld4(qb + 16 * j * qstride + qo);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(xv[i].x, qv[j].x, acc[i][j]);
            acc[i][j] = fmaf(xv[i].y, qv[j].y, acc[i][j]);
            acc[i][j] = fmaf(xv[i].z, qv[j].z, acc[i][j]);
            acc[i][j] = fmaf(xv[i].w, qv[j].w, acc[i][j]);
          }
      }
    }

    if (sl == n_slices - 1) {  // the chunk is scored: write it out
      __syncthreads();         // the stage is read; it holds S now
      float* S = xs;
      if (sparse) {
#pragma unroll
        for (int j = 0; j < SPARSE_PER_THREAD; ++j) {
          const int item = tid + j * THREADS;
          if (item < n_items) S[item] = acc[j >> 2][j & 3];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) S[(tq + 16 * j) * (RT + 1) + tr + 16 * i] = acc[i][j];
      }
      __syncthreads();
      for (int i = tid; i < QT * spc; i += THREADS) {
        const int qq = i / spc, s = i - qq * spc, b = qt0 + qq;
        if (s >= ns || b >= B) continue;
        const size_t at = (size_t)b * NS + s0 + s;
        if (!((in.mask[s] >> qq) & 1ull)) {
          cnt[at] = 0;
          continue;
        }
        if (sparse) continue;  // written per pair below
        const unsigned long long vm = in.vmask[s];
        const float* v = S + qq * (RT + 1) + s * page_rows;
        float* out = scr + at * page_rows;
        int c = 0;
        for (int r = 0; r < page_rows; ++r) {
          const bool ok = (vm >> r) & 1ull;
          c += ok && v[r] >= sh.ch[qq];
          out[r] = ok ? v[r] : -CUDART_INF_F;
        }
        cnt[at] = c;
      }
      if (sparse) {
        for (int p = tid; p * page_rows < n_items; p += THREADS) {
          const int pv = sh.pair[p], s = pv >> 6, qq = pv & 63;
          const size_t at = (size_t)(qt0 + qq) * NS + s0 + s;
          const unsigned long long vm = in.vmask[s];
          const float* v = S + p * page_rows;
          float* out = scr + at * page_rows;
          int c = 0;
          for (int r = 0; r < page_rows; ++r) {
            const bool ok = (vm >> r) & 1ull;
            c += ok && v[r] >= sh.ch[qq];
            out[r] = ok ? v[r] : -CUDART_INF_F;
          }
          cnt[at] = c;
        }
      }
    }
    // stage `st`, the pair list and this entry's info are free; the stage's
    // generic reads and writes come before the bulk copies into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    e = e_n;
    sl = sl_n;
    st ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------ merge kernel

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

// Block-wide sum of v (MT threads); every thread gets the total.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long t = 0;
  for (int w = 0; w < MT / 32; ++w) t += red[w];
  return t;
}

// Block-wide exclusive scan of v in thread order (MT threads); *total gets
// the sum.
__device__ __forceinline__ long long block_excl(long long v, long long* red,
                                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();  // red is free
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  long long before = 0, all = 0;
  for (int w = 0; w < MT / 32; ++w) {
    if (w < warp) before += red[w];
    all += red[w];
  }
  *total = all;
  return before + incl - v;
}

// The radix digits, from the top of the key: 11, 11, 10 bits of the score,
// then 11, 11, 10 of the inverted position.
__device__ __forceinline__ int digit_shift(int pass) {
  return pass == 0 ? 53 : pass == 1 ? 42 : pass == 2 ? 32
       : pass == 3 ? 21 : pass == 4 ? 10 : 0;
}

constexpr int SCAN_U = 4;  // slots per thread and scan step
constexpr int KEY_U = 2;   // flags per lane in a window of 32 * KEY_U slots
constexpr int KEY_R = 4;   // entries per lane whose loads are in flight at once

struct MergeShared {
  long long red[MT / 32];
  long long part;      // this block's cnt sum over its slot range
  int n0;
  int cut, pages, cand;  // rank 0's are the cluster's
  int n_out;             // rank 0's: keys compacted so far
  int digit;
  unsigned long long above, in_digit;
  int cb_n, cb_over;     // the candidate buffer's fill, and whether it overflowed
  unsigned long long floor_key;  // the smallest carried key
  int wlist[MT / 32][32 * KEY_U];  // per warp: the selected slots of its window
};


// One cluster of CL blocks per query b = blockIdx.x / CL. Shared memory
// (dynamic): the radix histogram [HBINS], then SORT_CH keys that hold the
// block's candidates during the select and a chunk of keys in the sort.
__global__ void __launch_bounds__(MT, 1) bm_merge_kernel(
    const float* __restrict__ init_s, const int* __restrict__ init_r,
    const int* __restrict__ slots, const uint8_t* __restrict__ sel,
    const int* __restrict__ vcnt, const float* __restrict__ c_half,
    const int* __restrict__ cnt, const float* __restrict__ scr,
    float* __restrict__ top_s, int* __restrict__ top_r, int* __restrict__ pages,
    int* __restrict__ cand, unsigned long long* keys, int NS, int k,
    int page_rows, int kp2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem_raw);
  unsigned long long* sbuf =
      reinterpret_cast<unsigned long long*>(smem_raw + HBINS * sizeof(unsigned));
  __shared__ MergeShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  MergeShared* sh0 = cluster.map_shared_rank(&sh, 0);
  const float ch = c_half[b];
  const size_t row_b = (size_t)b * NS;
  if (tid == 0) sh.floor_key = ~0ull;
  __syncthreads();

  // ---- the Condition-A scan: carried hits, then cnt over the slots, each
  // block over its own range, its carry from the ranges before it
  const int lo = (int)((long long)NS * rank / CL);
  const int hi = (int)((long long)NS * (rank + 1) / CL);
  {
    long long n0 = 0, part = 0;
    unsigned long long low = ~0ull;  // the smallest carried key
#pragma unroll 8
    for (int i = tid; i < k; i += MT) {
      const float v = init_s[(size_t)b * k + i];
      n0 += v >= ch;
      low = min(low, merge_key(v, i));
    }
#pragma unroll 8
    for (int s = lo + tid; s < hi; s += MT) part += cnt[row_b + s];
    n0 = block_sum(n0, sh.red);
    part = block_sum(part, sh.red);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) low = min(low, __shfl_xor_sync(FULL, low, o));
    if (lane == 0) atomicMin(&sh.floor_key, low);
    if (tid == 0) {
      sh.n0 = (int)n0;
      sh.part = part;
      sh.cut = NS;
      sh.pages = 0;
      sh.cand = 0;
      sh.n_out = 0;
    }
  }
  cluster.sync();
  long long carry = sh.n0;
  for (int r = 0; r < rank; ++r) carry += cluster.map_shared_rank(&sh, r)->part;
  {
    int my_pages = 0, my_cut = NS;
    long long my_cand = 0;
    int base = lo;
    for (; base < hi && carry < k; base += SCAN_U * MT) {  // carry is block-uniform
      int c[SCAN_U], vc[SCAN_U];
      bool on[SCAN_U];
      long long mine = 0;
#pragma unroll
      for (int j = 0; j < SCAN_U; ++j) {  // every load of the step at once
        const int s = base + SCAN_U * tid + j;
        c[j] = s < hi ? cnt[row_b + s] : 0;
        on[j] = s < hi && sel[row_b + s];
        vc[j] = s < hi ? vcnt[s] : 0;
        mine += c[j];
      }
      long long total;
      long long run = carry + block_excl(mine, sh.red, &total);
#pragma unroll
      for (int j = 0; j < SCAN_U; ++j) {
        const int s = base + SCAN_U * tid + j;
        if (on[j]) {
          if (run < k) {
            my_pages += 1;
            my_cand += vc[j];
          } else {
            my_cut = min(my_cut, s);
          }
        }
        run += c[j];
      }
      carry += total;
    }
    // from where the scan stopped the carry is >= k: the first selected
    // slot there is the cut, unless the last step scanned held it
    for (; base < hi; base += MT) {
      const int s = base + tid;
      const bool hit = s < hi && sel[row_b + s];
      if (hit) my_cut = min(my_cut, s);
      if (__syncthreads_or(hit)) break;
    }
    my_pages = (int)block_sum(my_pages, sh.red);
    my_cand = block_sum(my_cand, sh.red);
    if (my_cut < NS) atomicMin(&sh0->cut, my_cut);
    if (tid == 0) {
      atomicAdd(&sh0->pages, my_pages);
      atomicAdd(&sh0->cand, (int)my_cand);
    }
  }
  cluster.sync();
  const int cut = sh0->cut;
  const long long n_keys = k + (long long)sh0->cand;  // carried + live rows
  // The k carried keys are candidates, so the k-th best key is at least the
  // smallest of them: a tile key below it cannot win and is not counted.
  const unsigned long long floor_key = sh.floor_key;
  const bool floored = (floor_key >> 32) > 0x007fffffull;  // a finite score
  if (rank == 0 && tid == 0) {
    pages[b] = sh.pages;
    cand[b] = sh.cand;
  }

  // ---- candidates: the k carried keys, then the live stored scores, from
  // device memory. Calls f(ok, key) for 32 entries per call of a whole warp
  // (ok = false and key 0 on the lanes without one); the loop bounds are
  // warp-uniform. Each lane has KEY_R entries' loads in flight.
  const int wid = rank * (MT / 32) + warp, wstep = CL * MT;
  const float inv_pr = 1.f / page_rows;
  auto gather = [&](auto f) {
    for (int i0 = wid * 32; i0 < k; i0 += wstep) {
      const int i = i0 + lane;
      f(i < k, i < k ? merge_key(init_s[(size_t)b * k + i], i) : 0ull);
    }
    // A warp takes windows of 32 * KEY_U slots; the selected slots of a
    // window are listed, and its lanes walk their (slot, row) entries.
    int* wl = sh.wlist[warp];
    bool nxt[KEY_U];  // the flags of the next window, loaded one ahead
#pragma unroll
    for (int j = 0; j < KEY_U; ++j) {
      const int s = wid * 32 * KEY_U + 32 * j + lane;
      nxt[j] = s < cut && sel[row_b + s];
    }
    for (int s0 = wid * 32 * KEY_U; s0 < cut; s0 += wstep * KEY_U) {
      int n_sel = 0;
#pragma unroll
      for (int j = 0; j < KEY_U; ++j) {
        const unsigned m = __ballot_sync(FULL, nxt[j]);
        if (nxt[j]) wl[n_sel + __popc(m & ((1u << lane) - 1u))] = s0 + 32 * j + lane;
        n_sel += __popc(m);
        const int s = s0 + wstep * KEY_U + 32 * j + lane;
        nxt[j] = s < cut && sel[row_b + s];
      }
      __syncwarp();
      const int n_ent = n_sel * page_rows;
      for (int t0 = 0; t0 < n_ent; t0 += 32 * KEY_R) {
        float v[KEY_R];
        int pos[KEY_R];
#pragma unroll
        for (int g = 0; g < KEY_R; ++g) {
          const int t = t0 + 32 * g + lane;
          v[g] = -CUDART_INF_F;
          pos[g] = 0;
          if (t < n_ent) {
            int e_i = (int)((float)t * inv_pr);  // t / page_rows, t < 4096
            e_i -= e_i * page_rows > t;
            e_i += (e_i + 1) * page_rows <= t;
            const int sl = wl[e_i], r = t - e_i * page_rows;
            v[g] = scr[(row_b + sl) * page_rows + r];
            pos[g] = k + sl * page_rows + r;
          }
        }
#pragma unroll
        for (int g = 0; g < KEY_R; ++g) {
          if (t0 + 32 * g >= n_ent) break;  // warp-uniform
          const unsigned long long key = merge_key(v[g], pos[g]);
          const bool ok = v[g] > -CUDART_INF_F && key >= floor_key;
          f(ok, ok ? key : 0ull);
        }
      }
      __syncwarp();  // the list is rewritten by the next window
    }
  };
  // The same entries from the block's candidate buffer, once it holds them.
  bool buffered = false;  // block-uniform
  auto for_each_key = [&](auto f) {
    if (!buffered) {
      gather(f);
      return;
    }
    const int n = sh.cb_n;
    for (int i0 = warp * 32; i0 < n; i0 += MT) {
      const int i = i0 + lane;
      f(i < n, i < n ? sbuf[i] : 0ull);
    }
  };

  // ---- radix select of the k-th key: fix its digits from the top until
  // every key that shares the prefix found so far is taken. While a block
  // reads device memory it also keeps its keys at or above the prefix in
  // shared memory; once they fit, its later passes read only them.
  unsigned long long prefix = 0ull;
  long long rem = k;
  int shift = 64;
  for (int pass = 0; pass < 6; ++pass) {
    const int top = shift;
    shift = digit_shift(pass);
    const unsigned long long hi_mask = top == 64 ? 0ull : ~0ull << top;
    const unsigned dmask = (1u << (top - shift)) - 1u;
    for (int i = tid; i < HBINS; i += MT) hist[i] = 0u;
    // keep the keys in shared memory unless they cannot fit (pass 0 with
    // more live candidates than the cluster's buffers hold and no floor)
    const bool keep = !buffered && (pass > 0 || floored ||
                                    n_keys <= (long long)CL * SORT_CH);
    if (keep && tid == 0) {
      sh.cb_n = 0;
      sh.cb_over = 0;
    }
    __syncthreads();
    unsigned cbin = 0u, ccnt = 0u;  // a run of one digit, added at its end
    for_each_key([&](bool ok, unsigned long long key) {
      if (ok && (key & hi_mask) == prefix) {
        const unsigned dg = (unsigned)(key >> shift) & dmask;
        if (dg != cbin) {
          if (ccnt) atomicAdd(&hist[cbin], ccnt);
          cbin = dg;
          ccnt = 0u;
        }
        ++ccnt;
      }
      if (keep && !*reinterpret_cast<volatile int*>(&sh.cb_over)) {
        const bool take = ok && (key & hi_mask) >= prefix;
        const unsigned m = __ballot_sync(FULL, take);
        if (m) {
          const int leader = __ffs(m) - 1;
          int at = 0;
          if (lane == leader) at = atomicAdd(&sh.cb_n, __popc(m));
          at = __shfl_sync(FULL, at, leader) + __popc(m & ((1u << lane) - 1u));
          if (take && at < SORT_CH) sbuf[at] = key;
          if (lane == leader && at + __popc(m) > SORT_CH) sh.cb_over = 1;
        }
      }
    });
    if (ccnt) atomicAdd(&hist[cbin], ccnt);
    cluster.sync();  // every block's histogram is complete
    const bool fits = keep && !sh.cb_over;
    // the cluster's histogram, digits in descending order, 4 per thread
    long long tot[4], mine = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dg = HBINS - 1 - (4 * tid + j);
      long long t = 0;
      for (int r = 0; r < CL; ++r) t += cluster.map_shared_rank(hist, r)[dg];
      tot[j] = t;
      mine += t;
    }
    long long all;
    long long above = block_excl(mine, sh.red, &all);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (above < rem && above + tot[j] >= rem) {
        sh.digit = HBINS - 1 - (4 * tid + j);
        sh.above = (unsigned long long)above;
        sh.in_digit = (unsigned long long)tot[j];
      }
      above += tot[j];
    }
    cluster.sync();  // the histograms are read; the digit is known
    if (fits) buffered = true;
    prefix |= (unsigned long long)sh.digit << shift;
    rem -= (long long)sh.above;
    if ((long long)sh.in_digit == rem) break;  // cluster-uniform
  }

  // ---- compaction: the k keys at or above the k-th, into keys[b]
  // (kp2 wide, zero-filled past k)
  unsigned long long* kb = keys + (size_t)b * kp2;
  const unsigned long long cut_key = prefix >> shift;
  for_each_key([&](bool ok, unsigned long long key) {
    const bool win = ok && (key >> shift) >= cut_key;
    const unsigned m = __ballot_sync(FULL, win);
    if (!m) return;
    const int leader = __ffs(m) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(&sh0->n_out, __popc(m));
    at = __shfl_sync(FULL, at, leader) + __popc(m & ((1u << lane) - 1u));
    if (win && at < k) __stcg(kb + at, key);
  });
  for (int i = k + rank * MT + tid; i < kp2; i += wstep) __stcg(kb + i, 0ull);
  __threadfence();
  cluster.sync();

  // ---- bitonic sort of keys[b] ascending: chunks of CH keys in shared
  // memory, the strides of CH and more across the cluster in device memory
  const int n = kp2, CH = min(n, SORT_CH), nch = n / CH;
  auto cmp_swap = [](unsigned long long* a, int lo, int hi, bool up) {
    const unsigned long long u = a[lo], w = a[hi];
    if ((u > w) == up) {
      a[lo] = w;
      a[hi] = u;
    }
  };
  auto local_sort = [&](int size_from, int size_to, int stride_from) {
    for (int c = rank; c < nch; c += CL) {
      unsigned long long* g = kb + (size_t)c * CH;
      for (int i = tid; i < CH; i += MT) sbuf[i] = __ldcg(g + i);
      __syncthreads();
      // A stage of stride <= 32 keeps each warp inside its own runs of 64
      // keys (i ranges over 32 consecutive pairs): a warp barrier is enough
      // between two such stages.
      for (int size = size_from; size <= size_to; size <<= 1)
        for (int stride = min(size >> 1, stride_from); stride > 0; stride >>= 1) {
          for (int i = tid; i < CH / 2; i += MT) {
            const int lo = 2 * i - (i & (stride - 1));
            cmp_swap(sbuf, lo, lo + stride, ((c * CH + lo) & size) == 0);
          }
          const int next = stride > 1 ? stride >> 1 : size;
          if (stride > 32 || next > 32 || (size == size_to && stride == 1))
            __syncthreads();
          else
            __syncwarp();
        }
      for (int i = tid; i < CH; i += MT) __stcg(g + i, sbuf[i]);
      __syncthreads();
    }
    __threadfence();
    cluster.sync();
  };
  local_sort(2, CH, CH);
  for (int size = 2 * CH; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= CH; stride >>= 1) {
      for (int i = rank * MT + tid; i < n / 2; i += wstep) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long u = __ldcg(kb + lo), w = __ldcg(kb + hi);
        if ((u > w) == ((lo & size) == 0)) {
          __stcg(kb + lo, w);
          __stcg(kb + hi, u);
        }
      }
      __threadfence();
      cluster.sync();
    }
    local_sort(size, size, CH >> 1);
  }

  // ---- the top k, from the top of the sorted keys
  for (int i = rank * MT + tid; i < k; i += wstep) {
    const unsigned long long key = __ldcg(kb + n - 1 - i);
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

// How many clusters of 1, 2, 4 and 8 blocks of the merge kernel (with
// `smem` bytes of dynamic shared memory, set on the kernel already) fit on
// the current device at once; looked up once per device.
cudaError_t merge_cluster_room(int smem, int room[4]) {
  static std::mutex mu;
  static int known[LAUNCH_CACHE_DEVICES][4];
  static bool done[LAUNCH_CACHE_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= LAUNCH_CACHE_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    for (int i = 0; i < 4; ++i) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1 << i);
      cfg.blockDim = dim3(MT);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1 << i;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(
          &known[dev][i], reinterpret_cast<const void*>(bm_merge_kernel), &cfg);
      if (err != cudaSuccess) return err;
    }
    done[dev] = true;
  }
  for (int i = 0; i < 4; ++i) room[i] = known[dev][i];
  return cudaSuccess;
}

// Where the launcher keeps its small scratch in `work`: the plan's masks
// (q_tiles, NS) u64, vmask (NS,) u64, the chunk lists (q_tiles, n_chunks)
// i32, vcnt (NS,) i32 and the list lengths (q_tiles,) i32.
struct WorkLayout {
  size_t masks, vmask, list, vcnt, count, total;
};

WorkLayout work_layout(int B, int NS, int page_rows) {
  const size_t q_tiles = (B + QT - 1) / QT, spc = RT / page_rows;
  const size_t n_chunks = (NS + spc - 1) / spc;
  WorkLayout w;
  w.masks = 0;
  w.vmask = w.masks + 8 * q_tiles * NS;
  w.list = w.vmask + 8 * (size_t)NS;
  w.vcnt = w.list + 4 * q_tiles * n_chunks;
  w.count = w.vcnt + 4 * (size_t)NS;
  w.total = w.count + 4 * q_tiles;
  return w;
}

}  // namespace

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of the `work` scratch that block_mips_launch needs at (B, NS,
// page_rows); -1 for shapes it does not take.
extern "C" long long block_mips_work_bytes(int B, int NS, int page_rows) {
  if (B < 1 || NS < 1 || page_rows < 1 || page_rows > RT) return -1;
  return static_cast<long long>(work_layout(B, NS, page_rows).total);
}

// Launches the round on `stream`: a memset of the list lengths, then the
// plan, score and merge kernels. Scratch: scr (B, NS, page_rows) f32, keys
// (B, kp2) u64 with kp2 the next power of two >= k, and `work`
// (block_mips_work_bytes). Returns the first launch error, or 0.
extern "C" int block_mips_launch(
    const float* x, const uint8_t* valid, const float* q, const int* slots,
    const uint8_t* sel, const float* init_s, const int* init_r,
    const float* c_half, float* top_s, int* top_r, int* cnt, int* pages,
    int* cand, float* scr, unsigned long long* keys, void* work, int B, int d,
    int NS, int k, int page_rows, int kp2, long long work_bytes,
    void* stream_handle) {
  if (B < 1 || d < 1 || NS < 1 || k < 1 || page_rows < 1 || page_rows > RT ||
      (B + QT - 1) / QT > 65535 || kp2 < k || (kp2 & (kp2 - 1)) != 0 ||
      kp2 >= 2 * k || (long long)NS * page_rows + k > 0x7fffffffLL ||
      (long long)B * CL_MAX > 0x7fffffffLL ||
      work_bytes < (long long)work_layout(B, NS, page_rows).total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const WorkLayout w = work_layout(B, NS, page_rows);
  char* wb = static_cast<char*>(work);
  auto* masks = reinterpret_cast<unsigned long long*>(wb + w.masks);
  auto* vmask = reinterpret_cast<unsigned long long*>(wb + w.vmask);
  int* list = reinterpret_cast<int*>(wb + w.list);
  int* vcnt = reinterpret_cast<int*>(wb + w.vcnt);
  int* count = reinterpret_cast<int*>(wb + w.count);
  const int spc = RT / page_rows, n_chunks = (NS + spc - 1) / spc;
  const int q_tiles = (B + QT - 1) / QT, dq32 = (d + 31) & ~31;

  // plan: one thread per slot
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * q_tiles, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cpb = THREADS / spc;
  bm_plan_kernel<<<dim3((n_chunks + cpb - 1) / cpb, q_tiles), THREADS, 0, stream>>>(
      sel, slots, valid, masks, vmask, vcnt, cnt, list, count, B, NS,
      page_rows, spc, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // score: a persistent grid of the blocks that fit at once
  const bool q_res = (long long)QT * dq32 * 4 <= Q_RES_BYTES;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int smem = ((q_res ? QT * dq32 : 0) + 2 * (RT + (q_res ? 0 : QT)) * XS) * 4;
  static LaunchCache score_cache;
  int resident = 0;
  err = resident_blocks(score_cache, bm_score_kernel, THREADS, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_tile = resident / q_tiles > 1 ? resident / q_tiles : 1;
  const dim3 grid(per_tile < n_chunks ? per_tile : n_chunks, q_tiles);
  bm_score_kernel<<<grid, THREADS, smem, stream>>>(
      x, q, slots, c_half, masks, vmask, list, count, cnt, scr, B, d, NS,
      page_rows, spc, n_chunks, q_res, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // merge: one cluster per query, of the most blocks (8, 4, 2 or 1) with
  // which all B clusters are resident at once
  const int merge_smem = HBINS * 4 + SORT_CH * 8;
  static LaunchCache merge_cache;
  err = resident_blocks(merge_cache, bm_merge_kernel, MT, merge_smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  int room[4];
  err = merge_cluster_room(merge_smem, room);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cl = CL_MAX;
  while (cl > 1 && room[__builtin_ctz(cl)] < B) cl /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cl);
  cfg.blockDim = dim3(MT);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bm_merge_kernel, init_s, init_r, slots, sel,
                           static_cast<const int*>(vcnt), c_half,
                           static_cast<const int*>(cnt),
                           static_cast<const float*>(scr), top_s, top_r, pages,
                           cand, keys, NS, k, page_rows, kp2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
