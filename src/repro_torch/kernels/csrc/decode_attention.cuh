// The `decode_attention` kernel's template, shared by its two translation
// units (decode_attention.cu: the f32 instances and the C interface;
// decode_attention_bf16.cu: the bf16 instances).
//
// One-token GQA attention against a KV cache on Hopper (sm_90a), in one
// launch:
//   out[b, kh, g] = softmax_t(<q[b, kh, g], k[b, t, kh]> / sqrt(dh)) . v[b, t, kh]
// over t < cache_len[b]; positions at or beyond it are masked, so
// cache_len = 0 gives the mean of V over all S positions. On request the
// kernel also writes each query row's log-sum-exp of its scaled scores,
//   lse[b, kh, g] = log sum_t exp(<q[b, kh, g], k[b, t, kh]> / sqrt(dh)),
// -inf where cache_len <= 0: the weight of a piece of the sequence when the
// pieces that ranks attend apart are merged (a row with no position of its
// own weighs exactly 0).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`): a grid (B, KH, S/bS) that walks S in order and carries the
// online-softmax state (m, l, acc) in VMEM from one grid step to the next.
// Like it, the kernel takes q/k/v in f32 or bf16 and computes in f32 inside;
// the output is in q's dtype. Its runtime mirror is
// `models/attention.py::flash_decode`, which every layer of every decode step
// calls.
//
// What bounds it: each (b, kh) pair reads its cache rows below cache_len once
// (2 * n_b * dh elements of K and V, 4 or 2 bytes each) and does 4 * dh
// operations per (position, query row); with G = 8 query rows per KV head that
// is 4 (f32) or 8 (bf16) flops per byte read, far below the card's 20 fp32
// flops per byte: bound by bytes.
//
// What the design does about it:
//  * Any head width dh that is a multiple of 8 up to 128. The geometry is in
//    16-byte chunks (4 f32 or 8 bf16 elements); a row of dh elements is laid
//    out in shared memory at a padded width DHP (a power-of-two chunk count
//    C, so 32 / 64 / 128 for f32 and 64 / 128 for bf16), and its chunks past
//    dh are zero-filled by cp.async without a global read. A zero chunk adds
//    exactly 0 to every score and its output columns are never written, so
//    dh 120 runs the dh 128 geometry at the cost of the padded columns'
//    arithmetic only.
//  * Work in proportion to the cached rows, split evenly. A row is (b, kh,
//    group of up to 8 query rows); its tiles cover [0, min(cache_len, S)).
//    Every CTA of a persistent grid (as many as fit the card, at most the
//    tiles the shapes allow) derives the tile sequence from cache_len on the
//    device (a prefix sum over B in shared memory) and takes one contiguous
//    range of it, the same number of tiles for every CTA to within one. A
//    range may hold the end of one row, whole rows and the start of another:
//    each (row, CTA) piece is a segment. Positions at or past cache_len are
//    never read: a ragged tile's tail is zero-filled by cp.async.
//  * Pipelined tiles. A tile is 16 KB of K and 16 KB of V (1024 chunks,
//    1024 / C positions); a ring of STAGES tiles is filled by 16-byte
//    cp.async.cg copies, two tiles ahead, across segment boundaries, so a
//    segment's epilogue runs while the next segment's first tiles load. K is
//    stored row-major with its chunks XOR-swizzled by position, which makes
//    the score reads conflict-free; V is read along rows and needs none.
//  * Shared memory read once per tile. All query rows of a row share the
//    tile: for the scores a thread holds one position x JQ chunks x all of
//    them (q broadcast from shared memory) and the partial dots are
//    reduce-scattered over the position's lanes; for P.V a thread holds one
//    column quad (4 elements) x up to 4 rows for a fixed set of positions,
//    reading the probabilities from shared memory (16 accumulators, so two
//    CTAs fit an SM at 128 registers without a spill). bf16 elements are
//    widened to f32 as they are read; fp32 fmaf and expf throughout (no
//    TF32, no tensor cores).
//  * One launch. A segment that is a whole row writes its output; any other
//    writes a partial (m, l, acc) to slot row + CTA (unique: along the tile
//    sequence either the row or the CTA advances), and the CTA that
//    finishes a row's last segment (a ticket per row, atomicAdd after a
//    __threadfence) merges the row's partials in CTA order and resets the
//    ticket for the next call. Every sum runs in an order fixed by the
//    shapes, cache_len and the grid, so two calls on the same input are
//    equal bit for bit, and the launcher keeps no state that depends on
//    device values, so a CUDA graph can capture it.
//  * The log-sum-exp on request: a second instance of the kernel (template
//    flag LSE) writes m + log(l) where the row's output is written, on the
//    same grid. It writes the output in f32 whatever the input dtype (the
//    pieces of a split sequence are merged before the one rounding to q's
//    dtype); rounded to q's dtype it equals the call without it bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "launch_cache.cuh"

namespace da {


constexpr int NT = 256;             // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int STAGES = 3;           // tiles in the cp.async ring
constexpr int AHEAD = STAGES - 1;   // tiles in flight ahead of the one computed
constexpr int QBUF = STAGES;        // q buffers: segments live at once at most
constexpr int TILE_FLOATS = 4096;   // 16 KB: one K (or V) tile
constexpr int TILE_CHUNKS = TILE_FLOATS / 4;  // 16-byte chunks of a tile
constexpr int GROUP_MAX = 8;        // query rows per row at most
constexpr int B_MAX = 4096;         // sequences (the prefix sum is in shared memory)
constexpr int DH_MAX = 128;
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

// An element type's 16-byte chunk (EPC elements) and its reads and writes
// as f32.
template <class E>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int EPC = 4;
  __device__ __forceinline__ static void chunk(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ __forceinline__ static float4 quad(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void store_quad(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
};

__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

template <>
struct Elem<bf16> {
  static constexpr int EPC = 8;
  __device__ __forceinline__ static void chunk(const bf16* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = lo_bf16(v.x); x[1] = hi_bf16(v.x);
    x[2] = lo_bf16(v.y); x[3] = hi_bf16(v.y);
    x[4] = lo_bf16(v.z); x[5] = hi_bf16(v.z);
    x[6] = lo_bf16(v.w); x[7] = hi_bf16(v.w);
  }
  __device__ __forceinline__ static float4 quad(const bf16* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_float4(lo_bf16(v.x), hi_bf16(v.x), lo_bf16(v.y), hi_bf16(v.y));
  }
  __device__ __forceinline__ static void store_quad(bf16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  __device__ __forceinline__ static void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// The tile geometry of rows of C 16-byte chunks.
template <int C>
struct Geo {
  static constexpr int T = TILE_CHUNKS / C;   // positions per tile: 128, 64, 32
  static constexpr int DQ = NT / T;           // score lanes per position: 2, 4, 8
  static constexpr int JQ = C / DQ;           // chunks per score lane: 4
  static constexpr int R = 8 / DQ;            // positions per quarter warp
  static constexpr int LQ = NT / C;           // loader rows per pass
  static constexpr int LP = T / LQ;           // loader passes: 4
  static_assert(LQ % R == 0, "the loader's swizzle must not depend on its pass");
};

// The P.V split of a tile over the CTA: a thread holds one column quad (4
// elements; U quads a padded row) x GR query rows (the rows cut in RS sets,
// so that a thread holds at most 16 accumulators) for PP positions, one of
// PQ position groups.
template <int T, int U, int GB>
struct PvGeo {
  static constexpr int RS = GB >= 4 ? GB / 4 : 1;
  static constexpr int GR = GB / RS;
  static constexpr int PQ = NT / (U * RS);
  static constexpr int PP = T / PQ;
};

// Shared-memory layout in floats. One ring slot is free while its tile's
// segment ends (the loader is AHEAD tiles ahead), so the epilogue reduces
// through it.
template <int C, int DHP, int GB>
struct Smem {
  static constexpr int RING = STAGES * 2 * TILE_FLOATS;
  static constexpr int Q = RING;                              // QBUF * GB rows of C chunks
  static constexpr int S = Q + QBUF * GB * C * 4;             // T * GB scores
  static constexpr int WMAX = S + Geo<C>::T * GB;             // NWARPS * GB
  static constexpr int MBUF = WMAX + NWARPS * GB;             // 2 * GB
  static constexpr int ALPHA = MBUF + 2 * GB;                 // GB
  static constexpr int LS = ALPHA + GB;                       // GB
  static constexpr int RED_L = LS + GB;                       // NT
  static constexpr int INTS = RED_L + NT;                     // 2 B + 2 ints
  static_assert(PvGeo<Geo<C>::T, DHP / 4, GB>::PQ * GB * DHP <= 2 * TILE_FLOATS,
                "reduction exceeds a ring slot");
  static size_t bytes(int B) { return sizeof(float) * (size_t)INTS + sizeof(int) * (2 * B + 2); }
};

struct Params {
  const void* q;        // (B, KH, G, dh)
  const void* k;        // (B, S, KH, dh)
  const void* v;        // (B, S, KH, dh)
  const int* lens;      // (B,)
  float* part_acc;      // (slots, GB, DHP)
  float* part_ml;       // (slots, 2, GB): m then l
  int* tickets;         // (rows,), zero between calls
  void* out;            // (B, KH, G, dh): q's dtype, f32 with the log-sum-exp
  float* lse;           // (B, KH, G) or null
  int B, S, KH, G, n_rg;
  int dh, cr;           // the head width and its 16-byte chunks
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: no global read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum the N partial dots in `sc` over the DQ lanes of a position. While
// N > 1 each step halves the rows a lane keeps (the lane with bit LVL set
// keeps the upper half; `rbase` tracks the first kept row); once a lane
// keeps one row the remaining steps all-reduce it. Either way every kept
// row ends as the same sum in every lane that keeps it.
template <int N, int LVL, int DQ>
__device__ __forceinline__ void reduce_scatter(float* sc, int dq, int& rbase) {
  if constexpr (LVL < DQ) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (dq & LVL) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? sc[i] : sc[i + H];
        const float keep = up ? sc[i + H] : sc[i];
        sc[i] = keep + __shfl_xor_sync(FULL, send, LVL);
      }
      if (up) rbase += H;
      reduce_scatter<H, LVL * 2, DQ>(sc, dq, rbase);
    } else {
      sc[0] += __shfl_xor_sync(FULL, sc[0], LVL);
      reduce_scatter<1, LVL * 2, DQ>(sc, dq, rbase);
    }
  }
}

// A position in the tile sequence: sequence b, row rloc of b (kh * n_rg +
// row group), tile t of the row, which has nt tiles.
struct Cursor {
  int b, rloc, t, nt;
  __device__ __forceinline__ void advance(const int* offs, int rows_b) {
    if (++t < nt) return;
    t = 0;
    if (++rloc < rows_b) return;
    rloc = 0;
    ++b;
    nt = (offs[b + 1] - offs[b]) / rows_b;
  }
};

// CTAs an SM an instance is built for: two (at most 128 registers a
// thread) but where that spills. The log-sum-exp epilogue needs a register
// more than 128 where GB is 8, and the f32 rows of 8 chunks (dh up to 32)
// with 2 query rows a group spill 4 bytes at 128 (no config's full width
// has dh 32): those instances run one CTA an SM, on the grid of the kernel
// without the log-sum-exp (the same tiles, so the same output bit for bit).
template <class E, int C, int GB, bool LSE>
constexpr int min_blocks() {
  return (LSE && GB == 8) || (sizeof(E) == 4 && C == 8 && GB == 2) ? 1 : 2;
}

// E: the input element type; C: 16-byte chunks of a padded row; GB: query
// rows of a row; LSE: write each row's log-sum-exp too, and the output in
// f32.
template <class E, int C, int GB, bool LSE>
__global__ void __launch_bounds__(NT, (min_blocks<E, C, GB, LSE>())) da_kernel(const Params p) {
  using Gm = Geo<C>;
  using El = Elem<E>;
  using O = typename std::conditional<LSE, float, E>::type;
  constexpr int EPC = El::EPC, DHP = C * EPC, U = DHP / 4;
  using Sm = Smem<C, DHP, GB>;
  using Pv = PvGeo<Gm::T, U, GB>;
  constexpr int T = Gm::T, DQ = Gm::DQ, JQ = Gm::JQ, R = Gm::R;
  constexpr int LQ = Gm::LQ, LP = Gm::LP;
  constexpr int RS = Pv::RS, GR = Pv::GR, PQ = Pv::PQ, PP = Pv::PP;
  constexpr int NOWN = GB >= DQ ? GB / DQ : 1;  // rows a score lane keeps
  extern __shared__ __align__(16) float smem[];
  float* s_s = smem + Sm::S;        // [t][g]: scores, then probabilities
  float* wmax = smem + Sm::WMAX;    // [warp][g]: the tile's max per warp
  float* m_buf = smem + Sm::MBUF;   // [2][g]: the running max, double-buffered
  float* alpha_s = smem + Sm::ALPHA;
  float* l_s = smem + Sm::LS;
  float* red_l = smem + Sm::RED_L;
  int* offs = reinterpret_cast<int*>(smem + Sm::INTS);  // B + 1 tile offsets
  int* nlen = offs + p.B + 1;                            // B cached rows per sequence
  int* last_flag = nlen + p.B;
  // the pointers and dh are read from the parameters where they are used:
  // held in registers across the loop they spill the f32 instances

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_b = p.KH * p.n_rg;  // rows per sequence

  // -- the tile sequence: sequence b owns tiles [offs[b], offs[b + 1])
  for (int b = tid; b < p.B; b += NT) {
    const int len = p.lens[b];
    const int n = (len <= 0 || len > p.S) ? p.S : len;
    nlen[b] = len <= 0 ? -n : n;  // negative: every score is equal (cache_len <= 0)
    offs[b + 1] = (n + T - 1) / T * rows_b;
  }
  if (tid == 0) offs[0] = 0;
  __syncthreads();
  if (warp == 0) {
    const int per = (p.B + 31) / 32;
    const int lo = 1 + lane * per, hi = min(lo + per, p.B + 1);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += offs[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int i = lo; i < hi; ++i) {
      run += offs[i];
      offs[i] = run;
    }
  }
  __syncthreads();
  // every CTA below `grid` gets at least one tile, so the CTAs that share a
  // row are consecutive and all write partials
  const long long total = offs[p.B];
  const int grid = (int)min((long long)gridDim.x, total);
  if ((int)blockIdx.x >= grid) return;  // uniform over the CTA
  const int g_lo = (int)(total * blockIdx.x / grid);
  const int steps = (int)(total * (blockIdx.x + 1) / grid) - g_lo;
  // the CTA whose range holds tile g
  auto cta_of = [&](long long g) { return (int)(((g + 1) * grid - 1) / total); };

  Cursor cur;  // the tile computed
  {
    int lo = 0, hi = p.B;  // offs[lo] <= g_lo < offs[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offs[mid] <= g_lo) lo = mid; else hi = mid;
    }
    cur.b = lo;
    cur.nt = (offs[lo + 1] - offs[lo]) / rows_b;
    const int local = g_lo - offs[lo];
    cur.rloc = local / cur.nt;
    cur.t = local % cur.nt;
  }
  // loader rows lq + i * LQ and chunk lc (none past dh: zero-filled)
  const int lq = tid / C, lc = tid % C;
  const int ld_soff = 4 * (lq * C + (lc ^ ((lq % R) * DQ)));  // swizzled K chunk, in floats
  const size_t pos_stride = (size_t)p.KH * p.dh;

  // load tile `step` at cursor `ld`, the start of segment `ls` or inside it
  auto load_tile = [&](int step, const Cursor& ld, int ls) {
    const int slot = step % STAGES;
    float* ks = smem + slot * 2 * TILE_FLOATS;
    float* vs = ks + TILE_FLOATS;
    const int kh = ld.rloc / p.n_rg;
    const int n = abs(nlen[ld.b]);
    const int t0 = ld.t * T;
    const int nv = min(T, n - t0);
    const size_t base = ((size_t)ld.b * p.S + t0 + lq) * pos_stride + (size_t)kh * p.dh + EPC * lc;
    const int nvl = lc < p.cr ? nv : 0;  // a padding chunk: no row is read
#pragma unroll
    for (int i = 0; i < LP; ++i) {
      const int r = lq + i * LQ;
      const bool ok = r < nvl;
      const size_t off = ok ? base + (size_t)i * LQ * pos_stride : 0;
      cp_async16(ks + ld_soff + i * LQ * C * 4, static_cast<const E*>(p.k) + off, ok);
      cp_async16(vs + 4 * (r * C + lc), static_cast<const E*>(p.v) + off, ok);
    }
    if (ld.t == 0 || step == 0) {  // a segment starts: its query rows
      float* qs = smem + Sm::Q + (ls % QBUF) * GB * C * 4;
      const int g0 = (ld.rloc % p.n_rg) * GB;
      const int gn = min(GB, p.G - g0);
      const E* q_g = static_cast<const E*>(p.q);
      const E* qrow = q_g + (((size_t)ld.b * p.KH + kh) * p.G + g0) * p.dh;
      for (int i = tid; i < GB * C; i += NT) {
        const int row = i / C, ch = i % C;
        const bool ok = row < gn && ch < p.cr;
        cp_async16(qs + 4 * i, ok ? qrow + row * p.dh + EPC * ch : q_g, ok);
      }
    }
  };
  {
    Cursor ld = cur;
    int ls = 0;
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      if (s < steps) {
        if (s > 0) {
          ld.advance(offs, rows_b);
          ls += ld.t == 0;
        }
        load_tile(s, ld, ls);
      }
      cp_async_commit();
    }
  }

  // score lanes: position sp of the tile, depth lane dq
  const int sp = tid / DQ, dq = tid % DQ;
  const int swz = (sp % R) * DQ;
  const int eg = tid % GB;  // the query row of this thread's probabilities
  // P.V: position group pq, column quad dc, query rows gh * GR ...
  const int gh = tid % RS, dc = tid / RS % U, pq = tid / (RS * U);
  float acc[GR][4];  // zero at every segment's start (reset by the epilogue)
#pragma unroll
  for (int g = 0; g < GR; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  float lsum = 0.f;
  int seg = -1;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // tile `step` landed; the previous tile is consumed
    const bool first = cur.t == 0 || step == 0;
    const bool last = cur.t == cur.nt - 1 || step == steps - 1;
    if (first) ++seg;
    if (step + AHEAD < steps) {  // the loader's cursor and segment, AHEAD tiles on
      Cursor ld = cur;
      int ls = seg;
#pragma unroll
      for (int j = 0; j < AHEAD; ++j) {
        ld.advance(offs, rows_b);
        ls += ld.t == 0;
      }
      load_tile(step + AHEAD, ld, ls);
    }
    cp_async_commit();
    const int slot = step % STAGES;
    const float* ks = smem + slot * 2 * TILE_FLOATS;
    const E* vs = reinterpret_cast<const E*>(ks + TILE_FLOATS);
    const float* q_s = smem + Sm::Q + (seg % QBUF) * GB * C * 4;
    const int n = nlen[cur.b];
    const int nv = min(T, abs(n) - cur.t * T);
    const float qscale = n < 0 ? 0.f : p.scale;  // cache_len <= 0: equal scores

    // -- scores of position sp for all GB rows over this lane's chunks
    float sc[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) sc[g] = 0.f;
    const float* kr = ks + sp * C * 4;
#pragma unroll
    for (int jj = 0; jj < JQ; ++jj) {
      const int c = jj * DQ + dq;
      float kv[EPC];
      El::chunk(reinterpret_cast<const E*>(kr + 4 * (c ^ swz)), kv);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float qv[EPC];
        El::chunk(reinterpret_cast<const E*>(q_s + 4 * (g * C + c)), qv);
#pragma unroll
        for (int e = 0; e < EPC; ++e) sc[g] = fmaf(qv[e], kv[e], sc[g]);
      }
    }
    int rbase = 0;
    reduce_scatter<GB, 1, DQ>(sc, dq, rbase);
    float mx[NOWN];
#pragma unroll
    for (int i = 0; i < NOWN; ++i) {
      // a zero-filled position past cache_len is masked
      sc[i] = sp < nv ? sc[i] * qscale : -INFINITY;
      mx[i] = sc[i];
    }
#pragma unroll
    for (int o = DQ; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < NOWN; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], o));
    if (dq < GB) {
#pragma unroll
      for (int i = 0; i < NOWN; ++i) {
        s_s[sp * GB + rbase + i] = sc[i];
        if (lane < DQ) wmax[warp * GB + rbase + i] = mx[i];
      }
    }
    __syncthreads();

    // -- online softmax: the new max, the rescale, the probabilities
    {
      const float m_old = first ? -INFINITY : m_buf[(step & 1) * GB + eg];
      float m_new = m_old;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) m_new = fmaxf(m_new, wmax[w * GB + eg]);
      const float alpha = expf(m_old - m_new);  // 0 on a segment's first tile
      float ps = 0.f;
      for (int e = tid; e < T * GB; e += NT) {
        const float pe = expf(s_s[e] - m_new);
        s_s[e] = pe;
        ps += pe;
      }
      lsum = fmaf(alpha, lsum, ps);
      if (tid < GB) {
        m_buf[((step + 1) & 1) * GB + tid] = m_new;
        alpha_s[tid] = alpha;
      }
    }
    __syncthreads();

    // -- P.V for this thread's column quad and rows over its positions
    {
      float a[GR];
      bool rescale = false;
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        a[g] = alpha_s[gh * GR + g];
        rescale |= a[g] != 1.f;
      }
      if (rescale) {
#pragma unroll
        for (int g = 0; g < GR; ++g)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][c] *= a[g];
      }
#pragma unroll 2  // fully unrolled, the GB = 8 kernels spill at 128 registers
      for (int i = 0; i < PP; ++i) {
        const int t = pq + i * PQ;
        const float4 vv = El::quad(vs + t * DHP + 4 * dc);
        float pr[GR];
        if constexpr (GR == 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(s_s + t * GB + gh * GR);
          pr[0] = p4.x; pr[1] = p4.y; pr[2] = p4.z; pr[3] = p4.w;
        } else {
#pragma unroll
          for (int g = 0; g < GR; ++g) pr[g] = s_s[t * GB + g];
        }
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          acc[g][0] = fmaf(pr[g], vv.x, acc[g][0]);
          acc[g][1] = fmaf(pr[g], vv.y, acc[g][1]);
          acc[g][2] = fmaf(pr[g], vv.z, acc[g][2]);
          acc[g][3] = fmaf(pr[g], vv.w, acc[g][3]);
        }
      }
    }

    if (last) {
      // -- the segment ends: reduce over the P.V position groups through
      // this tile's ring slot (the loader refills it only after the next
      // step's barrier) and over the softmax sums
      __syncthreads();  // every thread is done with the slot's V
      float* red = smem + slot * 2 * TILE_FLOATS;
#pragma unroll
      for (int g = 0; g < GR; ++g)
        *reinterpret_cast<float4*>(red + (pq * GB + gh * GR + g) * DHP + 4 * dc) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      red_l[tid] = lsum;
#pragma unroll
      for (int g = 0; g < GR; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
      lsum = 0.f;
      __syncthreads();
      if (tid < GB) {
        float l = 0.f;
        for (int i = tid; i < NT; i += GB) l += red_l[i];
        l_s[tid] = l;
      }
      __syncthreads();
      const int kh = cur.rloc / p.n_rg, g0 = (cur.rloc % p.n_rg) * GB;
      const int gn = min(GB, p.G - g0);
      const int row = cur.b * rows_b + cur.rloc;
      const long long row_tile0 = offs[cur.b] + (long long)cur.rloc * cur.nt;
      const int c_first = cta_of(row_tile0), c_last = cta_of(row_tile0 + cur.nt - 1);
      const size_t qrow0 = ((size_t)cur.b * p.KH + kh) * p.G + g0;  // the first query row
      const int dh = p.dh;
      O* orow = static_cast<O*>(p.out) + qrow0 * dh;
      if (c_first == c_last) {  // the whole row: normalize and write the output
        // over the padded width (a division by the runtime dh costs the f32
        // instances a spill); the padding's columns are not written
        for (int o = tid; o < gn * DHP; o += NT) {
          const int g = o / DHP, d = o % DHP;
          if (d >= dh) continue;
          float s = 0.f;
          for (int t = 0; t < PQ; ++t) s += red[(t * GB + g) * DHP + d];
          Elem<O>::store(orow + g * dh + d, s / fmaxf(l_s[g], 1e-30f));
        }
        if (LSE && tid < gn)
          p.lse[qrow0 + tid] =
              nlen[cur.b] < 0 ? -INFINITY : m_buf[((step + 1) & 1) * GB + tid] + logf(l_s[tid]);
      } else {
        const size_t slot_p = (size_t)row + blockIdx.x;
        for (int o = tid; o < GB * DHP; o += NT) {
          const int g = o / DHP, d = o % DHP;
          float s = 0.f;
          for (int t = 0; t < PQ; ++t) s += red[(t * GB + g) * DHP + d];
          p.part_acc[slot_p * GB * DHP + o] = s;
        }
        if (tid < GB) {
          p.part_ml[slot_p * 2 * GB + tid] = m_buf[((step + 1) & 1) * GB + tid];
          p.part_ml[slot_p * 2 * GB + GB + tid] = l_s[tid];
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) {
          const int done = atomicAdd(p.tickets + row, 1);
          const bool fin = done == c_last - c_first;
          if (fin) p.tickets[row] = 0;  // every segment has counted: ready for the next call
          *last_flag = fin;
        }
        __syncthreads();
        if (*last_flag) {
          // -- the row's last segment: merge its partials in CTA order. SETS
          // thread sets each fold a contiguous run of them with an online
          // rescale (one pass over device memory), then the runs are folded
          // in set order.
          __threadfence();
          const int nc = c_last - c_first + 1;
          const float* pm = p.part_ml + ((size_t)row + c_first) * 2 * GB;  // [c][m, l][g]
          constexpr int O4 = GB * U, SETS = NT / O4 > 0 ? NT / O4 : 1;
          static_assert(O4 <= NT, "one thread per output quad");
          const int o4 = tid % O4, set = tid / O4, g = o4 / U, u = o4 % U;
          float4* red4 = reinterpret_cast<float4*>(red);        // [set][o4]
          float2* red_ml = reinterpret_cast<float2*>(red4 + SETS * O4);
          if (set < SETS) {
            const int per = (nc + SETS - 1) / SETS;
            const int lo = min(nc, set * per), hi = min(nc, lo + per);
            const float4* pa =
                reinterpret_cast<const float4*>(p.part_acc) + ((size_t)row + c_first) * O4 + o4;
            float m = -INFINITY, l = 0.f;
            float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
            for (int c = lo; c < hi; ++c) {
              const float mc = __ldcg(pm + c * 2 * GB + g);
              const float lc = __ldcg(pm + c * 2 * GB + GB + g);
              const float4 x = __ldcg(pa + (size_t)c * O4);
              const float mn = fmaxf(m, mc);
              const float a = expf(m - mn), w = expf(mc - mn);
              l = fmaf(a, l, w * lc);
              acc4.x = fmaf(a, acc4.x, w * x.x);
              acc4.y = fmaf(a, acc4.y, w * x.y);
              acc4.z = fmaf(a, acc4.z, w * x.z);
              acc4.w = fmaf(a, acc4.w, w * x.w);
              m = mn;
            }
            red4[set * O4 + o4] = acc4;
            red_ml[set * O4 + o4] = make_float2(m, l);
          }
          __syncthreads();
          if (tid < O4 && g < gn) {
            float mm = -INFINITY;
            for (int k = 0; k < SETS; ++k) mm = fmaxf(mm, red_ml[k * O4 + o4].x);
            float l = 0.f;
            float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int k = 0; k < SETS; ++k) {
              const float2 ml = red_ml[k * O4 + o4];
              const float w = expf(ml.x - mm);  // 0 for an empty run
              const float4 x = red4[k * O4 + o4];
              l = fmaf(w, ml.y, l);
              acc4.x = fmaf(w, x.x, acc4.x);
              acc4.y = fmaf(w, x.y, acc4.y);
              acc4.z = fmaf(w, x.z, acc4.z);
              acc4.w = fmaf(w, x.w, acc4.w);
            }
            const float iv = 1.f / fmaxf(l, 1e-30f);
            if (4 * u < dh)  // a quad of the padding is not written
              Elem<O>::store_quad(orow + g * dh + 4 * u,
                                  make_float4(acc4.x * iv, acc4.y * iv, acc4.z * iv, acc4.w * iv));
            if (LSE && u == 0)
              p.lse[qrow0 + g] = nlen[cur.b] < 0 ? -INFINITY : mm + logf(l);
          }
        }
      }
    }
    cur.advance(offs, rows_b);
  }
  cp_async_wait<0>();  // leave no copy in flight at exit
}

inline int group_rows(int G) { return G > 4 ? GROUP_MAX : G > 2 ? 4 : G; }

// Chunks of a padded row: the least power of two of 8, 16 or 32 chunks that
// holds dh elements of `elem_bytes` bytes.
inline int row_chunks(int DH, int elem_bytes) {
  const int need = DH * elem_bytes / 16;
  return need <= 8 ? 8 : need <= 16 ? 16 : 32;
}

inline bool valid_shape(int B, int S, int KH, int G, int DH, int elem_bytes) {
  if (B < 1 || B > B_MAX || S < 1 || KH < 1 || G < 1 || G > 32 || DH < 8 || DH > DH_MAX ||
      DH % 8 != 0 || (elem_bytes != 4 && elem_bytes != 2))
    return false;
  const int gb = group_rows(G), t = TILE_CHUNKS / row_chunks(DH, elem_bytes);
  // tile indices and output offsets are ints
  return (long long)B * KH * ((G + gb - 1) / gb) * ((S + t - 1) / t) < (1LL << 31) &&
         (long long)B * KH * G * DH < (1LL << 31);
}

template <int N>
using IntTag = std::integral_constant<int, N>;

template <int C, class F>
cudaError_t by_rows(int gb, F&& f) {
  switch (gb) {
    case 1: return f(IntTag<C>{}, IntTag<1>{});
    case 2: return f(IntTag<C>{}, IntTag<2>{});
    case 4: return f(IntTag<C>{}, IntTag<4>{});
    default: return f(IntTag<C>{}, IntTag<8>{});
  }
}

// Calls f(IntTag<C>, IntTag<GB>) for the instance of element type E that
// takes these shapes: f32 rows of 8, 16 or 32 chunks (dh up to 32, 64,
// 128), bf16 rows of 8 or 16 (dh up to 64, 128).
template <class E, class F>
cudaError_t with_instance(int DH, int gb, F&& f) {
  const int c = row_chunks(DH, sizeof(E));
  if (c == 8) return by_rows<8>(gb, f);
  if constexpr (sizeof(E) == 4) {
    if (c == 16) return by_rows<16>(gb, f);
    return by_rows<32>(gb, f);
  } else {
    return by_rows<16>(gb, f);
  }
}

// The grid: as many CTAs as fit the card at once, at most one per tile the
// shapes allow. A function of the shapes and the device only. No CTA waits
// for another, so an instance that fits fewer an SM runs it in waves.
template <class E, int C, int GB>
cudaError_t plan(int B, int S, int KH, int G, int* grid, int* smem) {
  static LaunchCache cache, cache_lse;
  constexpr int DHP = C * Elem<E>::EPC;
  *smem = static_cast<int>(Smem<C, DHP, GB>::bytes(B));
  int blocks = 0, lse_blocks = 0;
  cudaError_t e = resident_blocks(cache, da_kernel<E, C, GB, false>, NT, *smem, &blocks);
  if (e != cudaSuccess) return e;
  // the log-sum-exp instance needs its own shared-memory attribute; its grid
  // is the one above
  e = resident_blocks(cache_lse, da_kernel<E, C, GB, true>, NT, *smem, &lse_blocks);
  if (e != cudaSuccess) return e;
  if (blocks < 1 || lse_blocks < 1) return cudaErrorInvalidConfiguration;
  const int t = Geo<C>::T;
  const long long tiles = (long long)B * KH * ((G + GB - 1) / GB) * ((S + t - 1) / t);
  *grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  return cudaSuccess;
}

// The plan and the launch of element type E's instances; each translation
// unit instantiates one E (decode_attention.cu f32, decode_attention_bf16.cu
// bf16), so the two compile in parallel.
template <class E>
cudaError_t make_plan(int B, int S, int KH, int G, int DH, int* grid, int* smem) {
  if (!valid_shape(B, S, KH, G, DH, sizeof(E))) return cudaErrorInvalidValue;
  return with_instance<E>(DH, group_rows(G), [&](auto tc, auto tg) {
    return plan<E, decltype(tc)::value, decltype(tg)::value>(B, S, KH, G, grid, smem);
  });
}

template <class E>
cudaError_t launch(const Params& p, int gb, int grid, int smem, cudaStream_t stream) {
  return with_instance<E>(p.dh, gb, [&](auto tc, auto tg) {
    constexpr int C = decltype(tc)::value, GB = decltype(tg)::value;
    if (p.lse != nullptr)
      da_kernel<E, C, GB, true><<<grid, NT, smem, stream>>>(p);
    else
      da_kernel<E, C, GB, false><<<grid, NT, smem, stream>>>(p);
    return cudaSuccess;
  });
}

// bf16's plan and launch, defined in decode_attention_bf16.cu
cudaError_t make_plan_bf16(int B, int S, int KH, int G, int DH, int* grid, int* smem);
cudaError_t launch_bf16(const Params& p, int gb, int grid, int smem, cudaStream_t stream);

}  // namespace da
