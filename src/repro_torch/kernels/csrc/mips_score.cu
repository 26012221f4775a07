// Candidate-row scores for a query batch on Hopper (sm_90a):
//   out[r, b] = <x[r], q[b]> in fp32, exactly -1e30 where valid[r] is false.
//
// Replaces: src/repro/kernels/mips_topk.py::mips_score (Pallas body
// `_kernel`, an output-stationary tiled matmul with the validity mask in its
// last depth step). The streaming index scores its whole delta segment with
// it on every search (runtime `_merge_segments`), and the batched
// verification scores its union tile with it (the serve search, B <= 4).
//
// Every output is one fmaf chain over depth 0..d-1 from 0.f, in both paths
// below, so a score does not depend on the batch it was computed in nor on
// the path: integer-valued data gives exact scores, and the small path is
// bit-identical to the tile path. No tensor cores: the delta's and the vocab
// tile's scores decide ids and tokens, and TF32 would round them.
//
// Two paths, chosen by the launcher: the small-batch path for B <= B_SMALL
// when its queries fit in shared memory, else the tile path. B_SMALL is the
// crossover of the B sweep in `chip_smoke.py` phase 2.
//
// * The small-batch path. What bounds it: it reads x once (R x d f32) and writes R x B
//   scores, with 2 R B d operations, so at the serve tile (R = 32,000,
//   B = 4, d = 2,048: 262 MB) it is bound by bytes, 0.078 ms at 3.35 TB/s.
//   What the design does about it: a persistent grid (blocks per SM from
//   the occupancy calculator) splits the rows into balanced contiguous
//   ranges; each block holds the B x d queries in shared memory once and
//   walks its rows in sub-tiles of 256 (one row per thread) and depth
//   slices of 64 (32 when the queries leave no room for two such stages),
//   which arrive through a ring of up to 3 stages of 16-byte cp.async
//   copies with a 256-byte L2 fetch hint: the next slices are in flight
//   while one is summed, and each row is read in 256-byte runs. The staged
//   rows are unpadded; their 16-byte units are XOR-swizzled by row, so the
//   8 threads of a quarter-warp read 8 distinct bank groups at one depth,
//   and each query's float4 at that depth is one broadcast read. A row
//   tile that is not 16-byte aligned (d % 4 != 0, or a view at a 4-byte
//   offset) is staged with 4-byte cp.async copies instead. The queries are
//   zero-padded to the next power of two (a template), whose columns are
//   never written.
// * The tile path (any B): each block stages a tile of 128 rows and 64
//   queries in shared memory in 32-wide depth slices, and each of its 256
//   threads keeps an 8 x 4 (row, query) tile of sums in registers (12 shared
//   loads per 32 FMA), so every row is read once per 64 queries. At the
//   streaming delta's shape (R = 131,072, B = 64, d = 128: 101 MB moved,
//   2.15 GFLOP) it is bound by operations, 0.032 ms at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr float MASKED = -1e30f;

// ---------------------------------------------------------------- tile path

constexpr int RT = 128;       // rows per block
constexpr int QT = 64;        // queries per block
constexpr int DK = 32;        // depth slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 4 register tiles

__global__ void __launch_bounds__(THREADS) mips_score_kernel(
    const float* __restrict__ x, const float* __restrict__ q,
    const uint8_t* __restrict__ valid, float* __restrict__ out, int R, int B,
    int d) {
  __shared__ float xs[RT][DK + 1];
  __shared__ float qs[QT][DK + 1];
  const int tid = threadIdx.x, tq = tid & 15, tr = tid >> 4;
  const int r0 = blockIdx.x * RT, b0 = blockIdx.y * QT;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += DK) {
    const int cmax = min(DK, d - d0);
    __syncthreads();  // the previous slice is consumed
    for (int idx = tid; idx < RT * DK; idx += THREADS) {
      const int rr = idx / DK, c = idx % DK, r = r0 + rr;
      xs[rr][c] = (r < R && c < cmax) ? x[(size_t)r * d + d0 + c] : 0.f;
    }
    for (int idx = tid; idx < QT * DK; idx += THREADS) {
      const int qq = idx / DK, c = idx % DK, b = b0 + qq;
      qs[qq][c] = (b < B && c < cmax) ? q[(size_t)b * d + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < cmax; ++c) {
      float xv[8], qv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = xs[tr + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = qs[tq + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], qv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + tr + 16 * i;
    if (r >= R) continue;
    const bool ok = valid[r] != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tq + 16 * j;
      if (b < B) out[(size_t)r * B + b] = ok ? acc[i][j] : MASKED;
    }
  }
}

// ---------------------------------------------------------- small-batch path

constexpr int SB_THREADS = 256;  // rows per sub-tile, one per thread
constexpr int SB_STAGES = 3;     // ring depth when it fits
// The largest B the small path takes. The B sweep (H100 80GB HBM3, 700 W)
// has it faster than the tile path at every B <= 16 at d = 2,048 and
// d = 128; an earlier 32-query instantiation lost to the tile path at
// d = 128.
constexpr int B_SMALL = 16;
constexpr int SMEM_MAX = 232448; // a block's shared-memory limit

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(s),
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

// Wait until at most n of this thread's groups are in flight (n <= 2).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// Where depth c of staged row rr sits in its DC floats: 16-byte unit c / 4
// goes to unit (c / 4) ^ (rr % 8), so the 8 rows of a quarter-warp read
// 8 distinct bank groups at the same depth without padding.
__device__ __forceinline__ int swz(int rr, int c) {
  return ((((c >> 2) ^ rr) & 7) | ((c >> 2) & ~7)) << 2 | (c & 3);
}

// Shared memory: q_s [BQ][dq] (dq = d rounded up to 4), then the ring
// [stages][SB_THREADS][DC]. Work item i of a block is (sub-tile
// i / n_chunks, depth slice i % n_chunks) and lives in stage i % stages.
// The register budget is explicit (one block an SM, up to 255 registers): a
// build without it spilled 8 bytes at 80 registers in <16, 32, false>.
template <int BQ, int DC, bool VEC>
__global__ void __launch_bounds__(SB_THREADS, 1) mips_score_small_kernel(
    const float* __restrict__ x, const float* __restrict__ q,
    const uint8_t* __restrict__ valid, float* __restrict__ out, int R, int B,
    int d, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int dq = (d + 3) & ~3;
  float* q_s = smem;
  float* ring = smem + BQ * dq;
  const int tid = threadIdx.x;
  const int r_begin = static_cast<int>((long long)R * blockIdx.x / gridDim.x);
  const int r_end = static_cast<int>((long long)R * (blockIdx.x + 1) / gridDim.x);
  const int n_chunks = (d + DC - 1) / DC;
  const int n_items = (r_end - r_begin + SB_THREADS - 1) / SB_THREADS * n_chunks;

  // the queries, in the first group of copies when they are 16-byte aligned
  if (VEC) {
    for (int i = tid; i < B * d / 4; i += SB_THREADS)
      cp_async16(q_s + 4 * i, q + 4 * i);
    for (int i = B * d + tid; i < BQ * d; i += SB_THREADS) q_s[i] = 0.f;
  } else {
    for (int i = tid; i < BQ * dq; i += SB_THREADS) {
      const int b = i / dq, c = i - b * dq;
      q_s[i] = (b < B && c < d) ? q[(size_t)b * d + c] : 0.f;
    }
  }

  auto stage_item = [&](int item) {  // copy one item in, then close its group
    if (item < n_items) {
      const int t = item / n_chunks, c0 = (item - t * n_chunks) * DC;
      const int r0 = r_begin + t * SB_THREADS;
      const int rows = min(SB_THREADS, r_end - r0), cols = min(DC, d - c0);
      float* st = ring + (item % stages) * (SB_THREADS * DC);
      const float* src = x + (size_t)r0 * d + c0;
      if (VEC) {  // d % 4 == 0 and x 16-byte aligned: cols % 4 == 0
        for (int i = tid; i < rows * (DC / 4); i += SB_THREADS) {
          const int rr = i / (DC / 4), c = 4 * (i % (DC / 4));
          if (c < cols) cp_async16(st + rr * DC + swz(rr, c), src + (size_t)rr * d + c);
        }
      } else {
        for (int i = tid; i < rows * DC; i += SB_THREADS) {
          const int rr = i / DC, c = i % DC;
          if (c < cols) cp_async4(st + rr * DC + swz(rr, c), src + (size_t)rr * d + c);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < stages - 1; ++s) stage_item(s);
  float acc[BQ];
#pragma unroll
  for (int b = 0; b < BQ; ++b) acc[b] = 0.f;
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait(stages - 2);  // this thread's copies of item `it` landed
    __syncthreads();            // everyone's; the stage of it - 1 is free
    stage_item(it + stages - 1);
    const int t = it / n_chunks, ch = it - t * n_chunks;
    const int r = r_begin + t * SB_THREADS + tid;
    if (r >= r_end) continue;
    const int c0 = ch * DC, cols = min(DC, d - c0);
    const float* xr = ring + (it % stages) * (SB_THREADS * DC) + tid * DC;
    const float* qc = q_s + c0;
    if (cols == DC) {
#pragma unroll 4
      for (int c = 0; c < DC; c += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + swz(tid, c));
#pragma unroll
        for (int b = 0; b < BQ; ++b) {
          const float4 qv = *reinterpret_cast<const float4*>(qc + b * dq + c);
          acc[b] = fmaf(xv.x, qv.x, acc[b]);
          acc[b] = fmaf(xv.y, qv.y, acc[b]);
          acc[b] = fmaf(xv.z, qv.z, acc[b]);
          acc[b] = fmaf(xv.w, qv.w, acc[b]);
        }
      }
    } else {  // the last, partial slice: exactly `cols` terms
      for (int c = 0; c < cols; ++c) {
        const float xv = xr[swz(tid, c)];
#pragma unroll
        for (int b = 0; b < BQ; ++b) acc[b] = fmaf(xv, qc[b * dq + c], acc[b]);
      }
    }
    if (ch == n_chunks - 1) {
      const bool ok = valid[r] != 0;
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        if (b < B) out[(size_t)r * B + b] = ok ? acc[b] : MASKED;
        acc[b] = 0.f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The small path's plan at (B, d): 64-deep slices when two stages of them
// fit beside the zero-padded queries, else 32-deep; `stages` = 0 if
// neither fits.
struct SmallPlan {
  int dc, stages;
};

SmallPlan small_plan(int B, int d) {
  if (B < 1 || B > B_SMALL || d < 1) return {0, 0};
  int bq = 1;
  while (bq < B) bq *= 2;
  const long long room = SMEM_MAX - (long long)bq * ((d + 3) & ~3) * 4;
  for (int dc = 64; dc >= 32; dc /= 2) {
    const long long n = room / ((long long)SB_THREADS * dc * 4);
    if (n >= 2) return {dc, static_cast<int>(n < SB_STAGES ? n : SB_STAGES)};
  }
  return {0, 0};
}

template <int BQ, int DC, bool VEC>
int launch_small(const float* x, const float* q, const uint8_t* valid,
                 float* out, int R, int B, int d, int stages,
                 cudaStream_t stream) {
  static LaunchCache cache;
  auto kernel = mips_score_small_kernel<BQ, DC, VEC>;
  const int smem = (BQ * ((d + 3) & ~3) + stages * SB_THREADS * DC) * 4;
  int resident = 0;
  const cudaError_t err =
      resident_blocks(cache, kernel, SB_THREADS, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int most = (R + 31) / 32;  // at least a warp of rows per block
  const int grid = resident < most ? resident : most;
  kernel<<<grid, SB_THREADS, smem, stream>>>(x, q, valid, out, R, B, d, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int DC, bool VEC>
int dispatch_small(const float* x, const float* q, const uint8_t* valid,
                   float* out, int R, int B, int d, int stages,
                   cudaStream_t stream) {
  if (B <= 1) return launch_small<1, DC, VEC>(x, q, valid, out, R, B, d, stages, stream);
  if (B <= 2) return launch_small<2, DC, VEC>(x, q, valid, out, R, B, d, stages, stream);
  if (B <= 4) return launch_small<4, DC, VEC>(x, q, valid, out, R, B, d, stages, stream);
  if (B <= 8) return launch_small<8, DC, VEC>(x, q, valid, out, R, B, d, stages, stream);
  return launch_small<16, DC, VEC>(x, q, valid, out, R, B, d, stages, stream);
}

}  // namespace

// B_SMALL, for the tests and the B sweep.
extern "C" int mips_score_b_small() { return B_SMALL; }

// x (R, d) f32; q (B, d) f32; valid (R,) u8; out (R, B) f32. `path` 0 lets
// the launcher choose (the small-batch path for B <= B_SMALL when it fits,
// else the tile path); 1 runs the small-batch path (an error if it does not
// take (B, d)) and 2 the tile path, for the tests and the B sweep. Returns
// the launch error, or 0.
extern "C" int mips_score_launch(const float* x, const float* q,
                                 const uint8_t* valid, float* out, int R, int B,
                                 int d, int path, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (R < 1 || B < 1 || d < 1 || path < 0 || path > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const SmallPlan plan = path == 2 ? SmallPlan{0, 0} : small_plan(B, d);
  if (path == 1 && !plan.stages) return static_cast<int>(cudaErrorInvalidValue);
  if (plan.stages) {
    const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
    if (plan.dc == 64)
      return vec ? dispatch_small<64, true>(x, q, valid, out, R, B, d, plan.stages, stream)
                 : dispatch_small<64, false>(x, q, valid, out, R, B, d, plan.stages, stream);
    return vec ? dispatch_small<32, true>(x, q, valid, out, R, B, d, plan.stages, stream)
               : dispatch_small<32, false>(x, q, valid, out, R, B, d, plan.stages, stream);
  }
  if ((B + QT - 1) / QT > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + RT - 1) / RT, (B + QT - 1) / QT);
  mips_score_kernel<<<grid, THREADS, 0, stream>>>(x, q, valid, out, R, B, d);
  return static_cast<int>(cudaGetLastError());
}
