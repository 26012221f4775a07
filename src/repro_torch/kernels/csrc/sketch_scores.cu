// PQ-sketch block estimates on Hopper (sm_90a):
//   est[b, n] = sum_{s = 0..M-1} lut[b, s, codes[n, s]]
//
// Replaces: src/repro/kernels/block_mips.py::sketch_scores (Pallas body
// `_sketch_kernel`). The LUT (B, M, K), lut[b, s, j] = <q_b[s], codebook_s[j]>,
// is built outside the kernel in plain torch (`ref.sketch_lut`), as the JAX
// package builds it outside its grid.
//
// What bounds it: the function reads the codes (NB x M int32) and the LUT
// once and writes est (B x NB f32): 40.5 MB at the main path's sketch
// (B = 64, NB = 125,000, M = 16, K = 256), 0.012 ms at 3.35 TB/s. Its
// B * NB * M additions are far below the card's rate, but each is a lookup
// at a random code, and the B * NB * M * 4 bytes of lookups (512 MB there)
// go through shared memory, at a random bank each.
//
// What the design does about it:
// * A persistent grid: queries in groups of QG (8, or fewer when B or the
//   shared memory asks), each group's tables staged
//   once per block (for QG = 8 with 16-byte loads and a transpose by warp
//   shuffles, else with 4-byte cp.async copies), and the blocks of a group
//   (as many as fill the SMs) each walk a contiguous range of blocks n. So
//   the tables are copied about once per SM (17 MB a call at the main
//   path's shape), not once per 2,048 blocks n.
// * The tables are transposed while they are staged, to [s][code][query]
//   with the queries fastest, so the entries a thread needs for one code
//   are contiguous: for QG = 8 two threads share each block n and read 4
//   queries' entries each with one 16-byte shared load (a quarter-warp then
//   reads 4 random 32-byte records, not 8 random 16-byte halves, so fewer
//   of its loads share a bank); for QG = 4 one thread reads all 4.
// * Codes are read as one int4 per 4 subspaces when M % 4 == 0 (a scalar
//   path takes other M or an unaligned view).
// * Each est is summed over s = 0..M-1 with fp32 `+` from 0.f (the TPU
//   kernel's subspace order): est is bit-identical to an ordered LUT sum in
//   torch (`ref.sketch_scores_lut_ref`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int SMEM_MAX = 232448;  // a block's shared-memory limit on sm_90
// The largest query group: a block holds 8 queries' tables (128 KB at
// M = 16, K = 256). Groups of 4 (two blocks an SM, each staging while the
// other scores) measured slower on an H100 80GB HBM3 at 700 W at the n = 1M
// sketch; they still take B <= 4.
constexpr int QG_MAX = 8;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Threads per block n: for QG = 8 two, each summing 4 of the group's
// queries (one 16-byte load a lookup), else one summing all QG.
template <int QG>
constexpr int kTpn = QG == 8 ? 2 : 1;

// acc[j] += entry j of the record at `rec` (the thread's QT queries).
template <int QT>
__device__ __forceinline__ void lookup(const float* __restrict__ rec,
                                       float (&acc)[QT]) {
  if constexpr (QT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(rec);
    acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
  } else if constexpr (QT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(rec);
    acc[0] += v.x; acc[1] += v.y;
  } else {
    acc[0] += rec[0];
  }
}

// Stage 8 queries' tables (tab = M * K entries each, tab % 16 == 0) from
// global [query][e] to shared [e][query], e = s * K + code. Each warp
// iteration reads 16 entries of each of the 8 tables, one float4 a lane
// (lane = 4 * query + quarter), and writes them as 4 x 128 contiguous bytes
// after a transpose by shuffles: no shared-memory bank conflict, and all
// of a warp's loads (up to 8 iterations) are in flight together.
__device__ __forceinline__ void stage_transposed(const float* __restrict__ src,
                                                 float* __restrict__ lut_s,
                                                 int tab, int nq) {
  constexpr int UNROLL = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ql = lane >> 2, part = lane & 3;  // the loading role
  const int qs = lane & 7, rec = lane >> 3;   // the storing role
  const float* srcq = src + (size_t)ql * tab + 4 * part;
  for (int base = 16 * warp; base < tab; base += 16 * nwarps * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int e0 = base + 16 * nwarps * k;
      v[k] = (e0 < tab && ql < nq)
                 ? __ldg(reinterpret_cast<const float4*>(srcq + e0))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int e0 = base + 16 * nwarps * k;  // uniform across the warp
      if (e0 >= tab) break;
#pragma unroll
      for (int t = 0; t < 4; ++t) {  // entries e0 + 4t .. e0 + 4t + 3
        const int from = 4 * qs + t;
        const float a = __shfl_sync(0xffffffffu, v[k].x, from);
        const float b = __shfl_sync(0xffffffffu, v[k].y, from);
        const float c = __shfl_sync(0xffffffffu, v[k].z, from);
        const float d = __shfl_sync(0xffffffffu, v[k].w, from);
        lut_s[(e0 + 4 * t + rec) * 8 + qs] =
            rec == 0 ? a : rec == 1 ? b : rec == 2 ? c : d;
      }
    }
  }
}

// Grid (blocks per group P, query groups). Shared memory: the group's
// tables, [M][K][QG] f32.
template <int QG, bool VEC>
__global__ void __launch_bounds__(QG >= 8 ? 1024 : 512, QG >= 8 ? 1 : 3) sketch_kernel(
    const int* __restrict__ codes, const float* __restrict__ lut,
    float* __restrict__ est, int B, int NB, int M, int K) {
  constexpr int NT = QG >= 8 ? 1024 : 512;
  constexpr int TPN = kTpn<QG>, QT = QG / TPN;
  extern __shared__ __align__(16) float lut_s[];
  const int q0 = blockIdx.y * QG, nq = min(QG, B - q0);
  const int tab = M * K;
  if (QG == 8 && tab % 16 == 0 && reinterpret_cast<uintptr_t>(lut) % 16 == 0) {
    stage_transposed(lut + (size_t)q0 * tab, lut_s, tab, nq);
  } else {
#pragma unroll
    for (int qq = 0; qq < QG; ++qq) {  // global reads coalesced along e
      const float* src = lut + (size_t)(q0 + qq) * tab;
      for (int e = threadIdx.x; e < tab; e += NT) {
        float* dst = lut_s + e * QG + qq;
        if (qq < nq)
          cp_async4(dst, src + e);
        else
          *dst = 0.f;  // a padding query of the last group
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  const int h = threadIdx.x % TPN;
  const int n_begin = static_cast<int>((long long)NB * blockIdx.x / gridDim.x);
  const int n_end = static_cast<int>((long long)NB * (blockIdx.x + 1) / gridDim.x);
  for (int n = n_begin + threadIdx.x / TPN; n < n_end; n += NT / TPN) {
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.f;
    const int* crow = codes + (size_t)n * M;
    const float* tab_h = lut_s + h * QT;  // this thread's queries
    if (VEC) {
      for (int s = 0; s < M; s += 4) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(crow + s));
        const float* ts = tab_h + s * K * QG;
        lookup<QT>(ts + c.x * QG, acc);
        lookup<QT>(ts + (K + c.y) * QG, acc);
        lookup<QT>(ts + (2 * K + c.z) * QG, acc);
        lookup<QT>(ts + (3 * K + c.w) * QG, acc);
      }
    } else {
      for (int s = 0; s < M; ++s)
        lookup<QT>(tab_h + (s * K + __ldg(crow + s)) * QG, acc);
    }
#pragma unroll
    for (int j = 0; j < QT; ++j)
      if (h * QT + j < nq) est[(size_t)(q0 + h * QT + j) * NB + n] = acc[j];
  }
}

template <int QG, bool VEC>
int launch(const int* codes, const float* lut, float* est, int B, int NB,
           int M, int K, cudaStream_t stream) {
  static LaunchCache cache;
  auto kernel = sketch_kernel<QG, VEC>;
  constexpr int NT = QG >= 8 ? 1024 : 512;
  const int smem = QG * M * K * 4;
  int resident = 0;
  const cudaError_t err = resident_blocks(cache, kernel, NT, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = (B + QG - 1) / QG;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int per_group = resident / groups;
  per_group = per_group < 1 ? 1 : per_group;
  const int most = (NB * kTpn<QG> + NT - 1) / NT;  // every block has work
  per_group = per_group < most ? per_group : most;
  kernel<<<dim3(per_group, groups), NT, smem, stream>>>(codes, lut, est, B, NB,
                                                        M, K);
  return static_cast<int>(cudaGetLastError());
}

template <int QG>
int launch_qg(const int* codes, const float* lut, float* est, int B, int NB,
              int M, int K, cudaStream_t stream) {
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  return vec ? launch<QG, true>(codes, lut, est, B, NB, M, K, stream)
             : launch<QG, false>(codes, lut, est, B, NB, M, K, stream);
}

}  // namespace

// codes (NB, M) i32 in [0, K); lut (B, M, K) f32; est (B, NB) f32. The
// query group is the largest power of two <= QG_MAX that B asks for and
// whose tables fit in shared memory. Returns the launch error, or 0.
extern "C" int sketch_scores_launch(const int* codes, const float* lut,
                                    float* est, int B, int NB, int M, int K,
                                    void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long tab_bytes = (long long)M * K * (long long)sizeof(float);
  if (B < 1 || NB < 1 || M < 1 || K < 1 || tab_bytes > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int g = QG_MAX;
  while (g > 1 && (g / 2 >= B || g * tab_bytes > SMEM_MAX)) g /= 2;
  switch (g) {
    case 8: return launch_qg<8>(codes, lut, est, B, NB, M, K, stream);
    case 4: return launch_qg<4>(codes, lut, est, B, NB, M, K, stream);
    case 2: return launch_qg<2>(codes, lut, est, B, NB, M, K, stream);
    default: return launch_qg<1>(codes, lut, est, B, NB, M, K, stream);
  }
}
