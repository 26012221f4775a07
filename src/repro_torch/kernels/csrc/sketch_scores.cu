// PQ-sketch block estimates on Hopper (sm_90a):
//   est[b, n] = sum_{s = 0..M-1} lut[b, s, codes[n, s]]
//
// Replaces: src/repro/kernels/block_mips.py::sketch_scores (Pallas body
// `_sketch_kernel`). The LUT (B, M, K), lut[b, s, j] = <q_b[s], codebook_s[j]>,
// is built outside the kernel in plain torch, as the JAX package builds it
// outside its grid.
//
// What bounds it: the function reads the codes (NB x M int32) and the LUT
// once and writes est (B x NB f32); it does B * NB * M additions, far below
// the card's rate, so it is bound by bytes, mostly the est it writes. What
// the design does about it: each block holds the LUTs of up to 8 queries in
// dynamic shared memory (8 x 16 x 256 x 4 B = 128 KB at the main path's
// sketch), each thread owns one block n at a time, reads its M codes once
// and sums the M table entries for all queries of the tile in subspace
// order s = 0..M-1 (the TPU kernel's order), and the est rows are written
// coalesced. Each block walks 2048 blocks n, so the table is loaded once per
// 2048 x 8 outputs.

#include <cuda_runtime.h>

namespace {

constexpr int SK_THREADS = 1024;
constexpr int SK_QT = 8;              // queries per block (their LUTs in smem)
constexpr int SK_NPT = 2;             // blocks n per thread
constexpr int SMEM_MAX = 232448;      // a block's shared-memory limit on sm_90

__global__ void __launch_bounds__(SK_THREADS) sketch_kernel(
    const int* __restrict__ codes, const float* __restrict__ lut,
    float* __restrict__ est, int B, int NB, int M, int K, int qt) {
  extern __shared__ float lut_s[];  // [qt][M][K]
  const int q0 = blockIdx.y * qt, nq = min(qt, B - q0);
  const int tab = M * K;
  const float* src = lut + (size_t)q0 * tab;
  for (int i = threadIdx.x; i < nq * tab; i += SK_THREADS) lut_s[i] = src[i];
  __syncthreads();
  const int n_begin = blockIdx.x * SK_THREADS * SK_NPT;
  for (int t = 0; t < SK_NPT; ++t) {
    const int n = n_begin + t * SK_THREADS + threadIdx.x;
    if (n >= NB) break;
    float acc[SK_QT];
#pragma unroll
    for (int qq = 0; qq < SK_QT; ++qq) acc[qq] = 0.f;
    const int* crow = codes + (size_t)n * M;
    for (int s = 0; s < M; ++s) {
      const float* col = lut_s + s * K + crow[s];
#pragma unroll
      for (int qq = 0; qq < SK_QT; ++qq)
        if (qq < nq) acc[qq] += col[qq * tab];
    }
#pragma unroll
    for (int qq = 0; qq < SK_QT; ++qq)
      if (qq < nq) est[(size_t)(q0 + qq) * NB + n] = acc[qq];
  }
}

}  // namespace

// codes (NB, M) i32 in [0, K); lut (B, M, K) f32; est (B, NB) f32.
// Returns the launch error, or 0.
extern "C" int sketch_scores_launch(const int* codes, const float* lut,
                                    float* est, int B, int NB, int M, int K,
                                    void* stream_handle) {
  const long long tab_bytes = (long long)M * K * (long long)sizeof(float);
  if (B < 1 || NB < 1 || M < 1 || K < 1 || tab_bytes > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int qt = (int)(SMEM_MAX / tab_bytes);
  qt = qt < SK_QT ? qt : SK_QT;
  qt = qt < B ? qt : B;
  const size_t smem = (size_t)qt * tab_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = SK_THREADS * SK_NPT;
  const dim3 grid((NB + per_block - 1) / per_block, (B + qt - 1) / qt);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  sketch_kernel<<<grid, SK_THREADS, smem, static_cast<cudaStream_t>(stream_handle)>>>(
      codes, lut, est, B, NB, M, K, qt);
  return static_cast<int>(cudaGetLastError());
}
