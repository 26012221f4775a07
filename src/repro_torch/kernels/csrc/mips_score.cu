// Candidate-row scores for a query batch on Hopper (sm_90a):
//   out[r, b] = <x[r], q[b]> in fp32, exactly -1e30 where valid[r] is false.
//
// Replaces: src/repro/kernels/mips_topk.py::mips_score (Pallas body
// `_kernel`, an output-stationary tiled matmul with the validity mask in its
// last depth step). The streaming index scores its whole delta segment with
// it on every search (runtime `_merge_segments`).
//
// What bounds it: the function reads x once (R x d f32) and writes out once
// (R x B f32) and does 2 * R * B * d fp32 operations. At the streaming delta's
// shape (R = 131,072 rows, B = 64, d = 128) that is 67.1 MB + 33.6 MB moved
// (30 us at 3.35 TB/s) against 2.15 GFLOP (32 us at 67 TFLOP/s): bound by
// operations, just. What the design does about it: each block stages a tile
// of 128 rows and 64 queries in shared memory in 32-wide depth slices, and
// each of its 256 threads keeps an 8 x 4 (row, query) tile of sums in
// registers (12 shared loads per 32 FMA), so every row is read from device
// memory once per 64 queries; the mask is applied when the sums are written.
// No tensor cores: the delta's scores decide ids exactly, and TF32 would round
// them. Each sum runs over depth in order 0..d-1 with fmaf, as block_mips.cu
// does, so integer-valued data gives exact scores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 128;       // rows per block
constexpr int QT = 64;        // queries per block
constexpr int DK = 32;        // depth slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 4 register tiles
constexpr float MASKED = -1e30f;

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

}  // namespace

// x (R, d) f32; q (B, d) f32; valid (R,) u8; out (R, B) f32.
// Returns the launch error, or 0.
extern "C" int mips_score_launch(const float* x, const float* q,
                                 const uint8_t* valid, float* out, int R, int B,
                                 int d, void* stream_handle) {
  if (R < 1 || B < 1 || d < 1 || (B + QT - 1) / QT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + RT - 1) / RT, (B + QT - 1) / QT);
  mips_score_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      x, q, valid, out, R, B, d);
  return static_cast<int>(cudaGetLastError());
}
