// Quick-Probe group lower bounds (paper Theorem 3) for a query batch on
// Hopper (sm_90a):
//   lb[b, g] = (sum_{i < m} bit_i(codes[g] ^ q_code[b]) * |q_proj[b, i]|) / sqrt(m)
//
// Replaces: src/repro/kernels/binary_probe.py::binary_probe_lb (Pallas body
// `_kernel`, one query against a tile of group codes, the bit loop unrolled
// over m <= 30). Its only caller in the port is the batched frontend
// (`core/quick_probe.py::quick_probe_batch`), so the kernel takes the whole
// batch: one launch per search instead of one per query.
//
// What bounds it: it reads G codes (int64), B * m projections and writes
// B * G bounds, doing about m adds per bound: a few bytes and a few
// operations per output, so it is bound by bytes, and at the shapes of the
// port (G = 256 to 4,493, B = 4 to 64) by the launch itself.
//
// What the design does about it: one thread per (b, g), 256 groups per
// block and one query per block row; the block's |P(q)| row sits in shared
// memory, the XOR and the bit loop stay in registers. The sum runs over
// i = 0 .. m-1 in order (fmaf of the bit and |P_i(q)|), then one IEEE
// division by sqrtf(m).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_M = 30;

__global__ void __launch_bounds__(THREADS) binary_probe_kernel(
    const long long* __restrict__ codes, const long long* __restrict__ q_code,
    const float* __restrict__ q_proj, float* __restrict__ out, int G, int m) {
  __shared__ float qabs[MAX_M];
  const int b = blockIdx.y;
  if (threadIdx.x < m) qabs[threadIdx.x] = fabsf(q_proj[(size_t)b * m + threadIdx.x]);
  __syncthreads();
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= G) return;
  const unsigned long long x =
      static_cast<unsigned long long>(codes[g]) ^ static_cast<unsigned long long>(q_code[b]);
  float acc = 0.f;
  for (int i = 0; i < m; ++i) acc = fmaf(static_cast<float>((x >> i) & 1ull), qabs[i], acc);
  out[(size_t)b * G + g] = acc / sqrtf(static_cast<float>(m));
}

}  // namespace

// codes (G,) i64; q_code (B,) i64; q_proj (B, m) f32; out (B, G) f32.
// Takes 1 <= m <= 30. Returns the launch error, or 0.
extern "C" int binary_probe_lb_launch(const long long* codes, const long long* q_code,
                                      const float* q_proj, float* out, int B, int G, int m,
                                      void* stream_handle) {
  if (B < 1 || B > 65535 || G < 1 || m < 1 || m > MAX_M)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((G + THREADS - 1) / THREADS, B);
  binary_probe_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      codes, q_code, q_proj, out, G, m);
  return static_cast<int>(cudaGetLastError());
}
