// Quick-Probe (paper Theorem 3 and Algorithm 2) for a query batch on Hopper
// (sm_90a), in two entries:
//
//   binary_probe_lb_launch: the group lower bounds alone,
//     lb[b, g] = (sum_{i < m} bit_i(codes[g] ^ q_code[b]) * |q_proj[b, i]|) / sqrt(m);
//   quick_probe_select_launch: the whole Quick-Probe of the search frontend
//     in one launch: the query's sign code, every group's bound, Test A, the
//     chosen group's representative row and the radius to its projection.
//
// Replaces: src/repro/kernels/binary_probe.py::binary_probe_lb (Pallas body
// `_kernel`, one query against a tile of group codes, the bit loop unrolled
// over m <= 30). Its only caller in the port is the frontend's
// `core/quick_probe.py::quick_probe_batch`, whose function (the JAX package's
// `quick_probe_batch`) `quick_probe_select` computes whole.
//
// What bounds it: it reads G codes (int64), counts and min-l1 values, B * m
// projections, and writes three values per query: a few bytes and about 2m
// operations per (query, group), well under a microsecond of the card at
// the port's shapes (G = 256 to 4,493, B = 4 to 64). What it costs is its
// launch: the chain of torch ops around `binary_probe_lb` it replaces ran
// 25 to 31 CUDA kernels and copies a call (the bounds, Test A, two
// arg-reductions, the gathers and the radius); `quick_probe_select` is one.
//
// What the design does about it: one CTA per query, with one thread per group
// up to 1,024 threads (B alone cannot fill the SMs; at G = 4,493 the CTA's 32
// warps hide the latency of their bit loops, while at G = 256 more warps would
// only lengthen the final reduction). The CTA stages the query's |P(q)| and
// sign code in shared memory; each thread walks a strided set of groups, four
// at a time (their loads issued together, their bit loops interleaved), and
// keeps two running keys in registers: (smallest bound among the groups that
// pass Test A, lowest index) and (largest Test-A value among the valid groups,
// lowest index). A warp-shuffle and shared-memory reduction keeps the first
// index on ties, which is torch.argmin's and jnp.argmin's rule; NaN wins both
// reductions at its first index, as there. One thread then gathers the chosen
// group and computes the radius.
//
// Arithmetic: the bound is the same fmaf chain over i = 0..m-1 and the same
// IEEE division by sqrtf(m) in both entries, so the bounds are bit-identical
// between them. Test A is rounded op by op in torch's order with the _rn
// intrinsics (nvcc would otherwise contract a*b+c): s = min_l1 + q_l1,
// denom = c * (s * s), clamped below at 1e-30, val = (lb * lb) / denom, and
// compared with x_p as an f32. The radius sums its m squares in index order;
// torch's reduction over m may order them otherwise (within an ulp or so).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_M = 30;
constexpr int QP_MAX_THREADS = 1024;
constexpr int QP_MAX_WARPS = QP_MAX_THREADS / 32;
constexpr int QP_UNROLL = 4;  // groups a thread takes at once

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

// (value, index) keys of the two arg-reductions. `first` is better than
// `second` when it comes first in torch's order: NaN before any number (the
// first NaN wins), then the smaller (argmin) or larger (argmax) value, then
// the lower index.
__device__ __forceinline__ bool min_first(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ bool max_first(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(QP_MAX_THREADS) quick_probe_kernel(
    const long long* __restrict__ codes, const float* __restrict__ min_l1,
    const int* __restrict__ count, const float* __restrict__ rep_proj,
    const int* __restrict__ rep_row, const float* __restrict__ q_proj,
    const float* __restrict__ q_l1, float c, float x_p, int* __restrict__ out_row,
    float* __restrict__ out_radius, bool* __restrict__ out_pass, int G, int m) {
  __shared__ float qv[MAX_M];
  __shared__ float qabs[MAX_M];
  __shared__ float w_lb[QP_MAX_WARPS], w_val[QP_MAX_WARPS];
  __shared__ int w_lb_i[QP_MAX_WARPS], w_val_i[QP_MAX_WARPS], w_any[QP_MAX_WARPS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < m) {
    const float v = q_proj[(size_t)b * m + tid];
    qv[tid] = v;
    qabs[tid] = fabsf(v);
  }
  __syncthreads();
  unsigned int qcode = 0;  // bit i set iff P_i(q) >= 0, as pack_codes
  for (int i = 0; i < m; ++i) qcode |= static_cast<unsigned int>(qv[i] >= 0.f) << i;
  const float ql1 = q_l1[b];
  const float sqrt_m = sqrtf(static_cast<float>(m));

  float best_lb = INFINITY, best_val = -INFINITY;
  int best_lb_i = INT_MAX, best_val_i = INT_MAX;
  bool any_pass = false;
  for (int g0 = tid; g0 < G; g0 += QP_UNROLL * blockDim.x) {
    // the loads of QP_UNROLL groups are issued together, and their bit
    // loops run as independent chains (each its own fmaf chain in bit order)
    unsigned int x[QP_UNROLL];
    float l1[QP_UNROLL], acc[QP_UNROLL];
    int cnt[QP_UNROLL];
#pragma unroll
    for (int u = 0; u < QP_UNROLL; ++u) {
      const int g = g0 + u * blockDim.x;
      // m <= 30: the bits below m of a code fit 32 bits
      x[u] = g < G ? static_cast<unsigned int>(codes[g]) ^ qcode : 0u;
      l1[u] = g < G ? min_l1[g] : 0.f;
      cnt[u] = g < G ? count[g] : 0;
      acc[u] = 0.f;
    }
    for (int i = 0; i < m; ++i) {
      const float qa = qabs[i];
#pragma unroll
      for (int u = 0; u < QP_UNROLL; ++u)
        acc[u] = fmaf(static_cast<float>((x[u] >> i) & 1u), qa, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < QP_UNROLL; ++u) {
      const int g = g0 + u * blockDim.x;
      if (g >= G) break;
      const float lb = acc[u] / sqrt_m;
      const bool valid = cnt[u] > 0;
      const float s = __fadd_rn(l1[u], ql1);
      float denom = __fmul_rn(c, __fmul_rn(s, s));
      denom = denom < 1e-30f ? 1e-30f : denom;  // clamp(min=1e-30); NaN stays NaN
      const float val = __fdiv_rn(__fmul_rn(lb, lb), denom);
      const bool passes = valid && val >= x_p;
      any_pass |= passes;
      const float key_lb = passes ? lb : INFINITY;
      const float key_val = valid ? val : -INFINITY;
      if (min_first(key_lb, g, best_lb, best_lb_i)) {
        best_lb = key_lb;
        best_lb_i = g;
      }
      if (max_first(key_val, g, best_val, best_val_i)) {
        best_val = key_val;
        best_val_i = g;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float o_lb = __shfl_down_sync(0xffffffffu, best_lb, off);
    const int o_lb_i = __shfl_down_sync(0xffffffffu, best_lb_i, off);
    const float o_val = __shfl_down_sync(0xffffffffu, best_val, off);
    const int o_val_i = __shfl_down_sync(0xffffffffu, best_val_i, off);
    if (min_first(o_lb, o_lb_i, best_lb, best_lb_i)) {
      best_lb = o_lb;
      best_lb_i = o_lb_i;
    }
    if (max_first(o_val, o_val_i, best_val, best_val_i)) {
      best_val = o_val;
      best_val_i = o_val_i;
    }
  }
  const bool warp_any = __any_sync(0xffffffffu, any_pass);
  if (lane == 0) {
    w_lb[warp] = best_lb;
    w_lb_i[warp] = best_lb_i;
    w_val[warp] = best_val;
    w_val_i[warp] = best_val_i;
    w_any[warp] = warp_any;
  }
  __syncthreads();
  if (tid != 0) return;
  bool any = false;
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
    any |= w_any[w] != 0;
    if (min_first(w_lb[w], w_lb_i[w], best_lb, best_lb_i)) {
      best_lb = w_lb[w];
      best_lb_i = w_lb_i[w];
    }
    if (max_first(w_val[w], w_val_i[w], best_val, best_val_i)) {
      best_val = w_val[w];
      best_val_i = w_val_i[w];
    }
  }
  const int chosen = any ? best_lb_i : best_val_i;
  float r2 = 0.f;
  for (int i = 0; i < m; ++i) {
    const float d = __fsub_rn(rep_proj[(size_t)chosen * m + i], qv[i]);
    r2 = __fadd_rn(r2, __fmul_rn(d, d));
  }
  out_row[b] = rep_row[chosen];
  out_radius[b] = __fsqrt_rn(r2);
  out_pass[b] = any;
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

// The group table: codes (G,) i64, min_l1 (G,) f32, count (G,) i32 (0 marks
// padding), rep_proj (G, m) f32, rep_row (G,) i32; the batch: q_proj (B, m)
// f32, q_l1 (B,) f32; c and x_p as f32. Writes rep_row (B,) i32, radius (B,)
// f32 and test_a_passed (B,) bool. Takes 1 <= m <= 30. Returns the launch
// error, or 0.
extern "C" int quick_probe_select_launch(const long long* codes, const float* min_l1,
                                         const int* count, const float* rep_proj,
                                         const int* rep_row, const float* q_proj,
                                         const float* q_l1, int* out_row, float* out_radius,
                                         bool* out_pass, int B, int G, int m, float c,
                                         float x_p, void* stream_handle) {
  if (B < 1 || G < 1 || m < 1 || m > MAX_M) return static_cast<int>(cudaErrorInvalidValue);
  // one thread per group, in whole warps, up to the CTA's limit
  const int threads = G >= QP_MAX_THREADS ? QP_MAX_THREADS : (G + 31) / 32 * 32;
  quick_probe_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      codes, min_l1, count, rep_proj, rep_row, q_proj, q_l1, c, x_p, out_row, out_radius,
      out_pass, G, m);
  return static_cast<int>(cudaGetLastError());
}
