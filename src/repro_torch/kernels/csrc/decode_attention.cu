// One-token GQA attention against a KV cache on Hopper (sm_90a), split over
// the cache length (flash-decoding):
//   out[b, kh, g] = softmax_t(<q[b, kh, g], k[b, t, kh]> / sqrt(dh)) . v[b, t, kh]
// over t < cache_len[b]; positions at or beyond it are masked with -1e30, so
// cache_len = 0 gives the mean of V over all S positions.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`): a grid (B, KH, S/bS) that walks S in order and carries the
// online-softmax state (m, l, acc) in VMEM from one grid step to the next.
// Its runtime mirror is `models/attention.py::flash_decode`, which every layer
// of every decode step calls.
//
// What bounds it: each (b, kh) pair reads its cache rows below cache_len once
// (2 * n_b * dh f32 for K and V) and does about 4 * dh operations per
// (position, query row); with G = 8 query rows per KV head that is 8 flops per
// byte read, far below the card's 20 fp32 flops per byte: bound by bytes. At
// the serve shape (B = 4, KH = 4, G = 8, dh = 64, S = 512) the cache of one
// layer is 4 MB, at the decode_32k shape (B = 8, S = 32,768) 537 MB.
//
// What the design does about it:
//  * The TPU grid's in-order carry does not translate: one CTA per (b, kh)
//    would leave 116 of the 132 SMs idle at B * KH = 16. So S is split into
//    chunks, one CTA per (chunk, b, kh); each keeps a partial (m, l, acc)
//    over its chunk, and a second small kernel merges the partials.
//  * A CTA holds the G query rows of one KV head, one warp per row, and
//    loads each K/V tile of 64 positions into shared memory once for all G
//    rows (16-byte global loads, one row of dh floats per position).
//  * A chunk stops at cache_len[b]: positions beyond it are never read, and
//    a chunk wholly beyond it writes an empty partial (m = -inf, l = 0).
//    For cache_len = 0 every position is masked alike, so the kernel reads
//    all S positions with equal scores (q taken as 0), which is what the
//    masked softmax gives.
// Scores use q pre-scaled by 1/sqrt(dh) and fmaf in depth order; the online
// softmax uses expf (not the fast intrinsic).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // cache positions per shared-memory tile

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (splits, B * KH), block 32 * G threads (warp g owns query row g).
// part_m / part_l: (splits, B, KH, G); part_acc: (splits, B, KH, G, DH).
template <int DH>
__global__ void __launch_bounds__(1024)
    da_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ lens,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int B, int S, int KH, int G, int chunk,
                    float scale) {
  constexpr int PER = DH / 32;   // output dims per lane
  constexpr int KS = DH + 1;     // padded K row: lane t reads row t conflict-free
  extern __shared__ float smem[];
  float* qs = smem;              // G * DH
  float* ks = qs + G * DH;       // TILE * KS
  float* vs = ks + TILE * KS;    // TILE * DH (16-byte aligned: G*DH, TILE*KS are multiples of 4)
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / KH, kh = bh % KH;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lens[b];
  const bool empty = len <= 0;
  const int n = empty ? S : min(len, S);
  const int start = j * chunk, end = min(start + chunk, n);
  const size_t row = (size_t)bh * G + g;                   // (b, kh, g)
  const size_t part = (size_t)j * B * KH * G + row;        // (j, b, kh, g)
  if (start >= end) {  // uniform over the block: the whole chunk is masked
    part_m[part] = -INFINITY;
    part_l[part] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) part_acc[part * DH + lane + 32 * i] = 0.f;
    return;
  }
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x)
    qs[i] = empty ? 0.f : q[(size_t)bh * G * DH + i] * scale;
  const size_t pos_stride = (size_t)KH * DH;  // floats between cache positions
  const float* kb = k + ((size_t)b * S * KH + kh) * DH;
  const float* vb = v + ((size_t)b * S * KH + kh) * DH;
  float m = -INFINITY, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int t0 = start; t0 < end; t0 += TILE) {
    const int nt = min(TILE, end - t0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < nt * (DH / 4); idx += blockDim.x) {
      const int r = idx / (DH / 4), c4 = idx % (DH / 4);
      const size_t off = (size_t)(t0 + r) * pos_stride;
      const float4 kv = reinterpret_cast<const float4*>(kb + off)[c4];
      const float4 vv = reinterpret_cast<const float4*>(vb + off)[c4];
      float* kr = ks + r * KS + 4 * c4;
      kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
      reinterpret_cast<float4*>(vs + r * DH)[c4] = vv;
    }
    __syncthreads();
    float s[TILE / 32];
    float tmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < TILE / 32; ++u) {
      const int t = lane + 32 * u;
      float dot = -INFINITY;
      if (t < nt) {
        dot = 0.f;
        const float* qr = qs + g * DH;
        const float* kr = ks + t * KS;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
      }
      s[u] = dot;
      tmax = fmaxf(tmax, dot);
    }
    const float m_new = fmaxf(m, warp_max(tmax));
    const float alpha = expf(m - m_new);   // 0 on the first tile (m = -inf)
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < TILE / 32; ++u) {
      s[u] = (lane + 32 * u < nt) ? expf(s[u] - m_new) : 0.f;
      psum += s[u];
    }
    l = alpha * l + warp_sum(psum);
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < TILE / 32; ++u) {
      const int tmax_u = min(32, nt - 32 * u);
      for (int src = 0; src < tmax_u; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[u], src);
        const float* vr = vs + (32 * u + src) * DH;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] = fmaf(p, vr[lane + 32 * i], acc[i]);
      }
    }
    m = m_new;
  }
  if (lane == 0) {
    part_m[part] = m;
    part_l[part] = l;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) part_acc[part * DH + lane + 32 * i] = acc[i];
}

// grid (B * KH), block 32 * G: merge the splits' partials of each row.
template <int DH>
__global__ void __launch_bounds__(1024)
    da_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, float* __restrict__ out, int rows,
                    int G, int splits) {
  constexpr int PER = DH / 32;
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * G + (threadIdx.x >> 5);
  float ms = -INFINITY;
  for (int j = 0; j < splits; ++j) ms = fmaxf(ms, part_m[(size_t)j * rows + row]);
  float l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int j = 0; j < splits; ++j) {
    const size_t p = (size_t)j * rows + row;
    const float mj = part_m[p];
    if (mj == -INFINITY) continue;  // an empty chunk
    const float w = expf(mj - ms);
    l = fmaf(w, part_l[p], l);
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = fmaf(w, part_acc[p * DH + lane + 32 * i], acc[i]);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < PER; ++i) out[row * DH + lane + 32 * i] = acc[i] * inv;
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const int* lens, float* part_m,
           float* part_l, float* part_acc, float* out, int B, int S, int KH, int G,
           int splits, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * DH + TILE * (DH + 1) + TILE * DH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        da_split_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  da_split_kernel<DH><<<dim3(splits, B * KH), 32 * G, smem, stream>>>(
      q, k, v, lens, part_m, part_l, part_acc, B, S, KH, G, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  da_merge_kernel<DH><<<B * KH, 32 * G, 0, stream>>>(part_m, part_l, part_acc, out,
                                                    B * KH * G, G, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, KH, G, DH) f32; k, v (B, S, KH, DH) f32; lens (B,) i32; out (B, KH, G,
// DH) f32. Scratch: part_m, part_l (splits, B, KH, G), part_acc (splits, B,
// KH, G, DH) f32. Chunk j covers positions [j * chunk, (j + 1) * chunk).
// Takes DH in {32, 64, 128} and 1 <= G <= 32. Returns the launch error, or 0.
extern "C" int decode_attention_launch(const float* q, const float* k, const float* v,
                                       const int* lens, float* part_m, float* part_l,
                                       float* part_acc, float* out, int B, int S, int KH,
                                       int G, int DH, int splits, int chunk, float scale,
                                       void* stream_handle) {
  if (B < 1 || S < 1 || KH < 1 || G < 1 || G > 32 || splits < 1 || chunk < 1 ||
      (long long)splits * chunk < S || B * KH > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (DH) {
    case 32:
      return launch<32>(q, k, v, lens, part_m, part_l, part_acc, out, B, S, KH, G, splits,
                        chunk, scale, stream);
    case 64:
      return launch<64>(q, k, v, lens, part_m, part_l, part_acc, out, B, S, KH, G, splits,
                        chunk, scale, stream);
    case 128:
      return launch<128>(q, k, v, lens, part_m, part_l, part_acc, out, B, S, KH, G, splits,
                         chunk, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
