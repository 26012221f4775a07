// The `decode_attention` kernel's f32 instances and its C interface; the
// kernel and its design are in decode_attention.cuh.

#include "decode_attention.cuh"

using namespace da;

namespace da {

cudaError_t make_plan_any(int B, int S, int KH, int G, int DH, int elem_bytes, int* grid,
                          int* smem) {
  if (elem_bytes == 2) return make_plan_bf16(B, S, KH, G, DH, grid, smem);
  if (elem_bytes != 4) return cudaErrorInvalidValue;
  return make_plan<float>(B, S, KH, G, DH, grid, smem);
}

}  // namespace da


// Floats of partial-state scratch a call needs, (rows + grid) slots of
// GB * (DHP + 2) (DHP the padded row width), or -1 for shapes the kernel does
// not take (or a runtime error). A function of the shapes, the element size
// and the current device only, so the scratch can be allocated without a
// host sync.
extern "C" long long decode_attention_scratch_floats(int B, int S, int KH, int G, int DH,
                                                     int elem_bytes) {
  int grid = 0, smem = 0;
  if (make_plan_any(B, S, KH, G, DH, elem_bytes, &grid, &smem) != cudaSuccess) return -1;
  const int gb = group_rows(G);
  const int dhp = row_chunks(DH, elem_bytes) * 16 / elem_bytes;
  const long long rows = (long long)B * KH * ((G + gb - 1) / gb);
  return (rows + grid) * gb * (dhp + 2);
}

// q (B, KH, G, DH); k, v (B, S, KH, DH), all f32 (elem_bytes 4) or all bf16
// (elem_bytes 2); lens (B,) i32; out (B, KH, G, DH) in their dtype, or f32
// when lse is given; lse (B, KH, G) f32, or null for none. `part` holds
// decode_attention_scratch_floats(...) floats; `tickets` at least B * KH * G
// ints, all zero (the kernel leaves them zero). Takes DH a multiple of 8 from
// 8 to 128, 1 <= G <= 32 and B <= 4096. Returns the launch error, or 0.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lens, float* part, int* tickets, void* out,
                                       float* lse, int B, int S, int KH, int G, int DH,
                                       int elem_bytes, float scale, void* stream_handle) {
  int grid = 0, smem = 0;
  const cudaError_t e = make_plan_any(B, S, KH, G, DH, elem_bytes, &grid, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gb = group_rows(G);
  const size_t rows = (size_t)B * KH * ((G + gb - 1) / gb);
  const int dhp = row_chunks(DH, elem_bytes) * 16 / elem_bytes;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lens = lens;
  p.part_acc = part;
  p.part_ml = part + (rows + grid) * gb * dhp;
  p.tickets = tickets;
  p.out = out;
  p.lse = lse;
  p.B = B;
  p.S = S;
  p.KH = KH;
  p.G = G;
  p.n_rg = (G + gb - 1) / gb;
  p.dh = DH;
  p.cr = DH * elem_bytes / 16;
  p.scale = scale;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const cudaError_t le = elem_bytes == 2 ? launch_bf16(p, gb, grid, smem, stream)
                                          : launch<float>(p, gb, grid, smem, stream);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}
