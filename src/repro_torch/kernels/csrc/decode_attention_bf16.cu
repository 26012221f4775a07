// The `decode_attention` kernel's bf16 instances (compiled apart from the f32
// ones in decode_attention.cu, in parallel); the kernel is in
// decode_attention.cuh.

#include "decode_attention.cuh"

namespace da {

cudaError_t make_plan_bf16(int B, int S, int KH, int G, int DH, int* grid, int* smem) {
  return make_plan<__nv_bfloat16>(B, S, KH, G, DH, grid, smem);
}

cudaError_t launch_bf16(const Params& p, int gb, int grid, int smem, cudaStream_t stream) {
  return launch<__nv_bfloat16>(p, gb, grid, smem, stream);
}

}  // namespace da
