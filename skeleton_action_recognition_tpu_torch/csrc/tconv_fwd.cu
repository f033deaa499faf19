// Fused temporal chain of an ST-GCN block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/
// tconv.py::_fwd_kernel (affine_relu_tconv). For s (NM, T, V, C):
//
//     h = relu(s * scale + shift)                   (BN1's normalize, folded)
//     u = conv9x1(h) + bias                          (SAME, stride 1)
//     sums[0][c] = sum u[.., c],  sums[1][c] = sum u[.., c]^2
//
// with the sums over every (clip, frame, joint) row, in f32, on u rounded to
// s's dtype (BN2's batch statistics without reading u back). The unfused
// chain writes the normalized and the ReLU'd activations and reads the
// conv's output twice more; here h never leaves shared memory and u is
// written once. tconv_tile.cuh holds the f32 tile kernel (CUDA cores), its
// design and what bounds it, and tconv_mma.cuh the bf16 one (tensor cores);
// channel_sums.cuh adds the per-block partials of the sums in a fixed order,
// so repeats are bit-identical.

#include "channel_sums.cuh"
#include "tconv_mma.cuh"
#include "tconv_tile.cuh"

namespace {

// The channel sums from the tile kernel's parts partials, once its launch
// (err) went through.
int sum_partials(cudaError_t err, void* ws, int parts, int c, void* sums,
                 cudaStream_t stream) {
  if (err != cudaSuccess) return int(err);
  return int(channel_sums::launch(static_cast<const float*>(ws), parts,
                                  2 * c, static_cast<float*>(sums), stream));
}

}  // namespace

// s: (nm, t_len, 25, c) in T; w: the forward's weight operand, the f32
// route's (c, 9, c) f32 w[ci][dt][co] = W[co, ci, dt], the bf16 route's
// (9, c, c) bf16 w[dt][co][ci] = W[co, ci, dt]; scale, shift, bias: (c,)
// f32. Out: u like s; sums (2 * c,) f32, the sums of u then of u^2 per
// channel. ws: 2 * c f32 of workspace for each tile, ceil(25 nm / 24) *
// ceil(t_len / 16) tiles in f32 (tconv_tile.cuh's tile_grid), nm *
// ceil(25 * t_len / 512) in bf16. All contiguous, nm * t_len >= 1.
// Returns the first cudaError_t (0 on success).
extern "C" int tconv_fwd_f32(const void* s, const void* w, const void* scale,
                             const void* shift, const void* bias, void* u,
                             void* ws, void* sums, int nm, int t_len, int c,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tconv::launch_tile<tconv::MODE_FWD>(
      static_cast<const float*>(s), nullptr, static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(bias), static_cast<float*>(u),
      static_cast<float*>(ws), nm, t_len, c, st);
  return sum_partials(err, ws, tconv::tile_grid(nm, t_len, c).x, c, sums, st);
}

extern "C" int tconv_fwd_bf16(const void* s, const void* w, const void* scale,
                              const void* shift, const void* bias, void* u,
                              void* ws, void* sums, int nm, int t_len, int c,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tconv_mma::launch_tile<tconv::MODE_FWD>(
      static_cast<const __nv_bfloat16*>(s), nullptr,
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(u), static_cast<float*>(ws), nm, t_len, c,
      st);
  return sum_partials(err, ws, tconv_mma::tile_parts(nm, t_len), c, sums,
                      st);
}
