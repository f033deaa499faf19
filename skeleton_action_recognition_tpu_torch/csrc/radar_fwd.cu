// Spline radar return, forward (kernel #6), for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/radar.py::
// _radar_spline_kernel (called from _spline_fwd_impl). The kernel,
// what bounds it and its design are in radar_spline.cuh (fwd_kernel).

#include <cuda_runtime.h>

#include "radar_spline.cuh"

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// e (num_tiles, ns4, tile); src/dst (n, num_tiles, 3 em, ns4); c (n, em);
// loc (3,); lam (); re/im (n, t_out).
extern "C" int radar_fwd_f32(const float* e, const float* src,
                             const float* dst, const float* c,
                             const float* loc, const float* lam, float* re,
                             float* im, int n, int num_tiles, int ns4,
                             int tile, int em, int t_out,
                             cudaStream_t stream) {
  const size_t smem = radar_spline::fwd_smem_bytes(ns4, em);
  cudaError_t err = cudaFuncSetAttribute(
      radar_spline::fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  radar_spline::fwd_kernel<<<dim3(num_tiles, n), radar_spline::kFwdThreads,
                             smem, stream>>>(e, src, dst, c, loc, lam, re,
                                             im, num_tiles, ns4, tile, em,
                                             t_out);
  return cudaGetLastError();
}
