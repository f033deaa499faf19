// Spline radar return, backward (kernel #7), for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/radar.py::
// _radar_spline_bwd_kernel (called from _spline_vjp_bwd): the VJP of
// radar_fwd.cu's return with respect to the tiles' coefficients src/dst,
// c, loc and lambda (the monomials e get no cotangent: a constant, as in
// JAX). Two instances of radar_spline.cuh's bwd_kernel, each followed by
// its reduce_kernel: radar_bwd_f32 computes all five cotangents, as the
// TPU kernel does; radar_bwd_loc_lam_f32 only dloc and dlambda, for a
// caller whose coefficients and c need no gradient (the spectrogram
// trainer's: its joints are data). The kernels, what bounds them and
// their design are in radar_spline.cuh.

#include <cuda_runtime.h>

#include "radar_spline.cuh"

namespace {

template <bool kCoef>
cudaError_t launch(const float* e, const float* src, const float* dst,
                   const float* c, const float* loc, const float* lam,
                   const float* gre, const float* gim, float* dsrc,
                   float* ddst, float* dc, float* dloc, float* dlam,
                   float* ws_dc, float* ws_s, int n, int num_tiles, int ns4,
                   int tile, int em, int t_out, cudaStream_t stream) {
  namespace rs = radar_spline;
  const size_t smem = rs::bwd_smem_bytes(ns4, tile, em, kCoef);
  cudaError_t err = cudaFuncSetAttribute(
      rs::bwd_kernel<kCoef>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  rs::bwd_kernel<kCoef><<<dim3(num_tiles, n), rs::kBwdThreads, smem,
                          stream>>>(e, src, dst, c, loc, lam, gre, gim, dsrc,
                                    ddst, ws_dc, ws_s, num_tiles, ns4, tile,
                                    em, t_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rs::reduce_kernel<kCoef><<<rs::reduce_blocks(n, em, kCoef),
                             rs::kReduceThreads, 0, stream>>>(
      ws_dc, ws_s, dc, dloc, dlam, n, num_tiles, em);
  return cudaGetLastError();
}

}  // namespace

// All five cotangents. Launch both kernels on `stream`; returns the first
// failed launch's cudaError_t (0 on success). dsrc/ddst as src; dc (n,
// em); dloc (3,); dlam (); workspaces ws_dc n * num_tiles * em floats, ws_s
// n * num_tiles * 4.
extern "C" int radar_bwd_f32(const float* e, const float* src,
                             const float* dst, const float* c,
                             const float* loc, const float* lam,
                             const float* gre, const float* gim, float* dsrc,
                             float* ddst, float* dc, float* dloc, float* dlam,
                             float* ws_dc, float* ws_s, int n, int num_tiles,
                             int ns4, int tile, int em, int t_out,
                             cudaStream_t stream) {
  return launch<true>(e, src, dst, c, loc, lam, gre, gim, dsrc, ddst, dc,
                      dloc, dlam, ws_dc, ws_s, n, num_tiles, ns4, tile, em,
                      t_out, stream);
}

// dloc and dlambda alone, the same bits as radar_bwd_f32's; the workspace
// ws_s as there.
extern "C" int radar_bwd_loc_lam_f32(const float* e, const float* src,
                                     const float* dst, const float* c,
                                     const float* loc, const float* lam,
                                     const float* gre, const float* gim,
                                     float* dloc, float* dlam, float* ws_s,
                                     int n, int num_tiles, int ns4, int tile,
                                     int em, int t_out, cudaStream_t stream) {
  return launch<false>(e, src, dst, c, loc, lam, gre, gim, nullptr, nullptr,
                       nullptr, dloc, dlam, nullptr, ws_s, n, num_tiles, ns4,
                       tile, em, t_out, stream);
}
