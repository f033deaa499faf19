// STFT log-magnitude, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/stft.py::
// _bwd_kernel with its _overlap_add (called from _vjp_bwd): the cotangent of
// the signal (re, im) from the cotangent g (N, F, frames) of stft_fwd.cu's
// log-magnitude. With each frame's recomputed spectrum (Re, Im),
//
//     inv = mag^2 > 0 ? 1 / (mag (mag + eps) + 1e-30) : 0,  G = g inv (Re, Im)
//     dfr[i, m] = w[m] sum_k G[i, k] e^{+2 pi i k m / N}
//     dpad[p]   = sum over the frames i covering padded sample p of
//                 dfr[i, p - i hop]
//
// and the reflect padding folded back (JAX's unpad). The bases get no
// cotangent (constants, as in JAX). The TPU kernel carried the overlap-add's
// spill across its sequential grid; here each block owns a run of padded
// samples and recomputes the frames that cover them (stft_fft.cuh,
// bwd_kernel): both transforms and the overlap-add stay in the block, and
// no frame or spectrum goes to device memory. Its padding's sums go to the
// small edge buffer, which fold_kernel adds to their mirrors.

#include <cuda_runtime.h>

#include "stft_fft.cuh"

namespace {

template <int N>
cudaError_t launch(const float* re, const float* im, const float* window,
                   const float* twiddles, const float* g, float* dre,
                   float* dim, float* edges, int n, int t, int hop, int f,
                   int frames, int pad, int fftshift, float eps,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * stft_fft::bwd_smem_floats(N, hop, f);
  cudaError_t err = cudaFuncSetAttribute(
      stft_fft::bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int len = stft_fft::bwd_plan(N, hop).len;
  const int tp = t + 2 * pad;
  stft_fft::bwd_kernel<N>
      <<<dim3((tp + len - 1) / len, n), stft_fft::kThreads, smem, stream>>>(
          re, im, window, twiddles, g, dre, dim, edges, t, hop, f, frames,
          pad, fftshift, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || pad == 0) return err;
  const int count = stft_fft::fold_count(t, pad);
  stft_fft::fold_kernel<<<dim3((count + stft_fft::kThreads - 1) /
                                   stft_fft::kThreads,
                               n),
                          stft_fft::kThreads, 0, stream>>>(dre, dim, edges,
                                                           t, pad);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the first failed launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for an n_fft other than 64, 128, 256, 512,
// 1024). re/im (N, t) signal; window (n_fft); twiddles (n_fft, 2);
// g (N, F, frames); out dre/dim (N, t); edges (N, 2, 2, pad), the padding's
// sums (re, im; left, right).
extern "C" int stft_bwd_f32(const float* re, const float* im,
                            const float* window, const float* twiddles,
                            const float* g, float* dre, float* dim,
                            float* edges, int n, int t, int n_fft, int hop,
                            int f, int frames, int pad, int fftshift,
                            float eps, cudaStream_t stream) {
  switch (n_fft) {
    case 64:
      return launch<64>(re, im, window, twiddles, g, dre, dim, edges, n, t,
                        hop, f, frames, pad, fftshift, eps, stream);
    case 128:
      return launch<128>(re, im, window, twiddles, g, dre, dim, edges, n, t,
                         hop, f, frames, pad, fftshift, eps, stream);
    case 256:
      return launch<256>(re, im, window, twiddles, g, dre, dim, edges, n, t,
                         hop, f, frames, pad, fftshift, eps, stream);
    case 512:
      return launch<512>(re, im, window, twiddles, g, dre, dim, edges, n, t,
                         hop, f, frames, pad, fftshift, eps, stream);
    case 1024:
      return launch<1024>(re, im, window, twiddles, g, dre, dim, edges, n,
                          t, hop, f, frames, pad, fftshift, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
