// STFT log-magnitude, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/stft.py::
// _fwd_kernel (called from _fwd_impl): the complex STFT of a signal given
// as two real channels (re, im), its magnitude and log,
//
//     out[n, row(k), i] = log(|sum_m x[i hop + m] w[m] e^{-2 pi i k m / N}| + eps)
//
// for frames i of the signal reflect-padded by `pad` (N / 2 when the STFT
// is centered, else 0), bins k < F, and row(k) = (k + F / 2) mod F under
// fftshift, else k: the (N, F, frames) layout of the XLA path. The TPU
// kernel contracted polyphase frames with the windowed bases on its matrix
// unit; here each frame is an FFT in the block (stft_fft.cuh, fwd_kernel),
// which bytes, not operations, bound on the H100.

#include <cuda_runtime.h>

#include "stft_fft.cuh"

namespace {

template <int N>
cudaError_t launch(const float* re, const float* im, const float* window,
                   const float* twiddles, float* out, int n, int t, int hop,
                   int f, int frames, int pad, int fftshift, float eps,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * stft_fft::fwd_smem_floats(N, hop);
  cudaError_t err = cudaFuncSetAttribute(
      stft_fft::fwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int fg = stft_fft::frames_per_round(N);
  const dim3 grid((frames + fg - 1) / fg, n);
  stft_fft::fwd_kernel<N><<<grid, stft_fft::kThreads, smem, stream>>>(
      re, im, window, twiddles, out, t, hop, f, frames, pad, fftshift, eps);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for an n_fft other than 64, 128, 256, 512, 1024).
// re/im (N, t) signal; window (n_fft); twiddles (n_fft, 2) (cos, sin) of
// 2 pi e / n_fft; out (N, F, frames).
extern "C" int stft_fwd_f32(const float* re, const float* im,
                            const float* window, const float* twiddles,
                            float* out, int n, int t, int n_fft, int hop,
                            int f, int frames, int pad, int fftshift,
                            float eps, cudaStream_t stream) {
  switch (n_fft) {
    case 64:
      return launch<64>(re, im, window, twiddles, out, n, t, hop, f, frames,
                        pad, fftshift, eps, stream);
    case 128:
      return launch<128>(re, im, window, twiddles, out, n, t, hop, f, frames,
                         pad, fftshift, eps, stream);
    case 256:
      return launch<256>(re, im, window, twiddles, out, n, t, hop, f, frames,
                         pad, fftshift, eps, stream);
    case 512:
      return launch<512>(re, im, window, twiddles, out, n, t, hop, f, frames,
                         pad, fftshift, eps, stream);
    case 1024:
      return launch<1024>(re, im, window, twiddles, out, n, t, hop, f,
                          frames, pad, fftshift, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
