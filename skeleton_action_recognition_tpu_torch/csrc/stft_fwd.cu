// STFT log-magnitude, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/stft.py::
// _fwd_kernel (called from _fwd_impl): the complex STFT of a signal given
// as two real channels (re, im), its magnitude and log:
//
//     out[n, f, i] = log(sqrt(Re[i, f]^2 + Im[i, f]^2) + eps)
//
// for frames i of the padded signal (the wrapper reflect-pads it when the
// STFT is centered) and bins f whose basis columns already carry the
// fftshift roll. Output in the (N, F, frames) layout of the XLA path.
//
// What bounds it on the H100: f32 FMAs. At the production shape (N = 16,
// T = 75,000, n_fft = 256, hop = 16, F = 256: 4,688 frames) the product is
// 16 x 4,688 x 256 x 1,024 FMAs = 39.3 GFLOP, against 4.8 MB of signal in
// and 77 MB of spectrogram out; at the f32 CUDA-core peak (67 TFLOP/s at
// 700 W) that is ~0.6 ms, at the memory peak ~0.03 ms. The TPU kernel
// built frames by polyphase reshapes for the MXU; here the tile in
// stft_tile.cuh reads frames straight from the block's staged signal
// span, and the epilogue transposes the block's (frames x bins) tile
// through shared memory so that the (N, F, frames) output is written with
// consecutive threads on consecutive frames.

#include <cuda_runtime.h>

#include "stft_tile.cuh"

namespace {

__global__ void __launch_bounds__(stft::kThreads)
stft_fwd_kernel(const float* __restrict__ sig_re,
                const float* __restrict__ sig_im,
                const float* __restrict__ cs, const float* __restrict__ ss,
                float* __restrict__ out, int tp, int n_fft, int hop, int f,
                int frames, float eps) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * stft::TF;
  const int f0 = blockIdx.y * stft::TB;
  const int n = blockIdx.z;
  stft::Acc acc;
  stft::stft_tile(sig_re, sig_im, cs, ss, smem, n, tp, n_fft, hop, f, i0, f0,
                  acc);

  // (bins, frames) tile in the basis chunk's space
  float* s_out = smem + 2 * stft::span(n_fft, hop);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int a = 0; a < stft::kRows; ++a) {
    for (int b = 0; b < stft::kRows; ++b) {
      const float re = acc.re[a][b], im = acc.im[a][b];
      s_out[(tx + 16 * b) * (stft::TF + 1) + ty + 16 * a] =
          logf(sqrtf(re * re + im * im) + eps);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < stft::TB * stft::TF; i += blockDim.x) {
    const int b = i / stft::TF, a = i % stft::TF;
    if (i0 + a < frames) {
      out[((size_t)n * f + f0 + b) * frames + i0 + a] =
          s_out[b * (stft::TF + 1) + a];
    }
  }
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// sig_re/sig_im (N, tp) padded signal; cs/ss (n_fft, F); out (N, F, frames).
extern "C" int stft_fwd_f32(const float* sig_re, const float* sig_im,
                            const float* cs, const float* ss, float* out,
                            int n, int tp, int n_fft, int hop, int f,
                            int frames, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * stft::smem_floats(n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      stft_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((frames + stft::TF - 1) / stft::TF, f / stft::TB, n);
  stft_fwd_kernel<<<grid, stft::kThreads, smem, stream>>>(
      sig_re, sig_im, cs, ss, out, tp, n_fft, hop, f, frames, eps);
  return cudaGetLastError();
}
