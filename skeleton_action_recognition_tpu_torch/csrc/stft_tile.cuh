// The STFT tile shared by stft_fwd.cu and stft_bwd.cu: one block computes
// the complex STFT of TF = 64 frames x TB = 64 frequency bins of one
// signal, straight from the padded signal (frame i is samples [i hop,
// i hop + n_fft)):
//
//     Re[i, f] = sum_m fr_re[i, m] C[m, f] + fr_im[i, m] S[m, f]
//     Im[i, f] = sum_m fr_im[i, m] C[m, f] - fr_re[i, m] S[m, f]
//
// C, S (n_fft, F) are the windowed cos/sin bases, transposed, with the
// fftshift roll folded into their columns. This is the product of the
// frames with the packed (2 n_fft, 2F) bases [[C, -S], [S, C]] of
// skeleton_action_recognition_tpu/ops/pallas/stft.py::_pack_bases, taken
// as two (n_fft x F) halves so that a thread keeps the Re and Im of the
// same bins for the magnitude.
//
// f32 FMAs on the CUDA cores: no tensor cores, no TF32 (a TF32 or bf16
// pass gives near-zero bins a 0.3+ relative error, whose log then moves
// by O(1)). The block stages its signal span ((TF - 1) hop + n_fft samples
// of re and im; nothing of the (N, frames, n_fft) frames is ever stored)
// and the bases in chunks of KC samples. Thread (tx, ty) of 16 x 16 keeps
// frames ty + 16 a and bins tx + 16 b (a, b < 4) in registers: in the
// inner loop a warp reads two signal samples hop floats apart (different
// banks) and 16 consecutive basis entries (broadcast to both rows), so
// shared memory serves 8 loads per 32 FMAs without conflicts.

#pragma once

#include <cuda_runtime.h>

namespace stft {

constexpr int TF = 64;       // frames per block
constexpr int TB = 64;       // bins per block
constexpr int KC = 64;       // samples per basis chunk
constexpr int kThreads = 256;
constexpr int kRows = 4;     // frames (and bins) per thread

struct Acc {
  float re[kRows][kRows];
  float im[kRows][kRows];
};

// Floats of shared memory a block uses: the signal span of re and im and
// one basis chunk of C and S (the epilogues reuse the chunk).
__host__ __device__ inline int span(int n_fft, int hop) {
  return (TF - 1) * hop + n_fft;
}
__host__ __device__ inline size_t smem_floats(int n_fft, int hop) {
  const size_t basis = (size_t)2 * KC * TB;
  const size_t out = (size_t)2 * TB * (TF + 1);
  return (size_t)2 * span(n_fft, hop) + (basis > out ? basis : out);
}

// Compute the block's (frames i0.., bins f0..) tile of signal n into acc.
// smem is laid out as smem_floats says; the caller synchronises before
// reusing the basis chunk.
__device__ inline void stft_tile(const float* __restrict__ sig_re,
                                 const float* __restrict__ sig_im,
                                 const float* __restrict__ cs,
                                 const float* __restrict__ ss, float* smem,
                                 int n, int tp, int n_fft, int hop, int f,
                                 int i0, int f0, Acc& acc) {
  const int sp = span(n_fft, hop);
  float* s_re = smem;
  float* s_im = s_re + sp;
  float* s_c = s_im + sp;       // (KC, TB)
  float* s_s = s_c + KC * TB;   // (KC, TB)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const size_t row = (size_t)n * tp;
  const int start = i0 * hop;
  for (int i = tid; i < sp; i += blockDim.x) {
    const int p = start + i;
    s_re[i] = p < tp ? sig_re[row + p] : 0.0f;
    s_im[i] = p < tp ? sig_im[row + p] : 0.0f;
  }
  for (int a = 0; a < kRows; ++a) {
    for (int b = 0; b < kRows; ++b) {
      acc.re[a][b] = 0.0f;
      acc.im[a][b] = 0.0f;
    }
  }
  for (int m0 = 0; m0 < n_fft; m0 += KC) {
    __syncthreads();  // the previous chunk is consumed (and the span loaded)
    for (int i = tid; i < KC * TB; i += blockDim.x) {
      const int mm = i / TB, b = i % TB;
      const size_t at = (size_t)(m0 + mm) * f + f0 + b;
      s_c[i] = cs[at];
      s_s[i] = ss[at];
    }
    __syncthreads();
    for (int mm = 0; mm < KC; ++mm) {
      float xr[kRows], xi[kRows], cv[kRows], sv[kRows];
      for (int a = 0; a < kRows; ++a) {
        const int at = (ty + 16 * a) * hop + m0 + mm;
        xr[a] = s_re[at];
        xi[a] = s_im[at];
      }
      for (int b = 0; b < kRows; ++b) {
        cv[b] = s_c[mm * TB + tx + 16 * b];
        sv[b] = s_s[mm * TB + tx + 16 * b];
      }
      for (int a = 0; a < kRows; ++a) {
        for (int b = 0; b < kRows; ++b) {
          acc.re[a][b] += xr[a] * cv[b] + xi[a] * sv[b];
          acc.im[a][b] += xi[a] * cv[b] - xr[a] * sv[b];
        }
      }
    }
  }
  __syncthreads();  // the basis chunk is free for the epilogue
}

}  // namespace stft
