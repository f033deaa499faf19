// STFT log-magnitude, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/stft.py::
// _bwd_kernel with its _overlap_add (called from _vjp_bwd): the cotangent of
// the signal (re, im) from the cotangent g (N, F, frames) of stft_fwd.cu's
// log-magnitude. With the recomputed (Re, Im) of each frame and bin,
//
//     inv = mag^2 > 0 ? 1 / (mag (mag + eps) + 1e-30) : 0,  G = g inv (Re, Im)
//     dfr[i, :] = [G_re | G_im] @ [[C^T, S^T], [-S^T, C^T]]   (2 n_fft wide)
//     dsig[p]  = sum over the frames i covering sample p of dfr[i, p - i hop]
//
// and the reflect padding folded back (JAX's unpad). The bases get no
// cotangent (constants, as in JAX).
//
// What bounds it on the H100: f32 FMAs, twice the forward's (the forward
// product is recomputed, then the transposed one: 2 x 39.3 GFLOP at the
// production shape), plus ~0.6 GB of workspace traffic (~0.2 ms). The TPU
// kernel carried the (n_fft - hop)-sample spill of its overlap-add across
// its sequential grid; blocks here run in no order, so the frame
// cotangents go to a workspace and a second pass gathers them:
//   1. stft_bwd_grad_kernel: the forward tile (stft_tile.cuh) of
//      64 frames x 64 bins, then G for those bins into the workspace gbuf
//      (N, frames, 2F), with g read through shared memory in the
//      (N, F, frames) layout;
//   2. stft_bwd_frames_kernel: dfr (N * frames, 2 n_fft) = gbuf (N * frames,
//      2F) @ kb (2F, 2 n_fft), a 64 x 64-tiled f32 product on the CUDA
//      cores (kb: the packed, fftshift-rolled bases [[C', S'], [-S', C']]);
//   3. stft_bwd_ola_kernel: one thread per output sample sums the (at most
//      n_fft / hop = 16) frames covering it in frame order, and adds the
//      reflected samples' sums as JAX's unpad does.
// Every sum runs in an order fixed by the shapes, so two launches agree
// bit for bit.

#include <cuda_runtime.h>

#include "stft_tile.cuh"

namespace {

constexpr int GEMM_T = 64;   // rows and columns per block
constexpr int GEMM_K = 32;   // reduction chunk
constexpr int kOlaThreads = 256;

__global__ void __launch_bounds__(stft::kThreads)
stft_bwd_grad_kernel(const float* __restrict__ sig_re,
                     const float* __restrict__ sig_im,
                     const float* __restrict__ cs,
                     const float* __restrict__ ss,
                     const float* __restrict__ g, float* __restrict__ gbuf,
                     int tp, int n_fft, int hop, int f, int frames,
                     float eps) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * stft::TF;
  const int f0 = blockIdx.y * stft::TB;
  const int n = blockIdx.z;
  stft::Acc acc;
  stft::stft_tile(sig_re, sig_im, cs, ss, smem, n, tp, n_fft, hop, f, i0, f0,
                  acc);

  float* s_g = smem + 2 * stft::span(n_fft, hop);  // (bins, frames)
  for (int i = threadIdx.x; i < stft::TB * stft::TF; i += blockDim.x) {
    const int b = i / stft::TF, a = i % stft::TF;
    s_g[b * (stft::TF + 1) + a] =
        i0 + a < frames ? g[((size_t)n * f + f0 + b) * frames + i0 + a]
                        : 0.0f;
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int a = 0; a < stft::kRows; ++a) {
    const int frame = i0 + ty + 16 * a;
    if (frame >= frames) continue;
    float* row = gbuf + ((size_t)n * frames + frame) * 2 * f;
    for (int b = 0; b < stft::kRows; ++b) {
      const float re = acc.re[a][b], im = acc.im[a][b];
      const float mag2 = re * re + im * im;
      const float mag = sqrtf(mag2);
      // d log(mag + eps) / d re = re / (mag (mag + eps)); a zero bin gets
      // a zero cotangent, not NaN
      const float inv = mag2 > 0.0f ? 1.0f / (mag * (mag + eps) + 1e-30f)
                                    : 0.0f;
      const float gg = s_g[(tx + 16 * b) * (stft::TF + 1) + ty + 16 * a] * inv;
      row[f0 + tx + 16 * b] = gg * re;
      row[f + f0 + tx + 16 * b] = gg * im;
    }
  }
}

// d (rows, cols) = a (rows, k) @ b (k, cols); k % GEMM_K == 0 and
// cols % GEMM_T == 0; rows are masked.
__global__ void __launch_bounds__(256)
stft_bwd_frames_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ d,
                       int rows, int k, int cols) {
  __shared__ float s_a[GEMM_K * (GEMM_T + 1)];  // [kk][row], padded
  __shared__ float s_b[GEMM_K * GEMM_T];        // [kk][col]
  const int r0 = blockIdx.x * GEMM_T;
  const int c0 = blockIdx.y * GEMM_T;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += GEMM_K) {
    for (int i = tid; i < GEMM_T * GEMM_K; i += blockDim.x) {
      const int rr = i / GEMM_K, kk = i % GEMM_K;
      s_a[kk * (GEMM_T + 1) + rr] =
          r0 + rr < rows ? a[(size_t)(r0 + rr) * k + k0 + kk] : 0.0f;
    }
    for (int i = tid; i < GEMM_K * GEMM_T; i += blockDim.x) {
      const int kk = i / GEMM_T, cc = i % GEMM_T;
      s_b[i] = b[(size_t)(k0 + kk) * cols + c0 + cc];
    }
    __syncthreads();
    for (int kk = 0; kk < GEMM_K; ++kk) {
      float av[4], bv[4];
      for (int x = 0; x < 4; ++x) {
        av[x] = s_a[kk * (GEMM_T + 1) + ty + 16 * x];
        bv[x] = s_b[kk * GEMM_T + tx + 16 * x];
      }
      for (int x = 0; x < 4; ++x) {
        for (int y = 0; y < 4; ++y) acc[x][y] += av[x] * bv[y];
      }
    }
    __syncthreads();
  }
  for (int x = 0; x < 4; ++x) {
    const int r = r0 + ty + 16 * x;
    if (r >= rows) continue;
    for (int y = 0; y < 4; ++y) {
      d[(size_t)r * cols + c0 + tx + 16 * y] = acc[x][y];
    }
  }
}

// Overlap-add of one padded sample p's frames, in frame order; off selects
// the re (0) or im (n_fft) half of dfr's rows.
__device__ inline float frames_at(const float* __restrict__ dfr, int n,
                                  int frames, int n_fft, int hop, int p,
                                  int off) {
  const int hi = min(frames - 1, p / hop);
  const int lo = p >= n_fft ? (p - n_fft) / hop + 1 : 0;
  float acc = 0.0f;
  for (int i = lo; i <= hi; ++i) {
    acc += dfr[((size_t)n * frames + i) * 2 * n_fft + off + p - i * hop];
  }
  return acc;
}

__global__ void __launch_bounds__(kOlaThreads)
stft_bwd_ola_kernel(const float* __restrict__ dfr, float* __restrict__ dre,
                    float* __restrict__ dim, int t, int n_fft, int hop,
                    int frames, int pad) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (s >= t) return;
  for (int part = 0; part < 2; ++part) {
    const int off = part * n_fft;
    float v = frames_at(dfr, n, frames, n_fft, hop, s + pad, off);
    if (pad > 0) {
      // reflect padding: padded sample pad - s mirrors s (1 <= s <= pad),
      // and 2 (t - 1) + pad - s mirrors it at the end (t-1-pad <= s <= t-2)
      if (s >= 1 && s <= pad) {
        v += frames_at(dfr, n, frames, n_fft, hop, pad - s, off);
      }
      if (s >= t - 1 - pad && s <= t - 2) {
        v += frames_at(dfr, n, frames, n_fft, hop, 2 * (t - 1) + pad - s,
                       off);
      }
    }
    (part == 0 ? dre : dim)[(size_t)n * t + s] = v;
  }
}

}  // namespace

// Launch the three kernels on `stream`; returns the first failed launch's
// cudaError_t (0 on success). sig_re/sig_im (N, tp) padded signal, cs/ss
// (n_fft, F), kb (2F, 2 n_fft), g (N, F, frames); workspaces gbuf (N,
// frames, 2F) and dfr (N, frames, 2 n_fft); out dre/dim (N, t) with t =
// tp - 2 pad.
extern "C" int stft_bwd_f32(const float* sig_re, const float* sig_im,
                            const float* cs, const float* ss, const float* kb,
                            const float* g, float* gbuf, float* dfr,
                            float* dre, float* dim, int n, int tp, int t,
                            int n_fft, int hop, int f, int frames, int pad,
                            float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * stft::smem_floats(n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      stft_bwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((frames + stft::TF - 1) / stft::TF, f / stft::TB, n);
  stft_bwd_grad_kernel<<<grid, stft::kThreads, smem, stream>>>(
      sig_re, sig_im, cs, ss, g, gbuf, tp, n_fft, hop, f, frames, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = n * frames;
  stft_bwd_frames_kernel<<<dim3((rows + GEMM_T - 1) / GEMM_T,
                                2 * n_fft / GEMM_T),
                           256, 0, stream>>>(gbuf, kb, dfr, rows, 2 * f,
                                             2 * n_fft);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stft_bwd_ola_kernel<<<dim3((t + kOlaThreads - 1) / kOlaThreads, n),
                        kOlaThreads, 0, stream>>>(dfr, dre, dim, t, n_fft,
                                                  hop, frames, pad);
  return cudaGetLastError();
}
