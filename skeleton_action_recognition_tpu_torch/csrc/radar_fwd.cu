// Spline radar return, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/radar.py::
// _radar_spline_kernel (called from _spline_fwd_impl). For sample n and
// padded time row t = j * tile + r, every edge-body pair's endpoints are
// one cubic of the smoothed, upsampled spline:
//
//     s[f](t) = sum_q src[n, j, f, q] * e[j, q, r]       (f = coord * EM + em)
//
// and the return is re + i im = sum_em amp(s, d, c) exp(i phase(s)) with
// the math of radar_math.cuh. Inputs: monomials e (num_tiles, ns4, tile),
// the tiles' coefficients src/dst (N, num_tiles, 3 EM, ns4), c (N, EM),
// loc (3,) and lambda (a scalar) on the device. Output re, im (N, t_out):
// rows past t_out (the grid padding, whose monomials are zero) are cut, as
// the JAX caller cuts them.
//
// What bounds it on the H100: arithmetic on the CUDA cores. Each of the
// N * t_out * EM = 57.6 M (sample, edge-body) pairs at the production
// shape (N = 16, t_out = 75,000, EM = 48) costs three square roots, two
// divisions and a precise sincosf of a phase up to ~1e5 rad (its fast
// range reduction holds to |x| ~ 1e5; larger phases, from joints more than
// ~4.2 m from the radar at lambda = 5e-4, take the slow path), about 150
// instructions; the bytes are ~20 MB. The design keeps everything else off
// that path:
//   * the TPU contracted a (3 EM, 4 NS) x (4 NS, TILE) monomial matrix on
//     the MXU; here each row evaluates only its own spline segment, four
//     terms a coordinate, found from the one-hot monomials (the other
//     slots are exact zeros, so the sum is the same contraction);
//   * one block per (tile, sample) stages the tile's coefficients (2 x 144
//     x 16 f32 = 18 KB) and sqrt(pi c) in shared memory, where each warp
//     reads them as broadcasts (its rows share a segment);
//   * each thread keeps its row's re and im in registers over the 48
//     pairs and writes them once.

#include <cuda_runtime.h>

#include "radar_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
radar_fwd_kernel(const float* __restrict__ e, const float* __restrict__ src,
                 const float* __restrict__ dst, const float* __restrict__ cvec,
                 const float* __restrict__ loc, const float* __restrict__ lam,
                 float* __restrict__ re_out, float* __restrict__ im_out,
                 int num_tiles, int ns4, int tile, int em, int t_out) {
  extern __shared__ float smem[];
  const int j = blockIdx.x;
  const int n = blockIdx.y;
  const int f3 = 3 * em;
  float* s_src = smem;                // (3 EM, ns4)
  float* s_dst = s_src + f3 * ns4;    // (3 EM, ns4)
  float* s_c = s_dst + f3 * ns4;      // (EM,)
  float* s_amp0 = s_c + em;           // (EM,): sqrt(pi c)

  const size_t coef_base = ((size_t)n * num_tiles + j) * f3 * ns4;
  for (int i = threadIdx.x; i < f3 * ns4; i += blockDim.x) {
    s_src[i] = src[coef_base + i];
    s_dst[i] = dst[coef_base + i];
  }
  for (int i = threadIdx.x; i < em; i += blockDim.x) {
    const float c = cvec[(size_t)n * em + i];
    s_c[i] = c;
    s_amp0[i] = sqrtf(radar::kPi * c);
  }
  __syncthreads();

  const float lam_v = lam[0];
  const float k = radar::kFourPi / lam_v;
  const radar::Point l = {loc[0], loc[1], loc[2]};
  const float* e_tile = e + (size_t)j * ns4 * tile;

  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int row = j * tile + r;
    if (row >= t_out) break;
    float m[4];
    const int slot = radar::row_slot(e_tile, ns4, tile, r, m);
    float re = 0.0f, im = 0.0f;
    if (slot >= 0) {
      for (int p = 0; p < em; ++p) {
        const radar::Point s = {
            radar::eval_cubic(s_src, ns4, p, slot, m),
            radar::eval_cubic(s_src, ns4, em + p, slot, m),
            radar::eval_cubic(s_src, ns4, 2 * em + p, slot, m)};
        const radar::Point d = {
            radar::eval_cubic(s_dst, ns4, p, slot, m),
            radar::eval_cubic(s_dst, ns4, em + p, slot, m),
            radar::eval_cubic(s_dst, ns4, 2 * em + p, slot, m)};
        float amp, phase, sinp, cosp;
        radar::scatter_fwd(l, s, d, s_c[p], s_amp0[p], k, amp, phase);
        sincosf(phase, &sinp, &cosp);
        re += amp * cosp;
        im += amp * sinp;
      }
    }
    re_out[(size_t)n * t_out + row] = re;
    im_out[(size_t)n * t_out + row] = im;
  }
}

size_t smem_bytes(int ns4, int em) {
  return sizeof(float) * ((size_t)2 * 3 * em * ns4 + 2 * em);
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int radar_fwd_f32(const float* e, const float* src,
                             const float* dst, const float* c,
                             const float* loc, const float* lam, float* re,
                             float* im, int n, int num_tiles, int ns4,
                             int tile, int em, int t_out,
                             cudaStream_t stream) {
  const size_t smem = smem_bytes(ns4, em);
  cudaError_t err = cudaFuncSetAttribute(
      radar_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_tiles, n);
  radar_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      e, src, dst, c, loc, lam, re, im, num_tiles, ns4, tile, em, t_out);
  return cudaGetLastError();
}
