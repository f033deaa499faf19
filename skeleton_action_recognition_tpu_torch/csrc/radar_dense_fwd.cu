// Dense-operator radar return, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/radar.py::
// _radar_kernel (called from _kernel_fwd_impl). For sample n and output
// row t < t_out, every edge-body pair's endpoints are rows of a dense
// resampling operator w (T_w >= t_out rows, T_in columns) contracted with
// the sample's gathered features src/dst (N, T_in, 3 EM), laid out as
// [x | y | z] blocks of EM columns, over the row block's band of columns
// (radar_dense_tile.cuh; `band` (tiles, 2) from ops/radar.py::dense_band),
// and the return is re + i im = sum_p amp(s, d, c) exp(i phase(s)) with
// the math of radar_math.cuh. Inputs c (N, EM), loc (3,) and lambda (a
// scalar) stay on the device. Output re, im (N, t_out): rows of w past
// t_out (the JAX caller's padding) are never read.
//
// Precision: both contractions are f32 FMAs in k order. The JAX kernel
// pins the src contraction at HIGHEST and leaves dst at the default
// precision, a bf16 pass on the TPU (exact f32 in interpret mode); here
// both are f32, no TF32 and no tensor cores.
//
// What bounds it on the H100: the two contractions over the band, 4 N
// t_out W 3 EM FLOP with W the mean band of a 64-row block (W = 38.7 of
// T_in = 300 at the trainer's shape N = 16, t_out = 75,000, EM = 48: 26.7
// GFLOP, ~0.40 ms at the 67 TFLOP/s f32 peak of the CUDA cores; dense, 207
// GFLOP and ~3.1 ms); the per-pair math (57.6 M pairs, each three square
// roots, two divisions and a precise sincosf) adds ~0.05 ms at that peak,
// and the bytes (the band's 12 MB of the 90 MB operator, 5.5 MB of
// features, 9.6 MB out) ~0.01 ms. The wrapper's band pass reads the whole
// operator once more. The design:
//   * the operator is banded: the smoothing and the spline's decay leave
//     most of a row below f32 rounding of a position (52.6% of the trainer's
//     operator is exactly zero), so a block contracts only its band, ~3
//     steps of 16, and reads ~1/8 of the operator;
//   * the TPU block, a (512, T_in) operator tile against the sample's whole
//     features, does not fit a block's 227 KB of shared memory (614 KB and
//     173 KB a feature set); the block walks its band in steps of 16, as a
//     GEMM does, and keeps a 64-row x 288-coordinate position tile in
//     registers, 96 accumulators a thread (radar_dense_tile.cuh);
//   * each thread owns its pairs' six coordinates, so the per-pair math
//     runs on the accumulators, and each row sums its pairs in a fixed
//     order: a thread's four, then the pair groups in order, through
//     shared memory;
//   * blockIdx.x is the sample: blocks that run at once share an operator
//     band in L2, so the operator is read from device memory about once.

#include <cuda_runtime.h>

#include "radar_dense_tile.cuh"
#include "radar_math.cuh"

namespace {

using radar_dense::kPairsPerThread;
using radar_dense::kRowGroups;
using radar_dense::kRows;
using radar_dense::kRowsPerThread;

template <int max_threads>
__global__ void __launch_bounds__(max_threads,
                                  radar_dense::min_blocks<max_threads>())
radar_dense_fwd_kernel(const float* __restrict__ w,
                       const int* __restrict__ band,
                       const float* __restrict__ src,
                       const float* __restrict__ dst,
                       const float* __restrict__ cvec,
                       const float* __restrict__ loc,
                       const float* __restrict__ lam,
                       float* __restrict__ re_out, float* __restrict__ im_out,
                       int t_in, int em, int t_out) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int rg = tid % kRowGroups;
  const int pg = tid / kRowGroups;
  const int groups = blockDim.x / kRowGroups;

  float acc[6][kRowsPerThread][kPairsPerThread];
  radar_dense::positions(w, src, dst, n, row0, band[2 * blockIdx.y],
                         band[2 * blockIdx.y + 1], t_in, t_out, em, smem,
                         acc);

  const float lam_v = lam[0];
  const float k = radar::kFourPi / lam_v;
  const radar::Point l = {loc[0], loc[1], loc[2]};
  float re[kRowsPerThread], im[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) re[i] = im[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < kPairsPerThread; ++j) {
    const int p = pg * kPairsPerThread + j;
    if (p >= em) continue;
    const float c = cvec[(size_t)n * em + p];
    const float amp0 = sqrtf(radar::kPi * c);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const radar::Point s = {acc[0][i][j], acc[1][i][j], acc[2][i][j]};
      const radar::Point d = {acc[3][i][j], acc[4][i][j], acc[5][i][j]};
      float amp, phase, sinp, cosp;
      radar::scatter_fwd(l, s, d, c, amp0, k, amp, phase);
      sincosf(phase, &sinp, &cosp);
      re[i] += amp * cosp;
      im[i] += amp * sinp;
    }
  }

  // the pair groups' partial sums of each row, added in group order
  float* s_re = smem;                  // (groups, kRows)
  float* s_im = smem + groups * kRows;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    s_re[pg * kRows + rg * kRowsPerThread + i] = re[i];
    s_im[pg * kRows + rg * kRowsPerThread + i] = im[i];
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < t_out) {
    float sr = 0.0f, si = 0.0f;
    for (int g = 0; g < groups; ++g) {
      sr += s_re[g * kRows + tid];
      si += s_im[g * kRows + tid];
    }
    re_out[(size_t)n * t_out + row0 + tid] = sr;
    im_out[(size_t)n * t_out + row0 + tid] = si;
  }
}

template <int max_threads>
cudaError_t launch_fwd(const float* w, const int* band, const float* src,
                       const float* dst, const float* c, const float* loc,
                       const float* lam, float* re, float* im, int n,
                       int t_in, int em, int t_out, cudaStream_t stream) {
  const size_t reduce = (size_t)2 * (radar_dense::block_threads(em) /
                                     kRowGroups) * kRows;
  const size_t floats = radar_dense::positions_smem_floats(em);
  const size_t smem = sizeof(float) * (floats > reduce ? floats : reduce);
  cudaError_t err = cudaFuncSetAttribute(
      radar_dense_fwd_kernel<max_threads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (t_out + kRows - 1) / kRows);
  radar_dense_fwd_kernel<max_threads>
      <<<grid, radar_dense::block_threads(em), smem, stream>>>(
          w, band, src, dst, c, loc, lam, re, im, t_in, em, t_out);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// w is (T_w, t_in) with T_w >= t_out; band (ceil(t_out / 64), 2) int32
// [k_lo, k_hi) a row block, 0 <= k_lo <= k_hi <= t_in; 1 <= em <=
// radar_dense::kMaxPairs.
extern "C" int radar_dense_fwd_f32(const float* w, const int* band,
                                   const float* src, const float* dst,
                                   const float* c, const float* loc,
                                   const float* lam, float* re, float* im,
                                   int n, int t_in, int em, int t_out,
                                   cudaStream_t stream) {
  const auto go = radar_dense::block_threads(em) <=
                          radar_dense::kTwoBlockThreads
                      ? launch_fwd<radar_dense::kTwoBlockThreads>
                      : launch_fwd<radar_dense::kMaxThreads>;
  return go(w, band, src, dst, c, loc, lam, re, im, n, t_in, em, t_out,
            stream);
}
