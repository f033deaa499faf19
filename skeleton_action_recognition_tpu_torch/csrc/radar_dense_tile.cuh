// The endpoint positions of a block of output rows, shared by
// radar_dense_fwd.cu and radar_dense_bwd.cu.
//
// The dense radar kernels interpolate every edge-body pair's endpoints with
// a dense (T_out, T_in) resampling operator w:
//
//     s[t, c, p] = sum_k w[t, k] * src[n, k, c * EM + p]      (c = x, y, z)
//
// and dst alike: a matrix product of w's rows with one sample's 2 x 3 EM
// features, contracted in f32 on the CUDA cores (no TF32, no tensor cores:
// at lambda = 5e-4 the phase is ~2.5e4 rad a metre, and TF32 rounding of a
// position turns the return into noise).
//
// A block owns kRows = 64 rows of one sample and every pair. Its threads
// form kRowGroups = 16 row groups of kRowsPerThread = 4 consecutive rows
// times EM_pad / 4 pair groups of kPairsPerThread = 4 consecutive pairs
// (EM_pad: EM rounded up to a multiple of 4, at most kMaxPairs), so a
// thread holds the six coordinates of its 4 pairs at its 4 rows, 96 f32
// accumulators, and can run the per-pair math on them in registers.
//
// The contraction walks only the block's band [k_lo, k_hi) of T_in
// (ops/radar.py::dense_band: the columns outside it hold at most 2^-30 of
// each row's L1 norm, below f32 rounding of a position; ~39 of 300 at the
// trainer's operator), in steps of kDepth, staging w's rows transposed
// (kDepth x 64) and the sample's features (kDepth x 6 EM_pad) in shared
// memory, two steps in flight (cp.async); each k adds one f32 FMA to every
// accumulator, in the order k = k_lo, k_lo + 1, ..., k_hi - 1. Rows past
// t_out and k at or past k_hi are staged as zeros; w outside the band is
// never read.

#pragma once

#include <cuda_runtime.h>

namespace radar_dense {

constexpr int kRows = 64;
constexpr int kRowGroups = 16;
constexpr int kRowsPerThread = 4;
constexpr int kPairsPerThread = 4;
constexpr int kMaxPairs = 64;
constexpr int kMaxThreads = kRowGroups * kMaxPairs / kPairsPerThread;
// The row-block kernels are built twice: for blocks of up to 192 threads
// (EM <= 48, as the NTU radar edges give), two blocks an SM, which caps a
// thread at 170 registers (on an H100 the backward's rows kernel at one
// block an SM, 187 registers, made it 15% slower); and for up to
// kMaxThreads, one block an SM.
constexpr int kTwoBlockThreads = 192;

template <int threads>
constexpr int min_blocks() {
  return threads <= kTwoBlockThreads ? 2 : 1;
}
constexpr int kDepth = 16;
constexpr int kStrideA = kRows + 4;  // float4-aligned, and fewer conflicts

__host__ __device__ inline int padded_pairs(int em) {
  return (em + kPairsPerThread - 1) / kPairsPerThread * kPairsPerThread;
}

__host__ __device__ inline int block_threads(int em) {
  return kRowGroups * padded_pairs(em) / kPairsPerThread;
}

// One f32 copy from device to shared memory that does not pass through
// registers (Ampere's cp.async); `valid` false writes a zero and reads
// nothing (`src` must still be a device pointer).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` committed groups of this thread are in
// flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// floats of one stage: w's rows transposed (kDepth, kStrideA), then the
// features (kDepth, 6, emp)
__host__ __device__ inline size_t stage_floats(int em) {
  return (size_t)kDepth * kStrideA + (size_t)kDepth * 6 * padded_pairs(em);
}

// floats of shared memory the contraction stages: two stages, so that the
// copies of step k0 + kDepth are in flight while step k0 is contracted
__host__ __device__ inline size_t positions_smem_floats(int em) {
  return 2 * stage_floats(em);
}

// Start the copies of one step (T_in rows k0 .. k0 + kDepth - 1, those
// below k_end) into `stage`. The block has 4 emp threads (block_threads),
// so one pass of them covers 4 of the kDepth * 6 feature rows of emp
// floats.
__device__ __forceinline__ void stage_step(
    const float* __restrict__ w, const float* __restrict__ src,
    const float* __restrict__ dst, size_t feat, int row0, int k0, int k_end,
    int t_in, int t_out, int em, int emp, float* stage) {
  const int tid = threadIdx.x;
  float* s_a = stage;
  float* s_b = stage + kDepth * kStrideA;
  for (int e = tid; e < kRows * kDepth; e += blockDim.x) {
    const int r = e / kDepth, kk = e % kDepth;
    const int row = row0 + r, k = k0 + kk;
    const bool ok = row < t_out && k < k_end;
    cp_async_f32(s_a + kk * kStrideA + r, ok ? w + (size_t)row * t_in + k : w,
                 ok);
  }
  const int p = tid % emp;
  const int f3 = 3 * em;
#pragma unroll
  for (int q = tid / emp; q < kDepth * 6; q += 4) {
    const int kk = q / 6, c = q % 6;
    const int k = k0 + kk;
    const bool ok = k < k_end && p < em;
    const float* f = (c < 3 ? src : dst) + feat + (size_t)k * f3 +
                     (c % 3) * em + p;
    cp_async_f32(s_b + q * emp + p, ok ? f : src, ok);
  }
}

// acc[c][i][j]: coordinate c (0-2 the source's x, y, z, 3-5 the
// destination's) of pair pg * 4 + j at row row0 + rg * 4 + i, where rg =
// threadIdx.x % 16 and pg = threadIdx.x / 16, summed over the columns
// [k_lo, k_hi) of w. `smem` holds positions_smem_floats(em) floats, 16-byte
// aligned. Ends with a barrier, after which the caller may reuse `smem`.
__device__ __forceinline__ void positions(
    const float* __restrict__ w, const float* __restrict__ src,
    const float* __restrict__ dst, int n, int row0, int k_lo, int k_hi,
    int t_in, int t_out, int em, float* smem,
    float acc[6][kRowsPerThread][kPairsPerThread]) {
  const int emp = padded_pairs(em);
  const size_t stage = stage_floats(em);
  const int rg = threadIdx.x % kRowGroups;
  const int pg = threadIdx.x / kRowGroups;
  const size_t feat = (size_t)n * t_in * 3 * em;

#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kPairsPerThread; ++j) acc[c][i][j] = 0.0f;

  const int steps = (k_hi - k_lo + kDepth - 1) / kDepth;
  if (steps <= 0) {
    __syncthreads();
    return;
  }
  stage_step(w, src, dst, feat, row0, k_lo, k_hi, t_in, t_out, em, emp,
             smem);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      stage_step(w, src, dst, feat, row0, k_lo + (step + 1) * kDepth, k_hi,
                 t_in, t_out, em, emp, smem + ((step + 1) % 2) * stage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_a = smem + (step % 2) * stage;
    const float* s_b = s_a + kDepth * kStrideA;
#pragma unroll 4
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(s_a + kk * kStrideA + rg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(
            s_b + (kk * 6 + c) * emp + pg * 4);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kPairsPerThread; ++j)
            acc[c][i][j] = fmaf(av[i], bv[j], acc[c][i][j]);
      }
    }
    // the next step's copies go to the stage just read
    __syncthreads();
  }
}

}  // namespace radar_dense
