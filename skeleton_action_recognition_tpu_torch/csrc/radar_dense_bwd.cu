// Dense-operator radar return, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/radar.py::
// _radar_bwd_kernel (called from _kernel_vjp_bwd): the VJP of
// radar_dense_fwd.cu's return with respect to the features src/dst (N,
// T_in, 3 EM), c (N, EM), loc (3,) and lambda, from the output cotangent
// (gre, gim) (N, t_out). The operator w gets no cotangent (a constant, as
// in JAX). Per (sample, row, pair) the math is radar_math.cuh's
// scatter_bwd, the JAX kernel's _scatter_bwd_core with its guards; then
//
//     dsrc[n, k, f] = sum_t w[t, k] * g_src[n, t, f]      (ddst alike)
//     dc[n, p]      = sum_t g_c[n, t, p]
//     dloc, dlambda = sums over every sample, row and pair.
//
// What bounds it on the H100: four contractions of 2 N t_out T_in 3 EM
// FLOP each, 415 GFLOP at the trainer's shape (~6.2 ms at the 67 TFLOP/s
// f32 peak), the recomputed positions and the transposed products; the
// per-pair math (57.6 M pairs, ~150 operations each) adds ~0.13 ms. The
// TPU kernel added every tile's dsrc into one block of its output across a
// grid that runs in order; here blocks run in no order, there are no float
// atomics, and a block cannot hold a sample's (T_in, 6 EM) partial (345 KB
// at T_in = 300). So four kernels, each sum in an order fixed by the
// shapes alone (two launches on the same inputs agree bit for bit):
//   1. rows_kernel: the forward's position tile (radar_dense_tile.cuh),
//      put in shared memory, then the per-pair cotangents, a thread a
//      pair. g_src/g_dst go to a workspace g (N, t_out, 6 EM_pad), f32,
//      1.38 GB at the trainer's shape; each block's dc (its 64 rows, in
//      order) and its dloc/dlambda (its threads, in order) to small
//      workspaces.
//   2. wt_kernel: ws_part[s] = w[rows of split s]^T g, a GEMM with T_in on
//      the rows, over a fixed split of t_out into kSplitRows rows (19
//      splits at t_out = 75,000: ws_part 105 MB). Blocks that run at once
//      share an operator and a g chunk in L2, so each is read from device
//      memory about once.
//   3. reduce_kernel: dsrc/ddst sum the splits in order, dc the row tiles;
//      scalar_sums_kernel: dloc and dlambda over every block of
//      rows_kernel, strided partials and then a fixed tree.
// Rows at or past t_out have a zero cotangent (the forward cut them) and
// are skipped.
//
// At lambda = 5e-4 the raw dlambda (a 4 pi d / lambda^2 factor on every
// term) can overflow f32; the trainer's optimizer takes inf as a
// direction (train/optim.py).

#include <cuda_runtime.h>

#include "radar_dense_tile.cuh"
#include "radar_math.cuh"

namespace {

using radar_dense::kPairsPerThread;
using radar_dense::kRowGroups;
using radar_dense::kRows;
using radar_dense::kRowsPerThread;

// rows of t_out a split of the transposed products covers
constexpr int kSplitRows = 4096;
// the transposed products' block: kWtRows rows of T_in x kWtCols columns
// of 6 EM_pad, 128 threads of 8 x 6 accumulators
constexpr int kWtThreads = 128;
constexpr int kWtRows = 64;
constexpr int kWtCols = 96;
constexpr int kWtDepth = 16;
// five blocks an SM (at most 102 registers a thread, a few spilled): on an
// H100 the backward took 4% less time than with four (128 registers)
constexpr int kWtBlocks = 5;
constexpr int kReduceThreads = 256;
// rows_kernel's threads a pair: the block has 4 emp threads
constexpr int kRowPhases = kRowGroups / kPairsPerThread;

// Shared memory of rows_kernel in floats: the staged contraction, then
// (reusing it) the positions (6, kRows, emp + 1) and the block's sums.
__host__ __device__ inline size_t rows_smem_floats(int em) {
  const int emp = radar_dense::padded_pairs(em);
  const size_t staged = radar_dense::positions_smem_floats(em);
  const size_t pos = (size_t)6 * kRows * (emp + 1);
  const size_t sums = (size_t)kRowPhases * emp +
                      4 * (size_t)radar_dense::block_threads(em);
  const size_t after = pos + sums;
  return staged > after ? staged : after;
}

template <int max_threads>
__global__ void __launch_bounds__(max_threads,
                                  radar_dense::min_blocks<max_threads>())
rows_kernel(const float* __restrict__ w, const float* __restrict__ src,
            const float* __restrict__ dst, const float* __restrict__ cvec,
            const float* __restrict__ loc, const float* __restrict__ lam,
            const float* __restrict__ gre_in,
            const float* __restrict__ gim_in, float* __restrict__ g,
            float* __restrict__ ws_dc, float* __restrict__ ws_s, int t_in,
            int em, int t_out) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int tile = blockIdx.y;
  const int tiles = gridDim.y;
  const int row0 = tile * kRows;
  const int tid = threadIdx.x;
  const int emp = radar_dense::padded_pairs(em);
  const int pstride = emp + 1;  // a position row, padded: fewer conflicts

  // the positions go through shared memory, so that the per-pair math
  // below does not hold its registers beside the 96 accumulators
  {
    float acc[6][kRowsPerThread][kPairsPerThread];
    radar_dense::positions(w, src, dst, n, row0, t_in, t_out, em, smem, acc);
    const int rg = tid % kRowGroups;
    const int pg = tid / kRowGroups;
#pragma unroll
    for (int c = 0; c < 6; ++c)
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kPairsPerThread; ++j)
          smem[(c * kRows + rg * kRowsPerThread + i) * pstride +
               pg * kPairsPerThread + j] = acc[c][i][j];
  }
  __syncthreads();

  // thread: pair p at rows r, r + 4, ..., r + 60, each row's cotangents
  // written at once
  const int p = tid % emp;
  const int r_first = tid / emp;
  const float lam_v = lam[0];
  const float k = radar::kFourPi / lam_v;
  const radar::Point l = {loc[0], loc[1], loc[2]};
  const float c = p < em ? cvec[(size_t)n * em + p] : 0.0f;
  const float amp0 = sqrtf(radar::kPi * c);
  float dc = 0.0f;
  float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dloc xyz, dlambda
  for (int r = r_first; r < kRows; r += kRowPhases) {
    const int row = row0 + r;
    if (row >= t_out) break;
    radar::Point gs = {0.0f, 0.0f, 0.0f}, gd = gs, gl = gs;
    float gc = 0.0f, glam = 0.0f;
    if (p < em) {
      const float* pos = smem + r * pstride + p;
      const size_t plane = (size_t)kRows * pstride;
      const radar::Point s = {pos[0], pos[plane], pos[2 * plane]};
      const radar::Point d = {pos[3 * plane], pos[4 * plane],
                              pos[5 * plane]};
      const size_t at = (size_t)n * t_out + row;
      radar::scatter_bwd(l, s, d, c, amp0, k, lam_v, gre_in[at], gim_in[at],
                         gs, gd, gc, gl, glam);
    }
    float* out = g + ((size_t)n * t_out + row) * 6 * emp + p;
    out[0] = gs.x;
    out[emp] = gs.y;
    out[2 * emp] = gs.z;
    out[3 * emp] = gd.x;
    out[4 * emp] = gd.y;
    out[5 * emp] = gd.z;
    dc += gc;
    sums[0] += gl.x;
    sums[1] += gl.y;
    sums[2] += gl.z;
    sums[3] += glam;
  }

  // dc over the block's rows: the row phases in order; dloc and dlambda
  // over its threads in order
  float* s_dc = smem + (size_t)6 * kRows * pstride;  // (kRowPhases, emp)
  float* s_sums = s_dc + kRowPhases * emp;            // (4, blockDim.x)
  s_dc[r_first * emp + p] = dc;
#pragma unroll
  for (int v = 0; v < 4; ++v) s_sums[v * blockDim.x + tid] = sums[v];
  __syncthreads();
  const size_t block = (size_t)n * tiles + tile;
  if (tid < em) {
    float acc_dc = 0.0f;
    for (int r = 0; r < kRowPhases; ++r) acc_dc += s_dc[r * emp + tid];
    ws_dc[block * em + tid] = acc_dc;
  } else if (tid >= emp && tid < emp + 4) {
    const int v = tid - emp;
    float acc_s = 0.0f;
    for (int t = 0; t < (int)blockDim.x; ++t) {
      acc_s += s_sums[v * blockDim.x + t];
    }
    ws_s[block * 4 + v] = acc_s;
  }
}

// Start the copies of one step of wt_kernel (rows t0 .. t0 + kWtDepth - 1
// of split rows [.., t_end)) into s_a (kWtDepth, kWtRows) and s_b
// (kWtDepth, kWtCols).
__device__ __forceinline__ void wt_stage(const float* __restrict__ w,
                                         const float* __restrict__ g_n,
                                         int t0, int t_end, int m0, int c0,
                                         int t_in, int cols, float* s_a,
                                         float* s_b) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = tid; e < kWtDepth * kWtRows; e += kWtThreads) {
    const int tt = e / kWtRows, m = e % kWtRows;
    const int t = t0 + tt;
    const bool ok = t < t_end && m0 + m < t_in;
    radar_dense::cp_async_f32(s_a + e, ok ? w + (size_t)t * t_in + m0 + m : w,
                              ok);
  }
#pragma unroll
  for (int e = tid; e < kWtDepth * kWtCols; e += kWtThreads) {
    const int tt = e / kWtCols, col = e % kWtCols;
    const int t = t0 + tt;
    const bool ok = t < t_end && c0 + col < cols;
    radar_dense::cp_async_f32(
        s_b + e, ok ? g_n + (size_t)t * cols + c0 + col : g_n, ok);
  }
}

// ws_part[s, n, m, col] = sum over rows t of split s (t < t_out) of
// w[t, m] * g[n, t, col], for m < t_in and col < 6 emp, in t order; two
// steps in flight (cp.async).
__global__ void __launch_bounds__(kWtThreads, kWtBlocks)
wt_kernel(const float* __restrict__ w, const float* __restrict__ g,
          float* __restrict__ ws_part, int n_samples, int t_in, int cols,
          int t_out) {
  __shared__ __align__(16) float s_a[2][kWtDepth * kWtRows];
  __shared__ __align__(16) float s_b[2][kWtDepth * kWtCols];
  const int m_tiles = (t_in + kWtRows - 1) / kWtRows;
  const int m0 = (blockIdx.x % m_tiles) * kWtRows;
  const int c0 = (blockIdx.x / m_tiles) * kWtCols;
  const int n = blockIdx.y;
  const int split = blockIdx.z;
  const int t_begin = split * kSplitRows;
  const int t_end = min(t_out, t_begin + kSplitRows);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty * 8 .. + 7
  const int tx = tid % 16;  // columns tx + 16 j, j < 6
  float acc[8][6];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;

  const float* g_n = g + (size_t)n * t_out * cols;
  const int steps = (t_end - t_begin + kWtDepth - 1) / kWtDepth;
  wt_stage(w, g_n, t_begin, t_end, m0, c0, t_in, cols, s_a[0], s_b[0]);
  radar_dense::cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      const int next = (step + 1) % 2;
      wt_stage(w, g_n, t_begin + (step + 1) * kWtDepth, t_end, m0, c0, t_in,
               cols, s_a[next], s_b[next]);
      radar_dense::cp_async_commit();
      radar_dense::cp_async_wait<1>();
    } else {
      radar_dense::cp_async_wait<0>();
    }
    __syncthreads();
    const float* a_s = s_a[step % 2];
    const float* b_s = s_b[step % 2];
#pragma unroll 4
    for (int tt = 0; tt < kWtDepth; ++tt) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(a_s + tt * kWtRows + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a_s + tt * kWtRows + ty * 8 + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) bv[j] = b_s[tt * kWtCols + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the next step's copies go to the stage just read
    __syncthreads();
  }

  float* out = ws_part + ((size_t)split * n_samples + n) * t_in * cols;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= t_in) continue;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < cols) out[(size_t)m * cols + col] = acc[i][j];
    }
  }
}

// dsrc/ddst[n, m, (c % 3) em + p] = sum_s ws_part[s, n, m, c emp + p];
// dc[n, p] = sum over row tiles of ws_dc. Each output one thread, in index
// order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ ws_part,
              const float* __restrict__ ws_dc, float* __restrict__ dsrc,
              float* __restrict__ ddst, float* __restrict__ dc,
              int n_samples, int t_in, int em, int splits, int tiles) {
  const int emp = radar_dense::padded_pairs(em);
  const size_t feats = (size_t)n_samples * t_in * 3 * em;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < 2 * feats) {
    const bool is_dst = idx >= feats;
    const size_t f_idx = is_dst ? idx - feats : idx;
    const size_t nm = f_idx / (3 * em);  // n * t_in + m
    const int f = (int)(f_idx % (3 * em));
    const int c = f / em + (is_dst ? 3 : 0);
    const int p = f % em;
    const size_t stride = (size_t)n_samples * t_in * 6 * emp;
    const float* part = ws_part + nm * 6 * emp + c * emp + p;
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) acc += part[s * stride];
    (is_dst ? ddst : dsrc)[f_idx] = acc;
  } else if (idx < 2 * feats + (size_t)n_samples * em) {
    const size_t o = idx - 2 * feats;
    const size_t i = o / em, p = o % em;
    float acc = 0.0f;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) acc += ws_dc[(i * tiles + t) * em + p];
    dc[o] = acc;
  }
}

// dloc[v] (v < 3) and dlambda (v = 3) = sum over the `blocks` (sample, row
// tile) partials ws_s[b, v]: block v, each thread the partials b = tid
// (mod kReduceThreads) in order, then a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
scalar_sums_kernel(const float* __restrict__ ws_s, float* __restrict__ dloc,
                   float* __restrict__ dlam, int blocks) {
  __shared__ float part[kReduceThreads];
  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  float acc = 0.0f;
#pragma unroll 8
  for (int b = tid; b < blocks; b += kReduceThreads) acc += ws_s[b * 4 + v];
  part[tid] = acc;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half /= 2) {
    if (tid < half) part[tid] += part[tid + half];
    __syncthreads();
  }
  if (tid == 0) (v < 3 ? dloc + v : dlam)[0] = part[0];
}

template <int max_threads>
cudaError_t launch_rows(const float* w, const float* src, const float* dst,
                        const float* c, const float* loc, const float* lam,
                        const float* gre, const float* gim, float* g,
                        float* ws_dc, float* ws_s, int n, int tiles, int t_in,
                        int em, int t_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * rows_smem_floats(em);
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel<max_threads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  rows_kernel<max_threads>
      <<<dim3(n, tiles), radar_dense::block_threads(em), smem, stream>>>(
          w, src, dst, c, loc, lam, gre, gim, g, ws_dc, ws_s, t_in, em,
          t_out);
  return cudaGetLastError();
}

}  // namespace

// Launch the four kernels on `stream`; returns the first failed launch's
// cudaError_t (0 on success). Workspaces, in floats, with tiles =
// ceil(t_out / 64), splits = ceil(t_out / 4096) and emp = EM rounded up to
// a multiple of 4: g N t_out 6 emp, ws_part splits N t_in 6 emp, ws_dc N
// tiles EM, ws_s N tiles 4.
extern "C" int radar_dense_bwd_f32(
    const float* w, const float* src, const float* dst, const float* c,
    const float* loc, const float* lam, const float* gre, const float* gim,
    float* dsrc, float* ddst, float* dc, float* dloc, float* dlam, float* g,
    float* ws_part, float* ws_dc, float* ws_s, int n, int t_in, int em,
    int t_out, cudaStream_t stream) {
  const int emp = radar_dense::padded_pairs(em);
  const int tiles = (t_out + kRows - 1) / kRows;
  const auto rows = radar_dense::block_threads(em) <=
                            radar_dense::kTwoBlockThreads
                        ? launch_rows<radar_dense::kTwoBlockThreads>
                        : launch_rows<radar_dense::kMaxThreads>;
  cudaError_t err = rows(w, src, dst, c, loc, lam, gre, gim, g, ws_dc, ws_s,
                         n, tiles, t_in, em, t_out, stream);
  if (err != cudaSuccess) return err;

  const int cols = 6 * emp;
  const int splits = (t_out + kSplitRows - 1) / kSplitRows;
  const int m_tiles = (t_in + kWtRows - 1) / kWtRows;
  const int c_tiles = (cols + kWtCols - 1) / kWtCols;
  wt_kernel<<<dim3(m_tiles * c_tiles, n, splits), kWtThreads, 0, stream>>>(
      w, g, ws_part, n, t_in, cols, t_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t outputs = (size_t)2 * n * t_in * 3 * em + (size_t)n * em;
  reduce_kernel<<<(unsigned)((outputs + kReduceThreads - 1) / kReduceThreads),
                  kReduceThreads, 0, stream>>>(ws_part, ws_dc, dsrc, ddst, dc,
                                               n, t_in, em, splits, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scalar_sums_kernel<<<4, kReduceThreads, 0, stream>>>(ws_s, dloc, dlam,
                                                       n * tiles);
  return cudaGetLastError();
}
