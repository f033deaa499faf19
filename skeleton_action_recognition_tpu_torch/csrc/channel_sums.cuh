// Deterministic sums of per-block partials, shared by the kernels with a
// statistics or weight-gradient epilogue (sgcn_fwd.cu, sgcn_bwd.cu,
// tconv_fwd.cu, tconv_bwd.cu).
//
// Thread blocks run in no order on Hopper, so a sum across blocks taken with
// float atomics changes from launch to launch. Instead each block writes its
// partial for its own row p of a workspace ws[parts][n], and this kernel sums
// each column j in an order fixed by the shapes alone: thread (r, lane) of a
// block adds rows r, r + ROWS, r + 2 ROWS, ... of column j0 + lane (a warp
// reads 32 neighbouring columns of one row: coalesced), then the ROWS
// per-thread sums of a column meet in a fixed tree in shared memory. Two
// launches on the same partials give bit-identical sums.

#pragma once

#include <cuda_runtime.h>

namespace channel_sums {

constexpr int LANES = 32;  // columns per block
constexpr int ROWS = 32;   // threads per column
constexpr int THREADS = LANES * ROWS;

// out[j] = sum over p < parts of ws[p * n + j], for j < n.
__global__ void __launch_bounds__(THREADS)
    kernel(const float* __restrict__ ws, int parts, int n,
           float* __restrict__ out) {
  __shared__ float red[ROWS][LANES + 1];
  const int lane = threadIdx.x % LANES, r = threadIdx.x / LANES;
  const int j = blockIdx.x * LANES + lane;
  float sum = 0.f;
  if (j < n)
    for (int p = r; p < parts; p += ROWS) sum += ws[size_t(p) * n + j];
  red[r][lane] = sum;
  __syncthreads();
  for (int half = ROWS / 2; half > 0; half /= 2) {
    if (r < half) red[r][lane] += red[r + half][lane];
    __syncthreads();
  }
  if (r == 0 && j < n) out[j] = red[0][lane];
}

// Launch kernel on stream; returns the launch's cudaError_t.
inline cudaError_t launch(const float* ws, int parts, int n, float* out,
                          cudaStream_t stream) {
  kernel<<<(n + LANES - 1) / LANES, THREADS, 0, stream>>>(ws, parts, n, out);
  return cudaGetLastError();
}

}  // namespace channel_sums
