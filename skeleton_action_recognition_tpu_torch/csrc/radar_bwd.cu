// Spline radar return, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/radar.py::
// _radar_spline_bwd_kernel (called from _spline_vjp_bwd): the VJP of
// radar_fwd.cu's return with respect to the tiles' coefficients src/dst
// (N, num_tiles, 3 EM, ns4), c (N, EM), loc (3,) and lambda, from the
// output cotangent (gre, gim) (N, t_out). The monomials e get no
// cotangent (a constant, as in JAX). Per (sample, padded row, edge-body
// pair) the math is radar_math.cuh's scatter_bwd, the JAX kernel's
// _scatter_bwd_core with its guards; then
//
//     dsrc[n, j, f, q] = sum_r gs[f](r) * e[j, q, r]     (ddst alike)
//     dc[n, em]        = sum_j sum_r gc[em](r)
//     dloc, dlambda    = sums over every sample, row and pair.
//
// What bounds it on the H100: the same CUDA-core arithmetic as the forward,
// about twice as much a pair (the recomputed forward, sincosf included,
// and its derivative). The sums are the design's problem. The TPU kernel
// carried dc, dloc and dlambda across its sequential grid; here blocks run
// in no order and there are no float atomics:
//   1. radar_bwd_kernel: one block per (tile, sample). It stages the
//      tile's coefficients, its monomials e and, one pair at a time, each
//      row's seven cotangents (gs, gd, gc) in shared memory, then
//      contracts them over the tile's rows with e: dsrc/ddst (each block
//      owns its (3 EM, ns4) output blocks, as in JAX) and the tile's dc
//      partial. Each contraction is split over a fixed number of row
//      ranges whose partials are added in order. dloc and dlambda
//      accumulate per thread over its rows and the pairs and are summed
//      over the block by a fixed tree. The partials go to a workspace.
//   2. radar_bwd_reduce_kernel: sums the partials over tiles (dc) and over
//      all (sample, tile) blocks (dloc, dlambda), in index order.
// Every sum's order depends on the shapes alone, so two launches on the
// same inputs agree bit for bit. Rows past t_out have a zero cotangent
// (the forward cut them) and contribute nothing.
//
// At lambda = 5e-4 the raw dlambda (a 4 pi d / lambda^2 factor on every
// term) can overflow f32; the trainer's optimizer takes inf as a
// direction (train/optim.py).

#include <cuda_runtime.h>

#include "radar_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

struct Layout {
  int f3, ns4, stride, n_out, parts;
  size_t coef, e, g, red;  // offsets in floats
  size_t total;

  __host__ __device__ Layout(int ns4_, int tile, int em) {
    f3 = 3 * em;
    ns4 = ns4_;
    stride = tile + 1;  // rows of the staged arrays, padded: no bank conflicts
    n_out = 6 * ns4 + 1;  // (coord, q) of src and dst, and dc
    parts = kThreads / n_out > 0 ? kThreads / n_out : 1;
    coef = 0;
    e = coef + (size_t)2 * f3 * ns4;
    g = e + (size_t)ns4 * stride;
    red = g + (size_t)7 * stride;
    total = red + (size_t)parts * n_out + 4 * kThreads;
  }
};

__global__ void __launch_bounds__(kThreads)
radar_bwd_kernel(const float* __restrict__ e, const float* __restrict__ src,
                 const float* __restrict__ dst, const float* __restrict__ cvec,
                 const float* __restrict__ loc, const float* __restrict__ lam,
                 const float* __restrict__ gre_in,
                 const float* __restrict__ gim_in, float* __restrict__ dsrc,
                 float* __restrict__ ddst, float* __restrict__ ws_dc,
                 float* __restrict__ ws_s, int num_tiles, int ns4, int tile,
                 int em, int t_out) {
  extern __shared__ float smem[];
  const Layout lay(ns4, tile, em);
  const int j = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int f3 = lay.f3;
  const int stride = lay.stride;
  float* s_src = smem + lay.coef;
  float* s_dst = s_src + f3 * ns4;
  float* s_e = smem + lay.e;      // (ns4, stride)
  float* s_g = smem + lay.g;      // (7, stride): gs xyz, gd xyz, gc
  float* s_red = smem + lay.red;  // (parts, n_out), then (4, kThreads)
  float* s_fin = s_red + lay.parts * lay.n_out;

  const size_t block = (size_t)n * num_tiles + j;
  const size_t coef_base = block * f3 * ns4;
  for (int i = tid; i < f3 * ns4; i += blockDim.x) {
    s_src[i] = src[coef_base + i];
    s_dst[i] = dst[coef_base + i];
  }
  const float* e_tile = e + (size_t)j * ns4 * tile;
  for (int i = tid; i < ns4 * tile; i += blockDim.x) {
    s_e[(i / tile) * stride + i % tile] = e_tile[i];
  }
  __syncthreads();

  const float lam_v = lam[0];
  const float k = radar::kFourPi / lam_v;
  const radar::Point l = {loc[0], loc[1], loc[2]};
  float acc_l[3] = {0.0f, 0.0f, 0.0f};
  float acc_lam = 0.0f;
  const int chunk = (tile + lay.parts - 1) / lay.parts;

  for (int p = 0; p < em; ++p) {
    const float c = cvec[(size_t)n * em + p];
    const float amp0 = sqrtf(radar::kPi * c);
    for (int r = tid; r < tile; r += blockDim.x) {
      const int row = j * tile + r;
      float m[4];
      const int slot = radar::row_slot(s_e, ns4, stride, r, m);
      radar::Point gs = {0.0f, 0.0f, 0.0f}, gd = gs, gl = gs;
      float gc = 0.0f, glam = 0.0f;
      if (row < t_out && slot >= 0) {
        const radar::Point s = {
            radar::eval_cubic(s_src, ns4, p, slot, m),
            radar::eval_cubic(s_src, ns4, em + p, slot, m),
            radar::eval_cubic(s_src, ns4, 2 * em + p, slot, m)};
        const radar::Point d = {
            radar::eval_cubic(s_dst, ns4, p, slot, m),
            radar::eval_cubic(s_dst, ns4, em + p, slot, m),
            radar::eval_cubic(s_dst, ns4, 2 * em + p, slot, m)};
        const size_t at = (size_t)n * t_out + row;
        radar::scatter_bwd(l, s, d, c, amp0, k, lam_v, gre_in[at],
                           gim_in[at], gs, gd, gc, gl, glam);
      }
      s_g[0 * stride + r] = gs.x;
      s_g[1 * stride + r] = gs.y;
      s_g[2 * stride + r] = gs.z;
      s_g[3 * stride + r] = gd.x;
      s_g[4 * stride + r] = gd.y;
      s_g[5 * stride + r] = gd.z;
      s_g[6 * stride + r] = gc;
      acc_l[0] += gl.x;
      acc_l[1] += gl.y;
      acc_l[2] += gl.z;
      acc_lam += glam;
    }
    __syncthreads();
    // contract the rows: output o = (coord cidx, monomial q), or dc
    for (int w = tid; w < lay.n_out * lay.parts; w += blockDim.x) {
      const int o = w % lay.n_out;
      const int part = w / lay.n_out;
      const int r0 = part * chunk;
      const int r1 = min(tile, r0 + chunk);
      float acc = 0.0f;
      if (o < 6 * ns4) {
        const float* g = s_g + (o / ns4) * stride;
        const float* eq = s_e + (o % ns4) * stride;
        for (int r = r0; r < r1; ++r) acc += g[r] * eq[r];
      } else {
        const float* g = s_g + 6 * stride;
        for (int r = r0; r < r1; ++r) acc += g[r];
      }
      s_red[part * lay.n_out + o] = acc;
    }
    __syncthreads();
    for (int o = tid; o < lay.n_out; o += blockDim.x) {
      float acc = 0.0f;
      for (int part = 0; part < lay.parts; ++part) {
        acc += s_red[part * lay.n_out + o];
      }
      if (o < 6 * ns4) {
        const int cidx = o / ns4;
        const int f = (cidx % 3) * em + p;
        float* out = cidx < 3 ? dsrc : ddst;
        out[(block * f3 + f) * ns4 + o % ns4] = acc;
      } else {
        ws_dc[block * em + p] = acc;
      }
    }
    __syncthreads();
  }

  // dloc and dlambda over the block: a fixed tree over the threads
  s_fin[0 * kThreads + tid] = acc_l[0];
  s_fin[1 * kThreads + tid] = acc_l[1];
  s_fin[2 * kThreads + tid] = acc_l[2];
  s_fin[3 * kThreads + tid] = acc_lam;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (tid < half) {
      for (int v = 0; v < 4; ++v) {
        s_fin[v * kThreads + tid] += s_fin[v * kThreads + tid + half];
      }
    }
    __syncthreads();
  }
  if (tid < 4) ws_s[block * 4 + tid] = s_fin[tid * kThreads];
}

// dc[n, em] = sum_j ws_dc[n, j, em]; dloc/dlambda = sum_b ws_s[b, :].
__global__ void __launch_bounds__(kReduceThreads)
radar_bwd_reduce_kernel(const float* __restrict__ ws_dc,
                        const float* __restrict__ ws_s, float* __restrict__ dc,
                        float* __restrict__ dloc, float* __restrict__ dlam,
                        int n, int num_tiles, int em) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n * em) {
    const int i = idx / em, p = idx % em;
    float acc = 0.0f;
    for (int j = 0; j < num_tiles; ++j) {
      acc += ws_dc[((size_t)i * num_tiles + j) * em + p];
    }
    dc[idx] = acc;
  } else if (idx < n * em + 4) {
    const int v = idx - n * em;
    float acc = 0.0f;
    for (size_t b = 0; b < (size_t)n * num_tiles; ++b) acc += ws_s[b * 4 + v];
    if (v < 3) {
      dloc[v] = acc;
    } else {
      dlam[0] = acc;
    }
  }
}

}  // namespace

// Launch both kernels on `stream`; returns the first failed launch's
// cudaError_t (0 on success). ws_dc holds N * num_tiles * EM floats, ws_s
// N * num_tiles * 4.
extern "C" int radar_bwd_f32(const float* e, const float* src,
                             const float* dst, const float* c,
                             const float* loc, const float* lam,
                             const float* gre, const float* gim, float* dsrc,
                             float* ddst, float* dc, float* dloc, float* dlam,
                             float* ws_dc, float* ws_s, int n, int num_tiles,
                             int ns4, int tile, int em, int t_out,
                             cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout(ns4, tile, em).total;
  cudaError_t err = cudaFuncSetAttribute(
      radar_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  radar_bwd_kernel<<<dim3(num_tiles, n), kThreads, smem, stream>>>(
      e, src, dst, c, loc, lam, gre, gim, dsrc, ddst, ws_dc, ws_s, num_tiles,
      ns4, tile, em, t_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outputs = n * em + 4;
  radar_bwd_reduce_kernel<<<(outputs + kReduceThreads - 1) / kReduceThreads,
                            kReduceThreads, 0, stream>>>(
      ws_dc, ws_s, dc, dloc, dlam, n, num_tiles, em);
  return cudaGetLastError();
}
