// Channels-first BatchNorm in training, for Hopper (sm_90a): the batch
// statistics, the normalize and the running update of an (N, C, L) tensor,
// and its backward, each channel's reductions spread over many blocks.
//
// Replaces no TPU kernel: the JAX package has no CTR-GCN, whose 86
// BatchNorms a step (models/ctrgcn.py, layers.BatchNorm with axis=1) take
// this route. Before it, torch's native NCHW kernels ran them
// (batch_norm_collect_statistics_kernel, batch_norm_backward_kernel),
// which give each channel one block: a launch over the temporal branches'
// 16-64 channels filled a fraction of the 132 SMs, each block walking 409,600
// elements of strided rows, at ~7% of the byte bound.
//
// For x (N, C, L) (L = T V, or T for the data BatchNorm), n = N L a channel:
//
//   stats_pass      per block, (mean, M2) of its chunk of x       (reads x)
//   normalize_pass  the chunks' partials combined (Chan et al.); mean,
//                   invstd = 1 / sqrt(M2 / n + eps); the first chunk's
//                   block writes save_mean, save_invstd and, with `update`,
//                   running = (1 - momentum) running + momentum batch (the
//                   unbiased M2 / (n - 1) for the variance, as torch's);
//                   y = TO(((x - mean) * (invstd * w)) + b)  (reads x, writes y)
//   reduce_pass     per block, the partial sums of dy and dy (x - mean)
//                                                            (reads dy, x)
//   dx_pass         the partial sums added; the first chunk's block writes
//                   grad_bias = sum dy, grad_weight = invstd sum dy (x -
//                   mean); dx = TI(((dy - (x - mean) * proj) - sum dy / n) *
//                   (invstd * w)), proj = invstd^2 sum dy (x - mean) / n
//                                                  (reads dy, x, writes dx)
//
// TI is x's and dx's type, TO y's and dy's (f32 or bf16); the statistics,
// weight, bias and gradients are f32, and every operation runs in f32.
//
// What bounds them on the H100: a handful of flops an element against 16
// bytes of device memory an element in bf16 (2 for the statistics, 4 for
// the normalize, 4 for the backward's sums, 6 for dx), so device-memory
// bytes alone. The design meets it by giving every launch the whole card:
// the grid is (chunk, channel), a block takes `ppc` planes of one channel
// (ops/channel_norm.py::planes_per_block picks it from the shapes so that
// a launch has about four blocks on each SM), and its threads
// walk the chunk's rows, which are L contiguous elements, with 16-byte
// accesses (VEC elements a thread, neighbouring threads on neighbouring
// vectors), several loads in flight a thread. A thread folds the moments
// of each group of vectors it loads at once into its own by Chan's rule
// (no sum of squares: a channel holds up to 409,600 elements), the block's
// threads meet in a fixed tree in shared memory, and each block writes its
// partial to its own workspace slot. The second kernel of each pass combines its channel's partials in
// an order fixed by the shapes alone (thread t folds partials t, t +
// THREADS, ..., then the same tree), so every block of a channel derives
// the same statistics, and two launches are bit-identical. The elementwise
// operations are rounded one by one (__fmul_rn, __fadd_rn), as written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "block_tail.cuh"

namespace channel_norm {

using block_tail::Access;

constexpr int THREADS = 256;
// dynamic shared memory of every kernel: three floats a thread
constexpr size_t SMEM_BYTES = 3 * THREADS * sizeof(float);

// The block's chunk of its channel: planes [p0, p0 + planes) of channel
// ch, each l / VEC vectors; grid (chunks, C).
struct Chunk {
  int ch, j, chunks, planes, lv, l;
  long long p0;
  __device__ __forceinline__ Chunk(int n, int l_, int ppc, int vec)
      : ch(int(blockIdx.y)),
        j(int(blockIdx.x)),
        chunks((n + ppc - 1) / ppc),
        planes(min(ppc, n - int(blockIdx.x) * ppc)),
        lv(l_ / vec),
        l(l_),
        p0((long long)blockIdx.x * ppc) {}
  __device__ __forceinline__ int vectors() const { return planes * lv; }
  // the element offset of the chunk's vector i in a tensor whose planes
  // lie `stride` elements apart
  __device__ __forceinline__ size_t at(int i, long long stride,
                                       int vec) const {
    const int p = i / lv;
    return size_t(p0 + p) * size_t(stride) + size_t(ch) * l +
           size_t(i - p * lv) * vec;
  }
};

// elements of chunk jj of a channel: min(ppc, n - jj ppc) planes of l
__device__ __forceinline__ float chunk_count(int n, int l, int ppc, int jj) {
  return float(min(ppc, n - jj * ppc)) * float(l);
}

// (count, mean, M2) of a set of values
struct Moments {
  float n = 0.f, mean = 0.f, m2 = 0.f;
};

// a <- the moments of a's values and b's (Chan, Golub and LeVeque)
__device__ __forceinline__ void merge(Moments& a, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float n = a.n + nb, d = mb - a.mean, r = nb / n;
  a.mean += d * r;
  a.m2 += m2b + d * d * a.n * r;
  a.n = n;
}

// fold the first `valid` of a thread's UNROLL vectors into a: their mean
// and M2 in two passes over the registers, then one merge
template <int UNROLL, int VEC>
__device__ __forceinline__ void add(Moments& a, const float (&v)[UNROLL][VEC],
                                    int valid) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (u < valid)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += v[u][e];
  const float count = float(valid * VEC), mean = s / count;
  float m2 = 0.f;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (u < valid)
#pragma unroll
      for (int e = 0; e < VEC; ++e) m2 += (v[u][e] - mean) * (v[u][e] - mean);
  merge(a, count, mean, m2);
}

// The block's threads' moments merged in a fixed tree; every thread gets
// the total. red: 3 THREADS floats of shared memory.
__device__ __forceinline__ Moments block_moments(Moments a, float* red) {
  const int t = threadIdx.x;
  red[t] = a.n;
  red[THREADS + t] = a.mean;
  red[2 * THREADS + t] = a.m2;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (t < half) {
      merge(a, red[t + half], red[THREADS + t + half],
            red[2 * THREADS + t + half]);
      red[t] = a.n;
      red[THREADS + t] = a.mean;
      red[2 * THREADS + t] = a.m2;
    }
    __syncthreads();
  }
  Moments total;
  total.n = red[0];
  total.mean = red[THREADS];
  total.m2 = red[2 * THREADS];
  __syncthreads();  // red is free again
  return total;
}

// The block's threads' pairs of sums added in a fixed tree; every thread
// gets the totals. red: 2 THREADS floats of shared memory.
__device__ __forceinline__ void block_sums(float& s0, float& s1, float* red) {
  const int t = threadIdx.x;
  red[t] = s0;
  red[THREADS + t] = s1;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (t < half) {
      red[t] += red[t + half];
      red[THREADS + t] += red[THREADS + t + half];
    }
    __syncthreads();
  }
  s0 = red[0];
  s1 = red[THREADS];
  __syncthreads();
}

// The moments of the channel from its chunks' partials ws[ch][jj] = (mean,
// M2), in an order fixed by the shapes.
__device__ __forceinline__ Moments channel_moments(const float* ws,
                                                   const Chunk& k, int n,
                                                   int ppc, float* red) {
  Moments a;
  for (int jj = threadIdx.x; jj < k.chunks; jj += THREADS) {
    const float* p = ws + (size_t(k.ch) * k.chunks + jj) * 2;
    merge(a, chunk_count(n, k.l, ppc, jj), p[0], p[1]);
  }
  return block_moments(a, red);
}

// ws[ch][j] = (mean, M2) of the block's chunk of x.
template <typename TI, int VEC>
__global__ void __launch_bounds__(THREADS)
    stats_pass(const TI* __restrict__ x, long long x_stride, int n, int l,
               int ppc, float* __restrict__ ws) {
  extern __shared__ float red[];
  constexpr int UNROLL = 4;
  const Chunk k(n, l, ppc, VEC);
  const int nv = k.vectors();
  Moments a;
  for (int i0 = threadIdx.x; i0 < nv; i0 += UNROLL * THREADS) {
    float v[UNROLL][VEC];
    int valid = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nv) {
        Access<TI, VEC>::load(x + k.at(i, x_stride, VEC), v[u]);
        valid = u + 1;
      }
    }
    add<UNROLL, VEC>(a, v, valid);
  }
  a = block_moments(a, red);
  if (threadIdx.x == 0) {
    float* p = ws + (size_t(k.ch) * k.chunks + k.j) * 2;
    p[0] = a.mean;
    p[1] = a.m2;
  }
}

// The channel's statistics from ws; y = TO(((x - mean) * (invstd * w)) +
// b); the first chunk's block writes save_mean, save_invstd and, with
// update, the running statistics.
template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(THREADS)
    normalize_pass(const TI* __restrict__ x, long long x_stride,
                   const float* __restrict__ ws, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ running_mean,
                   float* __restrict__ running_var,
                   float* __restrict__ save_mean,
                   float* __restrict__ save_invstd, TO* __restrict__ y, int n,
                   int c, int l, int ppc, int update, float momentum,
                   float eps) {
  extern __shared__ float red[];
  constexpr int UNROLL = 4;
  const Chunk k(n, l, ppc, VEC);
  const Moments m = channel_moments(ws, k, n, ppc, red);
  const float mean = m.mean, invstd = 1.f / sqrtf(m.m2 / m.n + eps);
  if (k.j == 0 && threadIdx.x == 0) {
    save_mean[k.ch] = mean;
    save_invstd[k.ch] = invstd;
    if (update) {
      const float keep = 1.f - momentum;
      running_mean[k.ch] = keep * running_mean[k.ch] + momentum * mean;
      running_var[k.ch] =
          keep * running_var[k.ch] + momentum * (m.m2 / (m.n - 1.f));
    }
  }
  const float scale = __fmul_rn(invstd, w[k.ch]), shift = b[k.ch];
  const long long y_stride = (long long)c * l;
  const int nv = k.vectors();
  for (int i0 = threadIdx.x; i0 < nv; i0 += UNROLL * THREADS) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nv) Access<TI, VEC>::load(x + k.at(i, x_stride, VEC), v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= nv) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[u][e] =
            __fadd_rn(__fmul_rn(__fadd_rn(v[u][e], -mean), scale), shift);
      Access<TO, VEC>::store(y + k.at(i, y_stride, VEC), v[u]);
    }
  }
}

// ws[ch][j] = (sum dy, sum dy (x - mean)) over the block's chunk.
template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(THREADS)
    reduce_pass(const TO* __restrict__ dy, long long dy_stride,
                const TI* __restrict__ x, long long x_stride,
                const float* __restrict__ save_mean, int n, int l, int ppc,
                float* __restrict__ ws) {
  extern __shared__ float red[];
  constexpr int UNROLL = 2;
  const Chunk k(n, l, ppc, VEC);
  const float mean = save_mean[k.ch];
  const int nv = k.vectors();
  float sum = 0.f, dot = 0.f;
  for (int i0 = threadIdx.x; i0 < nv; i0 += UNROLL * THREADS) {
    float g[UNROLL][VEC], v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= nv) continue;
      Access<TO, VEC>::load(dy + k.at(i, dy_stride, VEC), g[u]);
      Access<TI, VEC>::load(x + k.at(i, x_stride, VEC), v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u * THREADS >= nv) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sum += g[u][e];
        dot += g[u][e] * (v[u][e] - mean);
      }
    }
  }
  block_sums(sum, dot, red);
  if (threadIdx.x == 0) {
    float* p = ws + (size_t(k.ch) * k.chunks + k.j) * 2;
    p[0] = sum;
    p[1] = dot;
  }
}

// The channel's sums from ws; the first chunk's block writes grad_weight
// and grad_bias; dx, unless null, = TI(((dy - (x - mean) * proj) - sum dy /
// n) * (invstd * w)).
template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(THREADS)
    dx_pass(const TO* __restrict__ dy, long long dy_stride,
            const TI* __restrict__ x, long long x_stride,
            const float* __restrict__ ws, const float* __restrict__ w,
            const float* __restrict__ save_mean,
            const float* __restrict__ save_invstd, TI* __restrict__ dx,
            float* __restrict__ grad_weight, float* __restrict__ grad_bias,
            int n, int c, int l, int ppc) {
  extern __shared__ float red[];
  constexpr int UNROLL = 2;
  const Chunk k(n, l, ppc, VEC);
  float sum = 0.f, dot = 0.f;
  for (int jj = threadIdx.x; jj < k.chunks; jj += THREADS) {
    const float* p = ws + (size_t(k.ch) * k.chunks + jj) * 2;
    sum += p[0];
    dot += p[1];
  }
  block_sums(sum, dot, red);
  const float mean = save_mean[k.ch], invstd = save_invstd[k.ch];
  if (k.j == 0 && threadIdx.x == 0) {
    grad_weight[k.ch] = __fmul_rn(dot, invstd);
    grad_bias[k.ch] = sum;
  }
  if (dx == nullptr) return;
  const float count = float(n) * float(l);
  const float grad_mean = sum / count;
  const float proj = __fmul_rn(__fmul_rn(dot / count, invstd), invstd);
  const float scale = __fmul_rn(invstd, w[k.ch]);
  const long long dx_stride = (long long)c * l;
  const int nv = k.vectors();
  for (int i0 = threadIdx.x; i0 < nv; i0 += UNROLL * THREADS) {
    float g[UNROLL][VEC], v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= nv) continue;
      Access<TO, VEC>::load(dy + k.at(i, dy_stride, VEC), g[u]);
      Access<TI, VEC>::load(x + k.at(i, x_stride, VEC), v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= nv) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[u][e] = __fmul_rn(
            __fadd_rn(__fadd_rn(g[u][e],
                                -__fmul_rn(__fadd_rn(v[u][e], -mean), proj)),
                      -grad_mean),
            scale);
      Access<TI, VEC>::store(dx + k.at(i, dx_stride, VEC), v[u]);
    }
  }
}

}  // namespace channel_norm
