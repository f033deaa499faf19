// CTR-GCN's channel-wise graph aggregation, for Hopper (sm_90a): the tile
// bodies of the forward (ctrgc_fwd.cu) and the backward (ctrgc_bwd.cu).
//
// Replaces no TPU kernel: the JAX package has no CTR-GCN. Eager PyTorch
// runs the op as three batched cuBLAS products of NM C tiny (T x V) (V x V)
// matrices, their sum and the casts around them, and the same again in the
// backward. For one block, x3 (N, K, C, T, V) in T (f32 or bf16) and the
// refined topology s (N, K, C, V, V) in f32:
//
//   aggregate_fwd  z[n,c,t,u]      = sum_k sum_v s[n,k,c,u,v] x3[n,k,c,t,v]
//   aggregate_bwd  dx3[n,k,c,t,v]  = sum_u s[n,k,c,u,v] dz[n,c,t,u]
//                  ds[n,k,c,u,v]   = sum_t dz[n,c,t,u] x3[n,k,c,t,v]
//
// every product summed in f32; z and dx3 stored in T, ds in f32. One pass
// over dz gives both gradients.
//
// A plane is one (n, c): its K topologies (K V V f32) and its K slices of
// x3 (K T V), contiguous in the NCTV layout of the model's 1x1 convs. A
// block stages `ppb` planes whole in shared memory (the host picks ppb so
// that a block's items fill about THREADS threads), zero-padded to TP
// frames (a multiple of TT) and VP joints (a multiple of UT), so that the
// inner loops carry no bounds checks; then each thread takes items, tiles
// of TT frames by UT joints (the forward and dx3) or UT by UT joints (ds),
// and accumulates them in registers. A tile reads TT + UT shared words for
// TT UT multiply-adds a step. Each output element is written once, by one
// thread, in a fixed order: no atomics, and repeats are bit-identical.
//
// What bounds them on the H100: per plane at T = 64 the forward reads
// 7.5 KB of s and 9.6 KB of bf16 x3 and writes 3.2 KB for 120 k multiply-
// adds; device memory and the shared-memory loads take about as long as
// each other, the FMAs less.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace ctrgc {

constexpr int THREADS = 160;
constexpr int TT = 4;  // frames of a tile
constexpr int UT = 5;  // joints of a tile (V = 25: five tiles a row)
// shared memory a block aims to stay under, so that several blocks share
// an SM
constexpr int SMEM_TARGET = 64 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The padded shape of a plane and its items; the host (ops/ctrgc.py)
// computes the same numbers.
struct Geometry {
  int k, t, v, tp, vp, tg, ug;
  __host__ __device__ Geometry(int k_, int t_, int v_)
      : k(k_), t(t_), v(v_), tp(round_up(t_, TT)), vp(round_up(v_, UT)),
        tg(round_up(t_, TT) / TT), ug(round_up(v_, UT) / UT) {}
  __host__ __device__ int s_floats() const { return k * vp * vp; }
  __host__ __device__ int x_elems() const { return k * tp * vp; }
  __host__ __device__ int dz_elems() const { return tp * vp; }
  __host__ __device__ int fwd_items() const { return tg * ug; }
  __host__ __device__ int dx_items() const { return k * tg * ug; }
  __host__ __device__ int ds_items() const { return k * ug * ug; }
  __host__ __device__ int bwd_items() const { return dx_items() + ds_items(); }
};

// bytes of shared memory of one plane (element size es of T)
inline size_t fwd_plane_bytes(const Geometry& g, int es) {
  return 4 * size_t(g.s_floats()) + es * size_t(g.x_elems());
}
inline size_t bwd_plane_bytes(const Geometry& g, int es) {
  return 4 * size_t(g.s_floats()) +
         es * (size_t(g.x_elems()) + size_t(g.dz_elems()));
}

extern __shared__ float4 smem4[];

// Stage plane `plane` of s and of x3 (or dz) into shared memory, zero-
// padded; a plane past the last stages as zeros. Each of the plane's
// `parts` slabs is contiguous in device memory (V V floats of s, T V
// elements of x3); where V needs no padding a slab lands as one run,
// followed by its padded frames.
__device__ __forceinline__ void stage_s(float* dst, const float* s,
                                        long long plane, long long planes,
                                        int c, const Geometry& g) {
  const long long n = plane / c, ch = plane % c;
  const int slab = g.vp * g.vp;
  for (int k = 0; k < g.k; ++k) {
    const float* src = s + ((n * g.k + k) * c + ch) * g.v * g.v;
    float* out = dst + k * slab;
    if (g.vp == g.v) {
      for (int i = threadIdx.x; i < slab; i += THREADS)
        out[i] = plane < planes ? src[i] : 0.0f;
      continue;
    }
    for (int i = threadIdx.x; i < slab; i += THREADS) {
      const int u = i / g.vp, v = i % g.vp;
      out[i] = plane < planes && u < g.v && v < g.v ? src[u * g.v + v]
                                                    : 0.0f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_x(T* dst, const T* x, long long plane,
                                        long long planes, int c, int parts,
                                        const Geometry& g) {
  // parts: K for x3 (N, K, C, T, V), 1 for dz (N, C, T, V)
  const long long n = plane / c, ch = plane % c;
  const int slab = g.tp * g.vp, real = g.t * g.v;
  const T zero = from_f32<T>(0.0f);
  for (int k = 0; k < parts; ++k) {
    const T* src = x + ((n * parts + k) * c + ch) * g.t * g.v;
    T* out = dst + k * slab;
    if (g.vp == g.v) {
      for (int i = threadIdx.x; i < slab; i += THREADS)
        out[i] = plane < planes && i < real ? src[i] : zero;
      continue;
    }
    for (int i = threadIdx.x; i < slab; i += THREADS) {
      const int t = i / g.vp, v = i % g.vp;
      out[i] = plane < planes && t < g.t && v < g.v ? src[t * g.v + v]
                                                    : zero;
    }
  }
}

// z for the planes [blockIdx.x ppb, blockIdx.x ppb + ppb)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    aggregate_fwd(const T* __restrict__ x3, const float* __restrict__ s,
                  T* __restrict__ z, long long planes, int k_parts, int c,
                  int t, int v, int ppb) {
  const Geometry g(k_parts, t, v);
  float* s_sm = reinterpret_cast<float*>(smem4);
  T* x_sm = reinterpret_cast<T*>(s_sm + size_t(ppb) * g.s_floats());
  const long long first = (long long)blockIdx.x * ppb;
  for (int p = 0; p < ppb; ++p) {
    stage_s(s_sm + size_t(p) * g.s_floats(), s, first + p, planes, c, g);
    stage_x<T>(x_sm + size_t(p) * g.x_elems(), x3, first + p, planes, c,
               g.k, g);
  }
  __syncthreads();
  const int items = ppb * g.fwd_items();
  for (int item = threadIdx.x; item < items; item += THREADS) {
    const int p = item / g.fwd_items(), r = item % g.fwd_items();
    const int tg = r / g.ug, ug = r % g.ug;
    const long long plane = first + p;
    if (plane >= planes) continue;
    const float* sp = s_sm + size_t(p) * g.s_floats();
    const T* xp = x_sm + size_t(p) * g.x_elems();
    float acc[TT][UT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int j = 0; j < UT; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < g.k; ++k) {
      const T* xk = xp + (k * g.tp + tg * TT) * g.vp;
      const float* sk = sp + (k * g.vp + ug * UT) * g.vp;
      for (int vv = 0; vv < g.v; ++vv) {
        float a[TT], b[UT];
#pragma unroll
        for (int i = 0; i < TT; ++i) a[i] = to_f32(xk[i * g.vp + vv]);
#pragma unroll
        for (int j = 0; j < UT; ++j) b[j] = sk[j * g.vp + vv];
#pragma unroll
        for (int i = 0; i < TT; ++i)
#pragma unroll
          for (int j = 0; j < UT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    T* zp = z + plane * g.t * g.v;
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const int tt = tg * TT + i;
      if (tt >= g.t) break;
#pragma unroll
      for (int j = 0; j < UT; ++j) {
        const int u = ug * UT + j;
        if (u < g.v) zp[tt * g.v + u] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

// dx3 and ds for the planes [blockIdx.x ppb, blockIdx.x ppb + ppb). The
// items of a plane: first its ds tiles (the longer ones, T steps each),
// then its dx3 tiles (V steps each).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    aggregate_bwd(const T* __restrict__ dz, const T* __restrict__ x3,
                  const float* __restrict__ s, T* __restrict__ dx3,
                  float* __restrict__ ds, long long planes, int k_parts,
                  int c, int t, int v, int ppb) {
  const Geometry g(k_parts, t, v);
  float* s_sm = reinterpret_cast<float*>(smem4);
  T* x_sm = reinterpret_cast<T*>(s_sm + size_t(ppb) * g.s_floats());
  T* dz_sm = x_sm + size_t(ppb) * g.x_elems();
  const long long first = (long long)blockIdx.x * ppb;
  for (int p = 0; p < ppb; ++p) {
    stage_s(s_sm + size_t(p) * g.s_floats(), s, first + p, planes, c, g);
    stage_x<T>(x_sm + size_t(p) * g.x_elems(), x3, first + p, planes, c,
               g.k, g);
    stage_x<T>(dz_sm + size_t(p) * g.dz_elems(), dz, first + p, planes, c,
               1, g);
  }
  __syncthreads();
  const int items = ppb * g.bwd_items();
  for (int item = threadIdx.x; item < items; item += THREADS) {
    const int p = item / g.bwd_items(), r = item % g.bwd_items();
    const long long plane = first + p;
    if (plane >= planes) continue;
    const long long n = plane / c, ch = plane % c;
    const float* sp = s_sm + size_t(p) * g.s_floats();
    const T* xp = x_sm + size_t(p) * g.x_elems();
    const T* dzp = dz_sm + size_t(p) * g.dz_elems();
    if (r < g.ds_items()) {
      const int k = r / (g.ug * g.ug), q = r % (g.ug * g.ug);
      const int ug = q / g.ug, vg = q % g.ug;
      float acc[UT][UT];
#pragma unroll
      for (int i = 0; i < UT; ++i)
#pragma unroll
        for (int j = 0; j < UT; ++j) acc[i][j] = 0.0f;
      const T* dzu = dzp + ug * UT;
      const T* xk = xp + k * g.tp * g.vp + vg * UT;
      for (int tt = 0; tt < g.t; ++tt) {
        float a[UT], b[UT];
#pragma unroll
        for (int i = 0; i < UT; ++i) a[i] = to_f32(dzu[tt * g.vp + i]);
#pragma unroll
        for (int j = 0; j < UT; ++j) b[j] = to_f32(xk[tt * g.vp + j]);
#pragma unroll
        for (int i = 0; i < UT; ++i)
#pragma unroll
          for (int j = 0; j < UT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      float* dsp = ds + ((n * g.k + k) * c + ch) * g.v * g.v;
#pragma unroll
      for (int i = 0; i < UT; ++i) {
        const int u = ug * UT + i;
        if (u >= g.v) break;
#pragma unroll
        for (int j = 0; j < UT; ++j) {
          const int vv = vg * UT + j;
          if (vv < g.v) dsp[u * g.v + vv] = acc[i][j];
        }
      }
    } else {
      const int q0 = r - g.ds_items();
      const int k = q0 / (g.tg * g.ug), q = q0 % (g.tg * g.ug);
      const int tg = q / g.ug, vg = q % g.ug;
      float acc[TT][UT];
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < UT; ++j) acc[i][j] = 0.0f;
      const T* dzt = dzp + tg * TT * g.vp;
      const float* sk = sp + k * g.vp * g.vp + vg * UT;
      for (int u = 0; u < g.v; ++u) {
        float a[TT], b[UT];
#pragma unroll
        for (int i = 0; i < TT; ++i) a[i] = to_f32(dzt[i * g.vp + u]);
#pragma unroll
        for (int j = 0; j < UT; ++j) b[j] = sk[u * g.vp + j];
#pragma unroll
        for (int i = 0; i < TT; ++i)
#pragma unroll
          for (int j = 0; j < UT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      T* dxp = dx3 + ((n * g.k + k) * c + ch) * g.t * g.v;
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const int tt = tg * TT + i;
        if (tt >= g.t) break;
#pragma unroll
        for (int j = 0; j < UT; ++j) {
          const int vv = vg * UT + j;
          if (vv < g.v) dxp[tt * g.v + vv] = from_f32<T>(acc[i][j]);
        }
      }
    }
  }
}

// Planes a block stages: enough items for about THREADS threads, within
// SMEM_TARGET where a plane allows, at least one.
inline int planes_per_block(int items, size_t plane_bytes) {
  int ppb = THREADS / items;
  const int by_smem = int(SMEM_TARGET / plane_bytes);
  if (ppb > by_smem) ppb = by_smem;
  return ppb < 1 ? 1 : ppb;
}

}  // namespace ctrgc
