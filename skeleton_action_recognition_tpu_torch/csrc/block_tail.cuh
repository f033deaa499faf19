// The tail of a fused ST-GCN block, for Hopper (sm_90a): BN2's normalize,
// the residual add and the ReLU after the fused temporal chain's conv
// (tconv_fwd.cu), their backward, and the fold of BN2's statistics'
// cotangents into the conv's output cotangent that tconv_bwd.cu reads.
//
// Replaces no TPU kernel: XLA fuses this elementwise tail into one pass on
// the TPU (skeleton_action_recognition_tpu/models/stgcn.py::
// FusedTemporalConv's `u * scale2 + shift2` and the block's relu(x + res),
// and the VJP's fold in ops/pallas/tconv.py:380-386). Eager PyTorch runs it
// as ~18 full-tensor passes a block. For u (NM, T, V, C), rows = NM T V:
//
//   forward_pass   out = relu(((f32(u) * scale2) + shift2) + f32(res))
//   backward_pass  gm = (out <= 0 ? 0 : g_out); g_u = U(gm * scale2);
//                  g_res = R(gm); per block, the partials of sum gm and
//                  sum gm * f32(u) per channel (g_shift2, g_scale2)
//   gue_pass       gue = U((f32(g_u) + g_sum) + ((2 f32(u)) * g_sumsq))
//
// U is u's type (f32 or bf16), R the residual's; out and g_out are f32, as
// the eager tail leaves them. Each operation is rounded where the eager
// passes round it (__fmul_rn and __fadd_rn keep the compiler from
// contracting them into an FMA), so out, g_u, g_res and gue equal the eager
// results bit for bit, the sign of a zero aside; relu and its mask let a
// NaN through as torch's do.
//
// What bounds them on the H100: a handful of flops an element against 10
// (forward, with a bf16 u and an f32 residual), 16 (backward: g_out, out,
// u in; g_u, g_res out) and 6 (fold) bytes of device memory an element,
// so device-memory bytes alone. Each is one pass over its tensors with
// 16-byte accesses (VEC elements of a row a thread, neighbouring threads on
// neighbouring channels), as many blocks as fill the SMs, and a thread keeps
// one group of VEC channels for the whole walk: its scale2/shift2 (or
// g_sum/g_sumsq) stay in registers, and the backward's channel sums
// accumulate there and meet once in shared memory at the end, in a fixed
// order. Each block writes its partial to a workspace row, and
// channel_sums.cuh adds the rows in an order fixed by the shapes, so
// repeats are bit-identical.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace block_tail {

constexpr int THREADS = 256;
// blocks a launch aims for: four of 256 threads on each of the H100's 132
// SMs. The grid, and so the order of the channel sums, depends on the
// shapes alone (ops/tconv.py::_TAIL_BLOCKS sizes the workspace by it).
constexpr int MAX_BLOCKS = 4 * 132;

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

// N elements of T as one vector access
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// VEC elements at p, in accesses of at most 16 bytes: the tensor starts on
// a 16-byte boundary and VEC divides c, so p is aligned to the access.
template <typename T, int VEC>
struct Access {
  static constexpr int N = int(16 / sizeof(T)) < VEC ? int(16 / sizeof(T))
                                                      : VEC;

  __device__ __forceinline__ static void load(const T* p, float (&x)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; i += N) {
      const Pack<T, N> q = *reinterpret_cast<const Pack<T, N>*>(p + i);
#pragma unroll
      for (int k = 0; k < N; ++k) x[i + k] = to_f32(q.v[k]);
    }
  }

  __device__ __forceinline__ static void store(T* p, const float (&x)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; i += N) {
      Pack<T, N> q;
#pragma unroll
      for (int k = 0; k < N; ++k) q.v[k] = from_f32<T>(x[i + k]);
      *reinterpret_cast<Pack<T, N>*>(p + i) = q;
    }
  }
};

// How a block walks the rows: c / VEC lanes a row (a lane holds channels
// [lane * VEC, lane * VEC + VEC)), THREADS / lanes rows at once; the
// threads past the last whole row idle. Block b takes the row groups b,
// b + grid, b + 2 grid, ... of `slots` rows each.
struct Walk {
  int lanes, slots, lane, slot;
  __device__ __forceinline__ Walk(int c, int vec)
      : lanes(c / vec),
        slots(THREADS / (c / vec)),
        lane(int(threadIdx.x) % (c / vec)),
        slot(int(threadIdx.x) / (c / vec)) {}
  __device__ __forceinline__ bool active() const { return slot < slots; }
  __device__ __forceinline__ long long first() const {
    return (long long)blockIdx.x * slots + slot;
  }
  __device__ __forceinline__ long long stride() const {
    return (long long)gridDim.x * slots;
  }
};

// The blocks of a launch over `rows` rows of c channels.
inline int blocks(long long rows, int c, int vec) {
  const long long slots = THREADS / (c / vec);
  const long long groups = (rows + slots - 1) / slots;
  return int(groups < MAX_BLOCKS ? groups : MAX_BLOCKS);
}

// out = relu(((f32(u) * scale) + shift) + f32(res)); res may be null.
template <typename U, typename R, int VEC>
__global__ void __launch_bounds__(THREADS)
    forward_pass(const U* __restrict__ u, const float* __restrict__ scale,
                 const float* __restrict__ shift, const R* __restrict__ res,
                 float* __restrict__ out, long long rows, int c) {
  const Walk w(c, VEC);
  if (!w.active()) return;
  const int c0 = w.lane * VEC;
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sc[k] = scale[c0 + k];
    sh[k] = shift[c0 + k];
  }
  for (long long r = w.first(); r < rows; r += w.stride()) {
    const size_t at = size_t(r) * c + c0;
    float x[VEC], y[VEC];
    Access<U, VEC>::load(u + at, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = __fadd_rn(__fmul_rn(x[k], sc[k]), sh[k]);
    if (res != nullptr) {
      float rr[VEC];
      Access<R, VEC>::load(res + at, rr);
#pragma unroll
      for (int k = 0; k < VEC; ++k) y[k] = __fadd_rn(y[k], rr[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = y[k] <= 0.f ? 0.f : y[k];
    Access<float, VEC>::store(out + at, y);
  }
}

// gm = (out <= 0 ? 0 : g_out); g_u = U(gm * scale); g_res = R(gm) unless
// g_res is null; ws[blockIdx.x][0, c) the block's partial of sum gm and
// ws[blockIdx.x][c, 2c) of sum gm * f32(u), per channel. Dynamic shared
// memory: 2 * c * (THREADS / (c / VEC)) floats.
template <typename U, typename R, int VEC>
__global__ void __launch_bounds__(THREADS)
    backward_pass(const float* __restrict__ g_out,
                  const float* __restrict__ out, const U* __restrict__ u,
                  const float* __restrict__ scale, U* __restrict__ g_u,
                  R* __restrict__ g_res, float* __restrict__ ws,
                  long long rows, int c) {
  extern __shared__ float red[];
  const Walk w(c, VEC);
  const int c0 = w.lane * VEC;
  float sum[VEC], sum_u[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sum[k] = sum_u[k] = 0.f;
  if (w.active()) {
    float sc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) sc[k] = scale[c0 + k];
    for (long long r = w.first(); r < rows; r += w.stride()) {
      const size_t at = size_t(r) * c + c0;
      float g[VEC], o[VEC], x[VEC], gu[VEC];
      Access<float, VEC>::load(g_out + at, g);
      Access<float, VEC>::load(out + at, o);
      Access<U, VEC>::load(u + at, x);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        g[k] = o[k] <= 0.f ? 0.f : g[k];
        sum[k] += g[k];
        sum_u[k] += g[k] * x[k];
        gu[k] = __fmul_rn(g[k], sc[k]);
      }
      Access<U, VEC>::store(g_u + at, gu);
      if (g_res != nullptr) Access<R, VEC>::store(g_res + at, g);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[size_t(w.slot) * 2 * c + c0 + k] = sum[k];
      red[size_t(w.slot) * 2 * c + c + c0 + k] = sum_u[k];
    }
  }
  __syncthreads();
  // the slots' partials of each of the 2c columns, in slot order
  for (int j = threadIdx.x; j < 2 * c; j += THREADS) {
    float s = 0.f;
    for (int slot = 0; slot < w.slots; ++slot) s += red[size_t(slot) * 2 * c + j];
    ws[size_t(blockIdx.x) * 2 * c + j] = s;
  }
}

// gue = U((f32(g_u) + g_sum) + ((2 f32(u)) * g_sumsq))
template <typename U, int VEC>
__global__ void __launch_bounds__(THREADS)
    gue_pass(const U* __restrict__ g_u, const U* __restrict__ u,
             const float* __restrict__ g_sum,
             const float* __restrict__ g_sumsq, U* __restrict__ gue,
             long long rows, int c) {
  const Walk w(c, VEC);
  if (!w.active()) return;
  const int c0 = w.lane * VEC;
  float gs[VEC], gss[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    gs[k] = g_sum[c0 + k];
    gss[k] = g_sumsq[c0 + k];
  }
  for (long long r = w.first(); r < rows; r += w.stride()) {
    const size_t at = size_t(r) * c + c0;
    float g[VEC], x[VEC];
    Access<U, VEC>::load(g_u + at, g);
    Access<U, VEC>::load(u + at, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      g[k] = __fadd_rn(__fadd_rn(g[k], gs[k]), __fmul_rn(2.f * x[k], gss[k]));
    Access<U, VEC>::store(gue + at, g);
  }
}

// The dynamic shared memory of backward_pass, in bytes.
inline size_t backward_smem(int c, int vec) {
  return sizeof(float) * 2 * c * (THREADS / (c / vec));
}

}  // namespace block_tail
