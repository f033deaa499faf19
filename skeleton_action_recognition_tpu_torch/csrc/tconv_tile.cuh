// The 9-tap temporal conv over one tile of frames, shared by the forward
// (tconv_fwd.cu) and the input gradient of the backward (tconv_bwd.cu).
//
// Activations are channels-last (NM, T, V, C) with V = 25 joints. A tap dt
// of the SAME-padded conv reads frame t + dt - 4 of the same clip, i.e. the
// row V * (dt - 4) rows away, and frames outside [0, T) read zero. So the
// conv is an implicit GEMM of depth 9 * C:
//
//     acc[t, v, j] = sum_dt sum_k  A[t + dt - 4, v, k] * Wt[dt, k, j]
//
// forward (MODE_FWD):  A = relu(s * scale + shift), zero outside [0, T)
//                      (the zero padding is applied after the affine and
//                      the ReLU: relu(0 * scale + shift) is not 0),
//                      rounded to the matmul type; Wt[dt, ci, co] =
//                      W[co, ci, dt]; epilogue u = acc + bias, rounded to
//                      s's dtype, and per-channel sums of u and u^2;
// input gradient       A = gue (the conv output's cotangent), zero outside
// (MODE_DGRAD):        [0, T); Wt[dt, co, ci] = W[co, ci, 8 - dt] (the taps
//                      reversed and transposed); epilogue ghm = acc where
//                      relu(s * scale + shift) > 0 (in f32), else 0; g_s =
//                      ghm * scale rounded to s's dtype, and per-channel
//                      sums of ghm * s (dscale) and ghm (dshift).
//
// W is nn.Conv2d's (C, C, 9, 1) weight in f32. The roundings to the matmul
// type and to s's dtype above are those of the bf16 chain, which runs on the
// tensor cores (tconv_mma.cuh, which shares this file's helpers); this
// kernel serves f32 alone, where they are the identity, and sums in f32.
//
// What bounds it on the H100: per output element 9 * C multiply-adds against
// a few bytes of input and output, ~9 * C / 2 FLOP per byte in f32 (288 at
// C = 64): operations, not bytes. It runs on the CUDA cores (67 TFLOP/s
// f32, TF32 off).
//
// Design: one thread block per (clip, TF frames, CT output channels).
// Thread (f, q) owns frame f of the tile and channels 4q .. 4q + 3 of the
// block's CT, for all 25 joints: 100 f32 accumulators in registers. The
// reduction runs over chunks of CK input channels: the chunk of A for the
// tile's TF frames and the 4-frame halo on each side (TF + 8 frames), with
// the affine, ReLU and edge mask applied once on load, and the
// chunk of Wt for all 9 taps, are staged in shared memory. Each (tap,
// channel) step reads one float4 of Wt and 25 broadcast values of A and
// does 100 FMAs. The epilogue's two channel sums meet across the tile's
// frames in a fixed order in shared memory and leave as one partial per
// block for channel_sums.cuh: no float atomics.

#pragma once

#include <cuda_runtime.h>

namespace tconv {

constexpr int V = 25;      // NTU RGB+D joints
constexpr int KS = 9;      // temporal taps
constexpr int HALO = KS / 2;
constexpr int TF = 16;     // frames per tile
constexpr int CT = 64;     // output channels per tile
constexpr int CK = 16;     // reduction channels per chunk
constexpr int QUADS = CT / 4;
constexpr int THREADS = TF * QUADS;
constexpr int A_ROWS = (TF + 2 * HALO) * V;

constexpr int MODE_FWD = 0;
constexpr int MODE_DGRAD = 1;

struct TileSmem {
  float a[A_ROWS * CK];           // [row][k], row = halo'd frame * V + v
  float w[KS * CK * CT];          // [dt][k][j]
  float red[2][TF][CT];           // the epilogue's per-frame channel sums
};

// s * scale + shift rounded after the product and after the sum, as the
// plain versions compute it (no fused multiply-add): the ReLU mask, and h,
// then agree with them bit for bit.
__device__ __forceinline__ float affine(float s, float scale, float shift) {
  return __fadd_rn(__fmul_rn(s, scale), shift);
}

// The staged weight's element i of a chunk of ck reduction channels and ct
// output channels -> (output channel jl, reduction channel kl, W's tap
// index), ordered so that neighbouring i read neighbouring floats of W:
// W[j, k, :] is contiguous, and the forward reduces over k = ci, the input
// gradient over k = co.
template <int MODE>
__device__ __forceinline__ void weight_index(int i, int ck, int ct, int& jl,
                                             int& kl, int& tap) {
  if (MODE == MODE_FWD) {
    jl = i / (ck * KS);
    kl = (i / KS) % ck;
  } else {
    kl = i / (ct * KS);
    jl = (i / KS) % ct;
  }
  tap = i % KS;
}

// W[co, ci, tap] of nn.Conv2d's (c, c, 9, 1) weight for output channel j
// and reduction channel k of the MODE's product.
template <int MODE>
__device__ __forceinline__ float weight_at(const float* __restrict__ w, int c,
                                           int j, int k, int tap) {
  return MODE == MODE_FWD ? w[(size_t(j) * c + k) * KS + tap]
                          : w[(size_t(k) * c + j) * KS + tap];
}

// in: A's source, (nm, t_len, V, c) f32 (MODE_FWD: s; MODE_DGRAD: gue).
// s: the forward input (MODE_DGRAD's mask and dscale; unused in MODE_FWD).
// out: (nm, t_len, V, c) f32 (u, or g_s). partials: [blockIdx.x][2][c].
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    tile_kernel(const float* __restrict__ in, const float* __restrict__ s_in,
                const float* __restrict__ w, const float* __restrict__ scale,
                const float* __restrict__ shift,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ partials, int t_len, int c) {
  extern __shared__ float4 smem4[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem4);
  const int tid = threadIdx.x;
  const int f = tid / QUADS, q = tid % QUADS;
  const int tiles = (t_len + TF - 1) / TF;
  const int n = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * TF;
  const int j0 = blockIdx.y * CT;
  const size_t clip = size_t(n) * t_len * V * c;

  float acc[V][4];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[v][i] = 0.f;

  for (int c0 = 0; c0 < c; c0 += CK) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < A_ROWS * CK; i += THREADS) {
      const int row = i / CK, k = c0 + i % CK;
      const int t = t0 - HALO + row / V;
      float val = 0.f;
      if (t >= 0 && t < t_len && k < c) {
        const float raw = in[clip + (size_t(t) * V + row % V) * c + k];
        val = MODE == MODE_FWD ? fmaxf(affine(raw, scale[k], shift[k]), 0.f)
                               : raw;
      }
      sm.a[i] = val;
    }
    for (int i = tid; i < KS * CK * CT; i += THREADS) {
      int jl, kl, tap;
      weight_index<MODE>(i, CK, CT, jl, kl, tap);
      const int j = j0 + jl, k = c0 + kl;
      const int dt = MODE == MODE_FWD ? tap : KS - 1 - tap;
      sm.w[(dt * CK + kl) * CT + jl] =
          k < c && j < c ? weight_at<MODE>(w, c, j, k, tap) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      const float* arow = sm.a + (f + dt) * V * CK;
#pragma unroll 4
      for (int k = 0; k < CK; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(
            &sm.w[(dt * CK + k) * CT + 4 * q]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float av = arow[v * CK + k];
          acc[v][0] += av * wv.x;
          acc[v][1] += av * wv.y;
          acc[v][2] += av * wv.z;
          acc[v][3] += av * wv.w;
        }
      }
    }
  }

  // epilogue: the output, and this thread's part of the two channel sums
  const int t = t0 + f;
  float sum0[4] = {0.f, 0.f, 0.f, 0.f}, sum1[4] = {0.f, 0.f, 0.f, 0.f};
  if (t < t_len) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + 4 * q + i;
      if (j >= c) continue;
      const size_t base = clip + size_t(t) * V * c + j;
      if (MODE == MODE_FWD) {
        const float b = bias[j];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float u = acc[v][i] + b;
          out[base + size_t(v) * c] = u;
          sum0[i] += u;
          sum1[i] += u * u;
        }
      } else {
        const float sc = scale[j], sh = shift[j];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float sv = s_in[base + size_t(v) * c];
          const float ghm = affine(sv, sc, sh) > 0.f ? acc[v][i] : 0.f;
          out[base + size_t(v) * c] = ghm * sc;
          sum0[i] += ghm * sv;
          sum1[i] += ghm;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sm.red[0][f][4 * q + i] = sum0[i];
    sm.red[1][f][4 * q + i] = sum1[i];
  }
  __syncthreads();
  if (tid < 2 * CT) {
    const int which = tid / CT, jl = tid % CT;
    if (j0 + jl < c) {
      float total = 0.f;
      for (int ff = 0; ff < TF; ++ff) total += sm.red[which][ff][jl];
      partials[(size_t(blockIdx.x) * 2 + which) * c + j0 + jl] = total;
    }
  }
}

// Blocks of tile_kernel for nm clips of t_len frames: grid.x (also the
// number of partials), grid.y.
inline dim3 tile_grid(int nm, int t_len, int c) {
  return dim3(nm * ((t_len + TF - 1) / TF), (c + CT - 1) / CT);
}

template <int MODE>
cudaError_t launch_tile(const float* in, const float* s_in, const float* w,
                        const float* scale, const float* shift,
                        const float* bias, float* out, float* partials, int nm,
                        int t_len, int c, cudaStream_t stream) {
  const int smem = int(sizeof(TileSmem));
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  tile_kernel<MODE><<<tile_grid(nm, t_len, c), THREADS, smem, stream>>>(
      in, s_in, w, scale, shift, bias, out, partials, t_len, c);
  return cudaGetLastError();
}

}  // namespace tconv
