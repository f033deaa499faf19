// The fused temporal chain's bf16 kernels on the tensor cores: the same
// functions as tconv_tile.cuh's tile_kernel (the forward and the input
// gradient) and tconv_bwd.cu's wgrad_kernel, with the products of bf16
// operands summed in f32 by mma.sync.m16n8k16 instead of the CUDA cores.
//
// What bounds them on the H100: the bf16 tensor cores (989 TFLOP/s dense,
// of which mma.sync reaches a part; wgmma is later work) against ~9 * C
// FLOP per byte moved, so operations at C >= 64; in practice the staging of
// the operands through shared memory and the per-element affine on load.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16 operands): lane = 4 g + q;
// A (16 x 16, row-major): a0 = A[g][2q, 2q+1], a1 = A[g+8][2q, 2q+1],
// a2 = A[g][2q+8, 2q+9], a3 = A[g+8][2q+8, 2q+9]; B (16 x 8): b0 =
// B[2q, 2q+1][g], b1 = B[2q+8, 2q+9][g]; C (16 x 8, f32): c0, c1 =
// C[g][2q, 2q+1], c2, c3 = C[g+8][2q, 2q+1]; the lower half of a 32-bit
// register holds the element of the lower index.
//
// mma_tile_kernel: one block per (clip, MT rows of the clip, CT output
// channels); the rows t * 25 + v of a clip are contiguous, so a tap dt is a
// shift of (dt - 4) * 25 rows and the tile needs 100 halo rows on each side,
// zero outside the clip (after the affine and the ReLU in the forward). The
// 8 warps split the tile 4 (64 rows each) x 2 (32 channels each). The chunk
// of A (MT + 200 rows x CK channels, bf16, [row][k]) and of the weight for
// all 9 taps ([dt][n][k]) are staged in shared memory with rows padded to
// LD elements, so that the fragment loads of a warp hit 32 distinct banks.
// The epilogue is tile_kernel's: the output and per-channel partial sums,
// met across lanes by a fixed butterfly of shuffles and across warps in
// shared memory in a fixed order.
//
// mma_wgrad_kernel: dW[:, :, dt] = gue^T h_dt, a product of depth rows. One
// block per (split of the clips, 64 output channels, 32 input channels); a
// split walks whole clips in chunks of RC rows, so the zero halo of the
// staged h (RC + 200 rows) gives every tap its SAME padding. gue and h are
// staged transposed ([channel][row]), the A fragment of gue is loaded once
// a k-step and used by all 9 taps; the B fragment of tap dt starts at row
// 25 dt, an odd offset for odd dt, so it is gathered by 16-bit loads (a
// second copy of h one row on, for aligned 32-bit loads, took 1.6x as long
// on an H100: it halves the blocks an SM holds). Each block writes its
// split's partial of dW (and of dbias) as wgrad_kernel does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tconv_tile.cuh"

namespace tconv_mma {

using tconv::HALO;
using tconv::KS;
using tconv::V;
using bf16 = __nv_bfloat16;

constexpr int HALO_ROWS = HALO * V;    // 100
constexpr int MT = 256;                // rows per tile
constexpr int CT = 64;                 // output channels per tile
constexpr int CK = 32;                 // reduction channels per chunk
constexpr int LD = CK + 8;             // staged row, in bf16
constexpr int A_ROWS = MT + 2 * HALO_ROWS;
constexpr int THREADS = 256;

struct TileSmem {
  bf16 a[A_ROWS * LD];                 // [halo'd row][k]
  bf16 w[KS * CT * LD];                // [dt][n][k]
  float red[2][4][CT];                 // [sum][warp row][channel]
};

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned load_pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// two bf16 at any alignment, the first in the lower half
__device__ __forceinline__ unsigned gather_pair(const bf16* p) {
  const unsigned short lo = *reinterpret_cast<const unsigned short*>(p);
  const unsigned short hi = *reinterpret_cast<const unsigned short*>(p + 1);
  return unsigned(lo) | (unsigned(hi) << 16);
}

// Sum v over the 8 lanes that share lane % 4, in a fixed order.
__device__ __forceinline__ float lane_group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Blocks of mma_tile_kernel: grid.x (also the number of partials), grid.y.
inline dim3 tile_grid(int nm, int t_len, int c) {
  return dim3(nm * ((t_len * V + MT - 1) / MT), (c + CT - 1) / CT);
}

// tconv::tile_kernel<MODE>'s function for bf16 operands (rounded to bf16
// where that file's header says), on the tensor cores.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    mma_tile_kernel(const bf16* __restrict__ in, const bf16* __restrict__ s_in,
                    const float* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    float* __restrict__ partials, int t_len, int c) {
  extern __shared__ float4 smem4[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int clip_rows = t_len * V;
  const int tiles = (clip_rows + MT - 1) / MT;
  const int n = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * MT;
  const int j0 = blockIdx.y * CT;
  const size_t clip = size_t(n) * clip_rows * c;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int c0 = 0; c0 < c; c0 += CK) {
    __syncthreads();  // the previous chunk is consumed
    // A in pairs of channels (one 32-bit load; c is even, so a pair never
    // straddles a row or the end of the channels)
    for (int i = tid; i < A_ROWS * CK / 2; i += THREADS) {
      const int row = i / (CK / 2), kl = 2 * (i % (CK / 2)), k = c0 + kl;
      const int gr = r0 - HALO_ROWS + row;  // row of the clip
      float2 val = {0.f, 0.f};
      if (gr >= 0 && gr < clip_rows && k < c) {
        val = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            in + clip + size_t(gr) * c + k));
        if (MODE == tconv::MODE_FWD) {
          val.x = fmaxf(tconv::affine(val.x, scale[k], shift[k]), 0.f);
          val.y = fmaxf(tconv::affine(val.y, scale[k + 1], shift[k + 1]),
                        0.f);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(sm.a + row * LD + kl) =
          __float22bfloat162_rn(val);
    }
    for (int i = tid; i < KS * CT * CK; i += THREADS) {
      int jl, kl, tap;
      tconv::weight_index<MODE>(i, CK, CT, jl, kl, tap);
      const int j = j0 + jl, k = c0 + kl;
      const int dt = MODE == tconv::MODE_FWD ? tap : KS - 1 - tap;
      sm.w[(dt * CT + jl) * LD + kl] = __float2bfloat16(
          k < c && j < c ? tconv::weight_at<MODE>(w, c, j, k, tap) : 0.f);
    }
    __syncthreads();
#pragma unroll 1
    for (int dt = 0; dt < KS; ++dt) {
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        unsigned af[4][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const bf16* p =
              sm.a + (wm * 64 + mt * 16 + g + dt * V) * LD + kk + 2 * q;
          af[mt][0] = load_pair(p);
          af[mt][1] = load_pair(p + 8 * LD);
          af[mt][2] = load_pair(p + 8);
          af[mt][3] = load_pair(p + 8 * LD + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* p =
              sm.w + (dt * CT + wn * 32 + nt * 8 + g) * LD + kk + 2 * q;
          bfr[nt][0] = load_pair(p);
          bfr[nt][1] = load_pair(p + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], af[mt], bfr[nt]);
      }
    }
  }

  // epilogue: the output, and this lane's part of the two channel sums of
  // its 8 channels (wn * 32 + nt * 8 + 2 q + e)
  float sum0[4][2], sum1[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) sum0[nt][0] = sum0[nt][1] = sum1[nt][0] =
      sum1[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gr = r0 + wm * 64 + mt * 16 + g + 8 * half;
      if (gr >= clip_rows) continue;
      const size_t base = clip + size_t(gr) * c;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + wn * 32 + nt * 8 + 2 * q + e;
          if (j >= c) continue;
          const float v = acc[mt][nt][2 * half + e];
          if (MODE == tconv::MODE_FWD) {
            const bf16 u = __float2bfloat16(v + bias[j]);
            out[base + j] = u;
            const float r = __bfloat162float(u);
            sum0[nt][e] += r;
            sum1[nt][e] += r * r;
          } else {
            const float sv = __bfloat162float(s_in[base + j]);
            const float ghm =
                tconv::affine(sv, scale[j], shift[j]) > 0.f ? v : 0.f;
            out[base + j] = __float2bfloat16(ghm * scale[j]);
            sum0[nt][e] += ghm * sv;
            sum1[nt][e] += ghm;
          }
        }
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = lane_group_sum(sum0[nt][e]);
      const float a1 = lane_group_sum(sum1[nt][e]);
      if (g == 0) {
        const int jl = wn * 32 + nt * 8 + 2 * q + e;
        sm.red[0][wm][jl] = a0;
        sm.red[1][wm][jl] = a1;
      }
    }
  __syncthreads();
  if (tid < 2 * CT) {
    const int which = tid / CT, jl = tid % CT;
    if (j0 + jl < c) {
      float total = 0.f;
      for (int r = 0; r < 4; ++r) total += sm.red[which][r][jl];
      partials[(size_t(blockIdx.x) * 2 + which) * c + j0 + jl] = total;
    }
  }
}

template <int MODE>
cudaError_t launch_tile(const bf16* in, const bf16* s_in, const float* w,
                        const float* scale, const float* shift,
                        const float* bias, bf16* out, float* partials, int nm,
                        int t_len, int c, cudaStream_t stream) {
  const int smem = int(sizeof(TileSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mma_tile_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  mma_tile_kernel<MODE><<<tile_grid(nm, t_len, c), THREADS, smem, stream>>>(
      in, s_in, w, scale, shift, bias, out, partials, t_len, c);
  return cudaGetLastError();
}

constexpr int RC = 400;                       // dW: rows per chunk
constexpr int WG_CO = 64;                     // dW: output channels per block
constexpr int WG_CI = 32;                     // dW: input channels per block
constexpr int LDG = RC + 8;                   // staged gue row, in bf16
constexpr int LDH = RC + 2 * HALO_ROWS + 16;  // staged h row, in bf16

struct WgradSmem {
  bf16 g[WG_CO * LDG];   // [co][row]
  bf16 h[WG_CI * LDH];   // [ci][halo'd row]
};

// ws: [split][9 * c * c + c], as tconv_bwd.cu's wgrad_kernel; a split is
// the clips [nm * split / splits, nm * (split + 1) / splits).
__global__ void __launch_bounds__(THREADS)
    mma_wgrad_kernel(const bf16* __restrict__ s, const bf16* __restrict__ gue,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ ws,
                     int nm, int t_len, int c) {
  extern __shared__ float4 smem4[];
  WgradSmem& sm = *reinterpret_cast<WgradSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;  // 16 co, 16 ci each
  const int split = blockIdx.x, splits = gridDim.x;
  const int o0 = blockIdx.y * WG_CO, i0 = blockIdx.z * WG_CI;
  const int clip_rows = t_len * V;
  const int n_begin = int(static_cast<long long>(nm) * split / splits);
  const int n_end = int(static_cast<long long>(nm) * (split + 1) / splits);
  const bool bias_block = blockIdx.z == 0;

  float acc[KS][2][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][nt][e] = 0.f;
  float bacc = 0.f;  // thread tid < WG_CO: dbias of channel o0 + tid

  for (int n = n_begin; n < n_end; ++n) {
    const size_t clip = size_t(n) * clip_rows * c;
    for (int r0 = 0; r0 < clip_rows; r0 += RC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < RC * WG_CO; i += THREADS) {
        const int row = i / WG_CO, col = i % WG_CO, o = o0 + col;
        const int gr = r0 + row;
        sm.g[col * LDG + row] =
            (gr < clip_rows && o < c) ? gue[clip + size_t(gr) * c + o]
                                      : __float2bfloat16(0.f);
      }
      for (int i = tid; i < (RC + 2 * HALO_ROWS) * WG_CI; i += THREADS) {
        const int row = i / WG_CI, col = i % WG_CI, k = i0 + col;
        const int gr = r0 - HALO_ROWS + row;
        float val = 0.f;
        if (gr >= 0 && gr < clip_rows && k < c) {
          const float raw = __bfloat162float(s[clip + size_t(gr) * c + k]);
          val = fmaxf(tconv::affine(raw, scale[k], shift[k]), 0.f);
        }
        sm.h[col * LDH + row] = __float2bfloat16(val);
      }
      __syncthreads();
      if (bias_block && tid < WG_CO) {
        const bf16* gp = sm.g + tid * LDG;
        for (int row = 0; row < RC; ++row) bacc += __bfloat162float(gp[row]);
      }
#pragma unroll 1
      for (int kk = 0; kk < RC; kk += 16) {
        unsigned af[4];
        const bf16* pa = sm.g + (wm * 16 + g) * LDG + kk + 2 * q;
        af[0] = load_pair(pa);
        af[1] = load_pair(pa + 8 * LDG);
        af[2] = load_pair(pa + 8);
        af[3] = load_pair(pa + 8 * LDG + 8);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            // tap dt of row r reads h row r + (dt - 4) * 25: staged row
            // r + 25 dt
            const bf16* pb =
                sm.h + (wn * 16 + nt * 8 + g) * LDH + kk + 2 * q + dt * V;
            const unsigned b[2] = {gather_pair(pb), gather_pair(pb + 8)};
            mma(acc[dt][nt], af, b);
          }
        }
      }
    }
  }

  const size_t n_w = size_t(KS) * c * c;
  float* pw = ws + size_t(split) * (n_w + c);
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + wm * 16 + g + 8 * (e / 2);
        const int ci = i0 + wn * 16 + nt * 8 + 2 * q + e % 2;
        if (o < c && ci < c)
          pw[(size_t(o) * c + ci) * KS + dt] = acc[dt][nt][e];
      }
  if (bias_block && tid < WG_CO && o0 + tid < c) pw[n_w + o0 + tid] = bacc;
}

inline cudaError_t launch_wgrad(const bf16* s, const bf16* gue,
                                const float* scale, const float* shift,
                                float* ws, int nm, int t_len, int c,
                                int splits, cudaStream_t stream) {
  const int smem = int(sizeof(WgradSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mma_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (c + WG_CO - 1) / WG_CO, (c + WG_CI - 1) / WG_CI);
  mma_wgrad_kernel<<<grid, THREADS, smem, stream>>>(s, gue, scale, shift, ws,
                                                    nm, t_len, c);
  return cudaGetLastError();
}

}  // namespace tconv_mma
