// The 9-tap temporal conv over one tile of frames, shared by the forward
// (tconv_fwd.cu) and the input gradient of the backward (tconv_bwd.cu).
//
// Activations are channels-last (NM, T, V, C) with V = 25 joints. A tap dt
// of the SAME-padded conv reads frame t + dt - 4 of the same clip, i.e. the
// row V * (dt - 4) rows away, and frames outside [0, T) read zero. So the
// conv is an implicit GEMM of depth 9 * C:
//
//     acc[t, v, j] = sum_dt sum_k  A[t + dt - 4, v, k] * Wt[k, dt, j]
//
// forward (MODE_FWD):  A = relu(s * scale + shift), zero outside [0, T)
//                      (the zero padding is applied after the affine and
//                      the ReLU: relu(0 * scale + shift) is not 0),
//                      rounded to the matmul type; Wt[ci, dt, co] =
//                      W[co, ci, dt]; epilogue u = acc + bias, rounded to
//                      s's dtype, and per-channel sums of u and u^2;
// input gradient       A = gue (the conv output's cotangent), zero outside
// (MODE_DGRAD):        [0, T); Wt[co, dt, ci] = W[co, ci, 8 - dt] (the taps
//                      reversed and transposed); epilogue ghm = acc where
//                      relu(s * scale + shift) > 0 (in f32), else 0; g_s =
//                      ghm * scale rounded to s's dtype, and per-channel
//                      sums of ghm * s (dscale) and ghm (dshift).
//
// Wt is the (C, 9, C) f32 operand that ops/tconv.py::weight_operands
// permutes from nn.Conv2d's weight once a call (the JAX wrapper's wall and
// wt). The roundings to the matmul type and to s's dtype above are those
// of the bf16 chain, which runs on the tensor cores (tconv_mma.cuh, which
// shares this file's helpers); this kernel serves f32 alone, where they are
// the identity, and sums in f32 on the CUDA cores, never in TF32.
//
// What bounds it on the H100: per output element 9 * C multiply-adds against
// a few bytes of input and output, ~9 * C / 2 FLOP per byte in f32 (288 at
// C = 64): operations, not bytes. It runs on the CUDA cores (67 TFLOP/s
// f32), so what sets its time is how many instructions other than FFMAs a
// warp issues, and above all shared-memory loads.
//
// Design: the conv is 1-D in time, so the time axis is the register block,
// and the joints are independent: a clip's joint v is a sequence of T frames,
// and the tile kernel walks the nm * 25 sequences (clip-major) as rows of a
// grid. One thread block of 384 threads (12 warps) per (SLOTS = 24 sequences,
// TF = 16 frames, CT = 64 output channels), one block an SM, at up to 168
// registers a thread. Thread (fg, slot, cg) owns frames 8 fg .. 8 fg + 7 of
// the tile in its sequence and the output channels 4 cg .. 4 cg + 3 and 32 +
// 4 cg .. 32 + 4 cg + 3: 64 f32 accumulators. A is staged as
// [k][sequence][frame], frames contiguous with the 4-frame halo on each side
// (24 a sequence); for each reduction channel k a thread loads its sequence's
// 16-frame window once (four aligned float4s, broadcast to the 8 threads of a
// sequence) and, for each of the 9 taps (unrolled: the window's registers are
// indexed statically), 8 weights (two float4s, 128 contiguous bytes a warp)
// and does 64 FFMAs with window[dt .. dt + 7]: 22 shared loads per 576 FFMAs.
// The reduction runs over chunks of CK = 8 channels in a two-stage ring: the
// next chunk arrives by cp.async while this one is multiplied, its weights in
// 16-byte copies and A in 4-byte copies that transpose it on the way (so
// staging holds no registers), and after the products each thread applies the
// affine and ReLU in place to its own copies, on the clips' frames only (halo
// frames stay zero). Each cell's row of the input is tabled once a block: no
// divides. One barrier a chunk. The epilogue's two channel sums meet across
// the tile's 48 (sequence, frame group) threads in a fixed order in shared
// memory and leave as one partial per block for channel_sums.cuh: no float
// atomics.
//
// The warps an SM holds, and the registers they may use, set the rate (#4 at
// the model's shapes on an H100): one block of 13 warps (a clip's 25 joints a
// tile) at 128 registers, spilling, 68.4 ms; two blocks of 8 warps (16
// sequences) at 128, spilling, 53.1; this, without spills, 55.3; one block of
// 8 warps at 160, 59.7.

#pragma once

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace tconv {

constexpr int V = 25;      // NTU RGB+D joints
constexpr int KS = 9;      // temporal taps
constexpr int HALO = KS / 2;

constexpr int MODE_FWD = 0;
constexpr int MODE_DGRAD = 1;

constexpr int TF = 16;                     // frames per tile
constexpr int FT = 8;                      // frames per thread
constexpr int CT = 64;                     // output channels per tile
constexpr int CK = 8;                      // reduction channels per chunk
constexpr int NQ = CT / 8;                 // channel groups, 8 a thread
constexpr int SLOTS = 24;                  // (clip, joint) sequences a tile
constexpr int MIN_BLOCKS = 1;              // blocks an SM
constexpr int GROUPS = SLOTS * (TF / FT);  // (sequence, frame group) pairs
constexpr int THREADS = NQ * GROUPS;       // 384
constexpr int AF = TF + 2 * HALO;          // staged frames a sequence
constexpr int A_CELLS = SLOTS * AF;        // (sequence, frame) cells
constexpr int A_PLANE = A_CELLS + 4;       // a channel's plane, padded
constexpr int A_PER_THREAD = A_CELLS * CK / THREADS;  // floats a chunk
constexpr int W_ROWS = CK * KS;            // [k][dt] rows of CT weights
constexpr int W_ITEMS = W_ROWS * CT / 4;   // float4s of Wt a chunk

static_assert(A_CELLS * CK % THREADS == 0 && THREADS % CK == 0,
              "each thread stages one channel of a chunk, cells evenly");
static_assert(A_PLANE % 4 == 0, "windows are float4-aligned");

struct TileSmem {
  float a[2][CK * A_PLANE];  // [k][joint][frame]
  float w[2][W_ROWS * CT];   // [k][dt][j]
  int cell_row[A_CELLS];     // each cell's row of the input, or -1
};
static_assert(2 * GROUPS * CT <= 2 * CK * A_PLANE,
              "the epilogue's sums fit in the A stages");

// s * scale + shift rounded after the product and after the sum, as the
// plain versions compute it (no fused multiply-add): the ReLU mask, and h,
// then agree with them bit for bit.
__device__ __forceinline__ float affine(float s, float scale, float shift) {
  return __fadd_rn(__fmul_rn(s, scale), shift);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Four floats of a row at column k of c: one float4 where the rows are
// 16-byte aligned (c % 4 == 0, so the four are all in or all out), else
// four guarded loads; zeros past c.
__device__ __forceinline__ float4 load4(const float* row, int k, int c,
                                        bool aligned) {
  if (aligned)
    return k < c ? __ldg(reinterpret_cast<const float4*>(row + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v;
  v.x = k < c ? __ldg(row + k) : 0.f;
  v.y = k + 1 < c ? __ldg(row + k + 1) : 0.f;
  v.z = k + 2 < c ? __ldg(row + k + 2) : 0.f;
  v.w = k + 3 < c ? __ldg(row + k + 3) : 0.f;
  return v;
}

__device__ __forceinline__ void store4(float* row, int k, int c, float4 v,
                                       bool aligned) {
  if (aligned) {
    if (k < c) *reinterpret_cast<float4*>(row + k) = v;
    return;
  }
  if (k < c) row[k] = v.x;
  if (k + 1 < c) row[k + 1] = v.y;
  if (k + 2 < c) row[k + 2] = v.z;
  if (k + 3 < c) row[k + 3] = v.w;
}

// 4 bytes from global to shared memory, asynchronously; zero where !valid
// (src is then not read). A copy this small goes through L1 (.ca).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma_bf16::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// in: A's source, (nm, t_len, V, c) f32 (MODE_FWD: s; MODE_DGRAD: gue).
// s: the forward input (MODE_DGRAD's mask and dscale; unused in MODE_FWD).
// w: the (c, 9, c) operand Wt. out: (nm, t_len, V, c) f32 (u, or g_s).
// partials: [blockIdx.x][2][c]. A tile is (SLOTS sequences from
// blockIdx.x / tiles * SLOTS of the nm * 25 (clip, joint) sequences, clip
// n's joint v being sequence 25 n + v; TF frames from blockIdx.x % tiles *
// TF; CT output channels from blockIdx.y * CT).
template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    tile_kernel(const float* __restrict__ in, const float* __restrict__ s_in,
                const float* __restrict__ w, const float* __restrict__ scale,
                const float* __restrict__ shift,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ partials, int nm, int t_len, int c) {
  extern __shared__ float4 smem4[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem4);
  const int tid = threadIdx.x;
  const int cg = tid % NQ, group = tid / NQ;
  const int slot = group % SLOTS, fg = group / SLOTS;
  const int tiles = (t_len + TF - 1) / TF;
  const int s0 = blockIdx.x / tiles * SLOTS;
  const int t0 = (blockIdx.x % tiles) * TF;
  const int j0 = blockIdx.y * CT;
  const bool aligned = c % 4 == 0 && aligned16(in) && aligned16(w) &&
                       aligned16(out) &&
                       (MODE == MODE_FWD || aligned16(s_in));
  const int chunks = (c + CK - 1) / CK;
  // the reduction channel of a chunk (of 8) this thread stages
  const int kl = tid % CK;

  // each staged cell's row of the input, ((n * t_len + t) * V + v), or -1
  // off the clips
  for (int cell = tid; cell < A_CELLS; cell += THREADS) {
    const int t = t0 - HALO + cell % AF, seq = s0 + cell / AF;
    sm.cell_row[cell] = t >= 0 && t < t_len && seq < nm * V
                            ? (seq / V * t_len + t) * V + seq % V
                            : -1;
  }
  __syncthreads();
  // A of the chunk from channel c0, transposed on the way by 4-byte
  // copies: item r of this thread is cell tid / 8 + r * THREADS / 8
  // (sequence-major, frames fastest), channel c0 + kl; zeros off the
  // clips and past c
  auto stage_a = [&](int c0, float* dst) {
    const int k = c0 + kl;
#pragma unroll
    for (int r = 0; r < A_PER_THREAD; ++r) {
      const int cell = tid / CK + r * (THREADS / CK);
      const int row = sm.cell_row[cell];
      const bool ok = row >= 0 && k < c;
      cp_async4(dst + kl * A_PLANE + cell,
                ok ? in + size_t(row) * c + k : in, ok);
    }
  };
  // MODE_FWD: h = relu(s * scale + shift) in place on this thread's own
  // copies of the clips' frames, once they have arrived (halo frames stay
  // zero: relu(shift) is not 0)
  auto affine_a = [&](int c0, float* dst) {
    const int k = c0 + kl;
    if (MODE != MODE_FWD || k >= c) return;
    const float sc = scale[k], sh = shift[k];
#pragma unroll
    for (int r = 0; r < A_PER_THREAD; ++r) {
      const int cell = tid / CK + r * (THREADS / CK);
      float* p = dst + kl * A_PLANE + cell;
      if (sm.cell_row[cell] >= 0) *p = fmaxf(affine(*p, sc, sh), 0.f);
    }
  };
  // Wt's rows (k, dt) for k of the chunk from c0, columns j0 .. j0 + 63
  auto stage_w = [&](int c0, float* dst) {
    if (aligned) {
      for (int e = tid; e < W_ITEMS; e += THREADS) {
        const int row = e / (CT / 4), col = 4 * (e % (CT / 4));
        const int k = c0 + row / KS, j = j0 + col;
        const bool ok = k < c && j < c;
        mma_bf16::cp_async16(
            dst + row * CT + col,
            ok ? w + (size_t(k) * KS + row % KS) * c + j : w, ok);
      }
    } else {
      for (int e = tid; e < W_ROWS * CT; e += THREADS) {
        const int row = e / CT, k = c0 + row / KS, j = j0 + e % CT;
        dst[e] = k < c && j < c ? w[(size_t(k) * KS + row % KS) * c + j]
                                : 0.f;
      }
    }
    mma_bf16::cp_async_commit();
  };

  float acc[FT][8];
#pragma unroll
  for (int f = 0; f < FT; ++f)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[f][i] = 0.f;

  stage_a(0, sm.a[0]);
  stage_w(0, sm.w[0]);
  mma_bf16::cp_async_wait_all();
  affine_a(0, sm.a[0]);
  __syncthreads();
  for (int i = 0; i < chunks; ++i) {
    const int b = i & 1;
    const bool more = i + 1 < chunks;
    if (more) {
      stage_a((i + 1) * CK, sm.a[b ^ 1]);
      stage_w((i + 1) * CK, sm.w[b ^ 1]);
    }
    const float* abase = sm.a[b] + slot * AF + fg * FT;
    const float* wbase = sm.w[b] + 4 * cg;
#pragma unroll 2
    for (int k = 0; k < CK; ++k) {
      // the window's last float4 is loaded once the first is spent (tap
      // 4 on): 12 of its registers live at a time
      float win[FT + KS - 1];
      auto load_win = [&](int e) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(abase + k * A_PLANE + 4 * e);
        win[4 * e] = a4.x;
        win[4 * e + 1] = a4.y;
        win[4 * e + 2] = a4.z;
        win[4 * e + 3] = a4.w;
      };
#pragma unroll
      for (int e = 0; e < 3; ++e) load_win(e);
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        if (dt == 4) load_win(3);
        const float* wr = wbase + (k * KS + dt) * CT;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 32);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                             w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int f = 0; f < FT; ++f)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[f][jj] = fmaf(win[f + dt], wv[jj], acc[f][jj]);
      }
    }
    if (more) {
      mma_bf16::cp_async_wait_all();
      affine_a((i + 1) * CK, sm.a[b ^ 1]);
    }
    __syncthreads();
  }

  // epilogue: the output, and this thread's part of the two channel sums
  // of channels j0 + 32 h + 4 cg .. + 3, one half h at a time, into red
  // (the A stages are free after the loop's last barrier)
  float* red = sm.a[0];  // [2][GROUPS][CT]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + 32 * h + 4 * cg;
    float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0;
    if (MODE == MODE_FWD) {
      p0 = load4(bias, j, c, false);
    } else {
      p0 = load4(scale, j, c, false);
      p1 = load4(shift, j, c, false);
    }
    float sum0[4] = {0.f, 0.f, 0.f, 0.f}, sum1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const int cell_row = sm.cell_row[slot * AF + HALO + fg * FT + f];
      if (cell_row < 0) continue;
      const size_t row = size_t(cell_row) * c;
      float4 o;
      if (MODE == MODE_FWD) {
        o = make_float4(acc[f][4 * h] + p0.x, acc[f][4 * h + 1] + p0.y,
                        acc[f][4 * h + 2] + p0.z, acc[f][4 * h + 3] + p0.w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j + i >= c) continue;
          const float u = at(o, i);
          sum0[i] += u;
          sum1[i] += u * u;
        }
      } else {
        const float4 sv = load4(s_in + row, j, c, aligned);
        float g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ghm = affine(at(sv, i), at(p0, i), at(p1, i)) > 0.f
                                ? acc[f][4 * h + i]
                                : 0.f;
          g[i] = ghm * at(p0, i);
          if (j + i < c) {
            sum0[i] += ghm * at(sv, i);
            sum1[i] += ghm;
          }
        }
        o = make_float4(g[0], g[1], g[2], g[3]);
      }
      store4(out + row, j, c, o, aligned);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[group * CT + 32 * h + 4 * cg + i] = sum0[i];
      red[(GROUPS + group) * CT + 32 * h + 4 * cg + i] = sum1[i];
    }
  }
  // the sums of the block's (sequence, frame group) threads of a channel,
  // in a fixed order
  __syncthreads();
  if (tid < 2 * CT) {
    const int which = tid / CT, jl = tid % CT;
    if (j0 + jl < c) {
      float total = 0.f;
      for (int gi = 0; gi < GROUPS; ++gi)
        total += red[(which * GROUPS + gi) * CT + jl];
      partials[(size_t(blockIdx.x) * 2 + which) * c + j0 + jl] = total;
    }
  }
}

// Blocks of tile_kernel for nm clips of t_len frames: grid.x (also the
// number of partials), grid.y.
inline dim3 tile_grid(int nm, int t_len, int c) {
  return dim3((nm * V + SLOTS - 1) / SLOTS * ((t_len + TF - 1) / TF),
              (c + CT - 1) / CT);
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
      in, s_in, w, scale, shift, bias, out, partials, nm, t_len, c);
  return cudaGetLastError();
}

}  // namespace tconv
