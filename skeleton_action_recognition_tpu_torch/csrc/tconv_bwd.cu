// Fused temporal chain of an ST-GCN block, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/
// tconv.py::_bwd_kernel (the VJP of affine_relu_tconv). For the forward
// u = conv9x1(h) + bias, h = relu(s * scale + shift) (SAME, stride 1), and
// gue, the cotangent of u with the statistics' cotangents folded in by the
// caller (g_u + g_sum + 2 u g_sumsq, in the matmul type):
//
//     gh[t, ci]    = sum_dt sum_co gue[t - dt + 4, co] * W[co, ci, dt]
//     ghm          = gh where s * scale + shift > 0 (f32), else 0
//     g_s          = ghm * scale                    (in s's dtype)
//     dscale[ci]   = sum ghm * s,   dshift[ci] = sum ghm
//     dW[co, ci, dt] = sum_t h[t + dt - 4, ci] * gue[t, co]
//     dbias[co]    = sum gue
//
// with every sum over all (clip, frame, joint) rows in f32, h recomputed from
// s (with the same edge mask: zero outside [0, T) after the affine and the
// ReLU) and rounded to the matmul type for dW, as the TPU kernel does.
//
// Two kernels and the fixed-order reduce of channel_sums.cuh. In f32, on the
// CUDA cores:
//   1. tconv::tile_kernel<MODE_DGRAD> (tconv_tile.cuh): gh is the forward's
//      implicit GEMM with the taps reversed and transposed, over gue; its
//      epilogue applies the ReLU mask and writes g_s and per-block partials
//      of dscale and dshift.
//   2. wgrad_kernel: one block per (split of the frames, CO_T output
//      channels, CI_T input channels); thread (q, p) keeps dW for 4 output
//      and 2 input channels and all 9 taps (72 f32) in registers, and loops
//      over its split's frames in chunks of FC: the chunk of gue and the
//      chunk of h with a 4-frame halo on each side are staged in shared
//      memory, and a tap that would cross a clip's edge is skipped. Each
//      block writes its split's partial of dW (and, from the blocks of the
//      first input-channel tile, of dbias) to a workspace.
// In bf16 their tensor-core versions in tconv_mma.cuh take their place.
// What bounds them on the H100: each is a GEMM of 9 * C * C multiply-adds a
// row, 2 * 9 * C * C * rows FLOP together, on the CUDA cores (67 TFLOP/s
// f32) or the bf16 tensor cores, as in the forward; the bytes (s, gue, g_s
// once each, and a workspace of splits * 9 * C * C f32, ~40 MB) are minor. Every
// sum is taken in an order fixed by the shapes alone, so two launches on the
// same inputs give bit-identical outputs.

#include "channel_sums.cuh"
#include "tconv_mma.cuh"
#include "tconv_tile.cuh"

namespace {

using tconv::HALO;
using tconv::KS;
using tconv::V;

constexpr int FC = 8;                          // dW: frames per chunk
constexpr int G_ROWS = FC * V;
constexpr int H_ROWS = (FC + 2 * HALO) * V;
constexpr int CO_T = 64;                       // dW: output channels per block
constexpr int CI_T = 32;                       // dW: input channels per block
constexpr int WG_THREADS = (CO_T / 4) * (CI_T / 2);

struct WgradSmem {
  float g[G_ROWS * CO_T];   // [row][co]
  float h[H_ROWS * CI_T];   // [halo'd row][ci]
};

// ws: [split][9 * c * c + c]: dW in (c, c, 9) order, then dbias.
__global__ void __launch_bounds__(WG_THREADS)
    wgrad_kernel(const float* __restrict__ s, const float* __restrict__ gue,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ ws,
                 int frames, int t_len, int c) {
  extern __shared__ float4 smem4[];
  WgradSmem& sm = *reinterpret_cast<WgradSmem*>(smem4);
  const int tid = threadIdx.x;
  const int q = tid % (CO_T / 4), p = tid / (CO_T / 4);
  const int split = blockIdx.x, splits = gridDim.x;
  const int o0 = blockIdx.y * CO_T, i0 = blockIdx.z * CI_T;
  const int f_begin = int(static_cast<long long>(frames) * split / splits);
  const int f_end = int(static_cast<long long>(frames) * (split + 1) / splits);

  float acc[KS][4][2];
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j][0] = acc[dt][j][1] = 0.f;

  for (int fc = f_begin; fc < f_end; fc += FC) {
    const int n_rows = min(FC, f_end - fc) * V;
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < G_ROWS * CO_T; i += WG_THREADS) {
      const int row = i / CO_T, o = o0 + i % CO_T;
      sm.g[i] = (row < n_rows && o < c) ? gue[(size_t(fc) * V + row) * c + o]
                                        : 0.f;
    }
    // frames fc - 4 .. fc + FC + 3, counted across clips
    for (int i = tid; i < H_ROWS * CI_T; i += WG_THREADS) {
      const int row = i / CI_T, k = i0 + i % CI_T;
      const int fr = fc - HALO + row / V;
      float val = 0.f;
      if (fr >= 0 && fr < frames && k < c) {
        const float raw = s[(size_t(fr) * V + row % V) * c + k];
        val = fmaxf(tconv::affine(raw, scale[k], shift[k]), 0.f);
      }
      sm.h[i] = val;
    }
    __syncthreads();
    for (int row = 0; row < n_rows; ++row) {
      const int t = (fc + row / V) % t_len;
      const float4 g4 =
          *reinterpret_cast<const float4*>(&sm.g[row * CO_T + 4 * q]);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) bacc[j] += gv[j];
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        // tap dt reads frame t + dt - 4 of the same clip: zero outside it
        if (t + dt - HALO < 0 || t + dt - HALO >= t_len) continue;
        const float2 h2 = *reinterpret_cast<const float2*>(
            &sm.h[(row + dt * V) * CI_T + 2 * p]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[dt][j][0] += gv[j] * h2.x;
          acc[dt][j][1] += gv[j] * h2.y;
        }
      }
    }
  }

  const size_t n_w = size_t(KS) * c * c;
  float* pw = ws + size_t(split) * (n_w + c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + 4 * q + j;
    if (o >= c) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = i0 + 2 * p + i;
      if (ci >= c) continue;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt)
        pw[(size_t(o) * c + ci) * KS + dt] = acc[dt][j][i];
    }
    if (blockIdx.z == 0 && p == 0) pw[n_w + o] = bacc[j];
  }
}

// After the tile and dW kernels' launches (err): the channel sums of the
// tile kernel's parts partials, and dW and dbias from the splits' partials.
int sum_partials(cudaError_t err, void* ws_tile, int parts, void* ws_w,
                 int splits, int c, void* sums, void* dwb,
                 cudaStream_t stream) {
  if (err != cudaSuccess) return int(err);
  err = channel_sums::launch(static_cast<const float*>(ws_tile), parts,
                             2 * c, static_cast<float*>(sums), stream);
  if (err != cudaSuccess) return int(err);
  return int(channel_sums::launch(static_cast<const float*>(ws_w), splits,
                                  KS * c * c + c, static_cast<float*>(dwb),
                                  stream));
}

}  // namespace

// s: (nm, t_len, 25, c) in T; gue: like s; w: (c, c, 9, 1) f32; scale,
// shift: (c,) f32. Out: gs like s; sums (2 * c,) f32: dscale then dshift;
// dwb (9 * c * c + c,) f32: dW in (c, c, 9) order, then dbias. Workspaces:
// ws_tile 2 * c f32 for each tile (as tconv_fwd.cu's ws), ws_w splits *
// (9 * c * c + c) f32. All contiguous, nm * t_len >= 1; splits of the
// frames in f32 (1 <= splits <= nm * t_len), of the clips in bf16 (1 <=
// splits <= nm). Returns the first cudaError_t (0 on success).
extern "C" int tconv_bwd_f32(const void* s, const void* gue, const void* w,
                             const void* scale, const void* shift, void* gs,
                             void* ws_tile, void* ws_w, void* sums, void* dwb,
                             int nm, int t_len, int c, int splits,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const float* gf = static_cast<const float*>(gue);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaError_t err = tconv::launch_tile<tconv::MODE_DGRAD>(
      gf, sf, static_cast<const float*>(w), sc, sh, nullptr,
      static_cast<float*>(gs), static_cast<float*>(ws_tile), nm, t_len, c,
      st);
  const int smem = int(sizeof(WgradSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    const dim3 grid(splits, (c + CO_T - 1) / CO_T, (c + CI_T - 1) / CI_T);
    wgrad_kernel<<<grid, WG_THREADS, smem, st>>>(
        sf, gf, sc, sh, static_cast<float*>(ws_w), nm * t_len, t_len, c);
    err = cudaGetLastError();
  }
  return sum_partials(err, ws_tile, tconv::tile_grid(nm, t_len, c).x, ws_w,
                      splits, c, sums, dwb, st);
}

extern "C" int tconv_bwd_bf16(const void* s, const void* gue, const void* w,
                              const void* scale, const void* shift, void* gs,
                              void* ws_tile, void* ws_w, void* sums,
                              void* dwb, int nm, int t_len, int c, int splits,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* gb = static_cast<const __nv_bfloat16*>(gue);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaError_t err = tconv_mma::launch_tile<tconv::MODE_DGRAD>(
      gb, sb, static_cast<const float*>(w), sc, sh, nullptr,
      static_cast<__nv_bfloat16*>(gs), static_cast<float*>(ws_tile), nm,
      t_len, c, st);
  if (err == cudaSuccess)
    err = tconv_mma::launch_wgrad(sb, gb, sc, sh, static_cast<float*>(ws_w),
                                  nm, t_len, c, splits, st);
  return sum_partials(err, ws_tile, tconv_mma::tile_grid(nm, t_len, c).x,
                      ws_w, splits, c, sums, dwb, st);
}
