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
//   2. tconv::wgrad_kernel: dW[co, ci, dt] is a product of depth rows, and
//      the conv is 1-D in time, so each thread walks frames in order and
//      keeps h's last 9 frames in registers. One block of 128 threads per
//      (split, WG_CO = 32 output channels, WG_CI = 32 input channels),
//      three blocks an SM at up to 168 registers a thread (on an H100 two
//      blocks of 256 threads an SM spilled at 128 registers and ran 3%
//      slower than one, and three of 128 ran 5% faster than one of 256);
//      thread (q, p) keeps dW for output channels 4q .. 4q + 3, input
//      channels 2p, 2p + 1 and all 9 taps (72 f32). A split is a run of
//      (clip, joint) sequences, clip-major, walked as one stream of
//      positions: 4 zero frames, then the sequence's T frames, for each
//      sequence in turn. At position u a thread reads one float4 of gue
//      and one float2 of h (the frame 4 positions ahead, into a ring of 9
//      frames; the position loop is unrolled by 9, so the ring's indices
//      are static) and does 72 FFMAs; the zero frames make every tap of a
//      frame meet its own sequence or zeros (the SAME padding) with no
//      branch. Chunks of FC = 36 positions of gue and of s are staged by
//      cp.async in a two-stage ring, and each thread applies the affine
//      and ReLU to its own copies of s in place once they arrive, on the
//      clips' rows only; a table of each position's row is built a chunk
//      ahead (no divides in the staging). The blocks of the first
//      input-channel tile also sum each staged chunk of gue for dbias,
//      once its products are done. Each block writes its split's partial
//      of dW (and of dbias) to a workspace.
// In bf16 their tensor-core versions in tconv_mma.cuh take their place.
// What bounds them on the H100: each is a GEMM of 9 * C * C multiply-adds a
// row, 2 * 9 * C * C * rows FLOP together, on the CUDA cores (67 TFLOP/s
// f32) or the bf16 tensor cores, as in the forward; the bytes (s, gue, g_s
// once each, and a workspace of splits * 9 * C * C f32, ~20 MB in f32, ~40
// MB in bf16) are minor. Every sum is taken in an order fixed by the shapes
// alone, so two launches on the same inputs give bit-identical outputs.

#include "channel_sums.cuh"
#include "tconv_mma.cuh"
#include "tconv_tile.cuh"

namespace tconv {

constexpr int WG_CO = 32;       // dW: output channels per block
constexpr int WG_CI = 32;       // dW: input channels per block
constexpr int WG_MIN_BLOCKS = 3;  // dW: blocks an SM
constexpr int WG_THREADS = (WG_CO / 4) * (WG_CI / 2);
constexpr int FC = 36;          // dW: stream positions per chunk
constexpr int GAP = HALO;       // zero frames before each sequence
constexpr int G_ITEMS = FC * WG_CO / 4;  // float4s of gue a chunk
constexpr int H_ITEMS = FC * WG_CI / 4;  // float4s of h a chunk
constexpr int G_PER_THREAD = (G_ITEMS + WG_THREADS - 1) / WG_THREADS;
constexpr int H_PER_THREAD = (H_ITEMS + WG_THREADS - 1) / WG_THREADS;
static_assert(FC % KS == 0, "chunks keep the ring's phase");
static_assert(WG_THREADS % (WG_CI / 4) == 0,
              "a thread stages h of fixed channels");

struct WgradSmem {
  float g[2][FC * WG_CO];  // gue [position][co]
  float h[2][FC * WG_CI];  // h of the position 4 ahead [position][ci]
  int rows[2][2][FC];      // [stage][gue, h][position]: row, or -1 (zeros)
};

// ws: [split][9 * c * c + c]: dW in (c, c, 9) order, then dbias. A split
// is the sequences [S split / splits, S (split + 1) / splits) of the S =
// nm * 25 (clip, joint) sequences, sequence n * 25 + v.
__global__ void __launch_bounds__(WG_THREADS, WG_MIN_BLOCKS)
    wgrad_kernel(const float* __restrict__ s, const float* __restrict__ gue,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ ws,
                 int nm, int t_len, int c) {
  extern __shared__ float4 smem4[];
  WgradSmem& sm = *reinterpret_cast<WgradSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // a warp holds 8 quads of output channels x 4 pairs of input channels
  const int q = lane % 8 + 8 * (warp % (WG_CO / 32));
  const int p = lane / 8 + 4 * (warp / (WG_CO / 32));
  const int split = blockIdx.x, splits = gridDim.x;
  const int o0 = blockIdx.y * WG_CO, i0 = blockIdx.z * WG_CI;
  const long long seqs = static_cast<long long>(nm) * V;
  const int seq_begin = int(seqs * split / splits);
  const int seq_end = int(seqs * (split + 1) / splits);
  const int period = t_len + GAP;
  const int chunks = ((seq_end - seq_begin) * period + FC - 1) / FC;
  const bool aligned = c % 4 == 0 && aligned16(s) && aligned16(gue);
  // dbias, in the blocks of the first input-channel tile: thread tid sums
  // column tid % 64 of each staged chunk of gue over the positions p with
  // p % 4 == tid / 64, once the chunk's products are done
  const bool bias_block = blockIdx.z == 0;
  float bsum = 0.f;

  // the rows of chunk x's positions (gue) and of those 4 ahead (h)
  auto build_rows = [&](int x) {
    if (tid >= 2 * FC) return;
    const int which = tid / FC, pos = tid % FC;
    const int u = x * FC + pos + which * HALO;
    const int seq = u / period, f = u % period - GAP;
    const int j = seq_begin + seq;
    sm.rows[x & 1][which][pos] =
        f >= 0 && j < seq_end ? (j / V * t_len + f) * V + j % V : -1;
  };
  // gue of chunk x into stage x & 1, by cp.async where rows are aligned
  auto stage_g = [&](int x) {
    const int* rows = sm.rows[x & 1][0];
    float* dst = sm.g[x & 1];
#pragma unroll
    for (int r = 0; r < G_PER_THREAD; ++r) {
      const int e = tid + r * WG_THREADS;
      if (e >= G_ITEMS) break;
      const int pos = e / (WG_CO / 4), col = 4 * (e % (WG_CO / 4));
      const int row = rows[pos], o = o0 + col;
      if (aligned) {
        const bool ok = row >= 0 && o < c;
        mma_bf16::cp_async16(dst + pos * WG_CO + col,
                             ok ? gue + size_t(row) * c + o : gue, ok);
      } else {
        const float4 g4 = row >= 0 ? load4(gue + size_t(row) * c, o, c, false)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dst + pos * WG_CO + col) = g4;
      }
    }
  };
  // s of chunk x's h rows into stage x & 1: by cp.async where rows are
  // aligned, h = relu(s * scale + shift) applied in place once they have
  // arrived (affine_h), else by 4-byte loads with h computed at once;
  // zeros off the clips and past c
  const int hcol = 4 * (tid % (WG_CI / 4));
  auto stage_h = [&](int x) {
    const int* rows = sm.rows[x & 1][1];
    float* dst = sm.h[x & 1];
#pragma unroll
    for (int r = 0; r < H_PER_THREAD; ++r) {
      const int e = tid + r * WG_THREADS;
      if (e >= H_ITEMS) break;
      const int pos = e / (WG_CI / 4), row = rows[pos], k = i0 + hcol;
      if (aligned) {
        const bool ok = row >= 0 && k < c;
        mma_bf16::cp_async16(dst + pos * WG_CI + hcol,
                             ok ? s + size_t(row) * c + k : s, ok);
      } else {
        float hv[4] = {0.f, 0.f, 0.f, 0.f};
        if (row >= 0) {
          const float4 sv = load4(s + size_t(row) * c, k, c, false);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k + i < c)
              hv[i] = fmaxf(affine(at(sv, i), scale[k + i], shift[k + i]),
                            0.f);
        }
        *reinterpret_cast<float4*>(dst + pos * WG_CI + hcol) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
    }
  };
  auto affine_h = [&](int x) {
    const int k = i0 + hcol;
    if (!aligned || k >= c) return;
    const float4 sc = load4(scale, k, c, false);
    const float4 sh = load4(shift, k, c, false);
    const int* rows = sm.rows[x & 1][1];
#pragma unroll
    for (int r = 0; r < H_PER_THREAD; ++r) {
      const int e = tid + r * WG_THREADS;
      if (e >= H_ITEMS) break;
      const int pos = e / (WG_CI / 4);
      if (rows[pos] < 0) continue;
      float4* p4 = reinterpret_cast<float4*>(sm.h[x & 1] + pos * WG_CI + hcol);
      const float4 sv = *p4;
      *p4 = make_float4(fmaxf(affine(sv.x, sc.x, sh.x), 0.f),
                        fmaxf(affine(sv.y, sc.y, sh.y), 0.f),
                        fmaxf(affine(sv.z, sc.z, sh.z), 0.f),
                        fmaxf(affine(sv.w, sc.w, sh.w), 0.f));
    }
  };

  float acc[KS][4][2];
  float2 ring[KS];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt) {
    ring[dt] = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j][0] = acc[dt][j][1] = 0.f;
  }

  build_rows(0);
  build_rows(1);
  __syncthreads();
  if (chunks > 0) {
    stage_g(0);
    stage_h(0);
    mma_bf16::cp_async_commit();
    mma_bf16::cp_async_wait_all();
    affine_h(0);
  }
  __syncthreads();
  for (int x = 0; x < chunks; ++x) {
    const bool more = x + 1 < chunks;
    if (more) {
      stage_g(x + 1);
      stage_h(x + 1);
      mma_bf16::cp_async_commit();
    }
    const float* gb = sm.g[x & 1] + 4 * q;
    const float* hb = sm.h[x & 1] + 2 * p;
#pragma unroll 1
    for (int m = 0; m < FC; m += KS) {
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        // position u = x FC + m + i, u % 9 == i: h of u + 4 enters slot
        // (i + 4) % 9, and tap dt reads h of u + dt - 4 from slot
        // (i + dt + 5) % 9
        const float4 g4 =
            *reinterpret_cast<const float4*>(gb + (m + i) * WG_CO);
        ring[(i + HALO) % KS] =
            *reinterpret_cast<const float2*>(hb + (m + i) * WG_CI);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          const float2 h2 = ring[(i + dt + KS - HALO) % KS];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[dt][j][0] = fmaf(gv[j], h2.x, acc[dt][j][0]);
            acc[dt][j][1] = fmaf(gv[j], h2.y, acc[dt][j][1]);
          }
        }
      }
    }
    if (bias_block) {
      const float* col = sm.g[x & 1] + tid % WG_CO;
      for (int pos = tid / WG_CO; pos < FC; pos += WG_THREADS / WG_CO)
        bsum += col[pos * WG_CO];
    }
    if (more) {
      mma_bf16::cp_async_wait_all();
      affine_h(x + 1);
    }
    // stage x & 1's rows were last read when chunk x was staged
    if (x + 2 < chunks) build_rows(x + 2);
    __syncthreads();
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
  }
  if (bias_block) {  // the quarters' sums of each column, in order
    float* red = sm.g[0];  // free after the loop's last barrier
    red[tid] = bsum;
    __syncthreads();
    if (tid < WG_CO && o0 + tid < c) {
      float total = 0.f;
      for (int r = 0; r < WG_THREADS / WG_CO; ++r)
        total += red[r * WG_CO + tid];
      pw[n_w + o0 + tid] = total;
    }
  }
}

inline cudaError_t launch_wgrad(const float* s, const float* gue,
                                const float* scale, const float* shift,
                                float* ws, int nm, int t_len, int c,
                                int splits, cudaStream_t stream) {
  const int smem = int(sizeof(WgradSmem));
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (c + WG_CO - 1) / WG_CO, (c + WG_CI - 1) / WG_CI);
  wgrad_kernel<<<grid, WG_THREADS, smem, stream>>>(s, gue, scale, shift, ws,
                                                   nm, t_len, c);
  return cudaGetLastError();
}

}  // namespace tconv

namespace {

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
                                  tconv::KS * c * c + c,
                                  static_cast<float*>(dwb),
                                  stream));
}

}  // namespace

// s: (nm, t_len, 25, c) in T; gue: like s; w: the input gradient's weight
// operand, the taps reversed and transposed: the f32 route's (c, 9, c) f32
// w[co][dt][ci] = W[co, ci, 8 - dt], the bf16 route's (9, c, c) bf16
// w[dt][ci][co] = W[co, ci, 8 - dt]; scale, shift: (c,) f32. Out: gs like
// s; sums (2 * c,) f32: dscale then dshift; dwb (9 * c * c + c,) f32: dW in
// (c, c, 9) order, then dbias. Workspaces:
// ws_tile 2 * c f32 for each tile (as tconv_fwd.cu's ws), ws_w splits *
// (9 * c * c + c) f32. All contiguous, nm * t_len >= 1; splits of the
// (clip, joint) sequences in f32 (1 <= splits <= 25 nm), of the clips in
// bf16 (1 <= splits <= nm). Returns the first cudaError_t (0 on success).
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
  if (err == cudaSuccess)
    err = tconv::launch_wgrad(sf, gf, sc, sh, static_cast<float*>(ws_w), nm,
                              t_len, c, splits, st);
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
      gb, sb, static_cast<const __nv_bfloat16*>(w), sc, sh, nullptr,
      static_cast<__nv_bfloat16*>(gs), static_cast<float*>(ws_tile), nm,
      t_len, c, st);
  if (err == cudaSuccess)
    err = tconv_mma::launch_wgrad(sb, gb, sc, sh, static_cast<float*>(ws_w),
                                  nm, t_len, c, splits, st);
  return sum_partials(err, ws_tile, tconv_mma::tile_parts(nm, t_len), ws_w,
                      splits, c, sums, dwb, st);
}

// The dynamic shared memory of a block of the bf16 tile and dW kernels, in
// bytes (chip_smoke.py reports them beside the registers).
extern "C" void tconv_mma_smem_bytes(int* tile, int* wgrad) {
  *tile = int(sizeof(tconv_mma::TileSmem));
  *wgrad = int(sizeof(tconv_mma::WgradSmem));
}

// The same of the f32 tile and dW kernels (tconv_tile.cuh, above).
extern "C" void tconv_f32_smem_bytes(int* tile, int* wgrad) {
  *tile = int(sizeof(tconv::TileSmem));
  *wgrad = int(sizeof(tconv::WgradSmem));
}
