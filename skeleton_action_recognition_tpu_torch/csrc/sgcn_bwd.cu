// Fused ST-GCN spatial graph conv, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/sgcn.py::
// _bwd_kernel (the VJP of make_fused_graph_conv). For the forward
// out[f, w, o] = sum_k sum_v A[k, v, w] * z[f, k, v, o],
// z[f, k, v, o] = sum_i x[f, v, i] * W[k * C_out + o, i] + b[k * C_out + o],
// and the output cotangent g (F, V, C_out):
//
//     dz[f, k, v, o]      = sum_w A[k, v, w] * g[f, w, o]
//     dx[f, v, i]         = sum_k sum_o dz[f, k, v, o] * W[k * C_out + o, i]
//     dW[k * C_out + o, i] = sum_f sum_v dz[f, k, v, o] * x[f, v, i]
//     db[k * C_out + o]    = sum_f sum_v dz[f, k, v, o]
//
// W is nn.Linear's (K * C_out, C_in) weight, partition-major rows.
//
// What bounds it on the H100: dz is three times the size of g. The unfused
// backward writes dz to device memory and reads it twice (for dx and for
// dW). At the widest block (C_in = C_out = 256) a frame costs 2 x 9.8 MFLOP
// (dx and dW): in f32, on the CUDA cores, ~67 TFLOP/s bound it; in bf16 the
// products run on the tensor cores and the bytes of g, x and dx bound it.
// These kernels never store dz: each block recomputes the dz it needs from g
// in shared memory (dz costs ~73 FMAs per frame and channel against
// 3 * 25 * C_in for dx), so g and x are read and dx written once each, plus
// a small workspace.
//
// dW and db are sums over all F * V rows (1.9 M at B = 128). Blocks run in no
// order, so there are no cross-block accumulators and no float atomics:
// 1. a dx kernel, 2. a dW kernel whose blocks each take a fixed split of the
// frames and write their partial of dW and db to a workspace, 3.
// channel_sums.cuh's fixed-order reduce of the splits' partials. Every sum
// is taken in an order fixed by the shapes alone, so two launches on the
// same inputs give bit-identical dx, dW and db.
//
// f32 (sgcn_f32::dx_kernel and dw_kernel in sgcn_tile_f32.cuh, on the CUDA
// cores, never TF32): register-blocked tiles, an 8 x 8 block of
// accumulators a thread. dx: 5 frames x 64 input channels, depth
// (k, o) in chunks of 16 output channels; dW: 192 (k, o) x 64 input
// channels, depth a split's rows in chunks of 2 frames. Each stages its
// chunks of g and W or x by cp.async two deep and computes the chunk's dz
// once, from the staged g, into the layout its product reads (see the
// header's notes).
//
// bf16: every product on the tensor cores through mma_bf16.cuh's
// mma.sync.m16n8k16 with f32 sums (the TPU kernel's jnp.dot with f32
// accumulation). Both kernels walk whole frames, 5 at a time: 125 rows
// (f, v), padded to the 128 of eight 16-row MMA tiles, and compute the dz
// they need from the chunk of g staged in shared memory, also on the
// tensor cores (dz_products: per frame the dense (k, v) x w adjacency in
// bf16, staged once per block, times g's 25 rows; the 1,875 dense entries
// cost less there than a loop over the 73 nonzeros costs on the CUDA
// cores, and the products are exact and the sums f32 in both), rounded to
// bf16 into shared memory as [row][(k, o)].
//   mma_dx_kernel: dx = dz W, a (rows) x (3 C_out) by (3 C_out) x C_in
//   product. Tiles of (5 frames, 128 input channels), C_out walked in
//   chunks of 32: dz is the A operand as it lies; W's chunk (cast to bf16
//   once per call by the wrapper) is the B operand as it lies, [(k, o)][i],
//   read by ldmatrix.trans. The 8 warps hold 32 x 64 of the tile in f32
//   registers; the next chunk's g and W load by cp.async while this one
//   multiplies. Persistent: two blocks on each SM walk the tiles, so the
//   adjacency is staged once per block and the next tile's first chunk
//   loads while this tile finishes.
//   mma_dw_kernel: dW = dz^T x, a product of depth rows. One block per
//   (split of the frames, 32 output channels, 128 input channels): its
//   split's frames in chunks of 5, dz read as the transposed A operand
//   (ldmatrix.trans of [row][(k, o)]), x staged as it lies ([row][i], the
//   B operand by ldmatrix.trans); db is summed from the rounded dz by the
//   blocks of the first input channels, a frame of rows per thread group,
//   the five groups met in a fixed order. The 8 warps hold 48 x 32 of the
//   96 x 128 tile. The splits make one wave of two blocks an SM.
//   The padding rows and the frames past the input's end are zero, so they
//   add nothing to dW and db, and their dx is never stored. A row of 3
//   input channels (6 bytes, not 16-byte aligned) is staged element by
//   element and zero-padded to 16.
//
// Rounding follows the TPU kernel: g arrives in x's dtype, A and W are
// rounded to it, dz is rounded to it after its f32 sum, dx is summed in f32
// and stored in x's dtype, dW and db are summed and stored in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "channel_sums.cuh"
#include "mma_bf16.cuh"
#include "sgcn_tile_f32.cuh"

namespace {

using mma_bf16::bf16;
using mma_bf16::bf162;

constexpr int V = 25;  // NTU RGB+D joints
constexpr int K = 3;   // spatial partitions
constexpr int KV = K * V;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// f32, on the CUDA cores.

template <bool NARROW>
int launch_f32(const float* x, const float* g, const float* w,
               const float* a, float* dx, float* ws_w, float* ws_b,
               int frames, int c_in, int c_out, int splits,
               cudaStream_t stream) {
  namespace f = sgcn_f32;
  const int dx_smem = int(sizeof(f::DxSmem));
  cudaError_t err = allow_smem(f::dx_kernel<NARROW>, dx_smem);
  if (err != cudaSuccess) return int(err);
  f::dx_kernel<NARROW><<<f::dx_blocks(frames, c_in), f::DX_THREADS, dx_smem,
                         stream>>>(g, w, a, dx, frames, c_in, c_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int dw_smem = int(sizeof(f::DwSmem));
  err = allow_smem(f::dw_kernel<NARROW>, dw_smem);
  if (err != cudaSuccess) return int(err);
  f::dw_kernel<NARROW><<<f::dw_grid(splits, c_in, c_out), f::DW_THREADS,
                         dw_smem, stream>>>(x, g, a, ws_w, ws_b, frames, c_in,
                                            c_out);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, on the tensor cores.

namespace mma_bwd {

constexpr int MF = 5;            // frames per tile or chunk
constexpr int MROWS = MF * V;    // its 125 rows (f, v)
constexpr int MT = 128;          // rows, padded to 16-row MMA tiles
constexpr int OCH = 32;          // output channels of a dz tile
constexpr int KO = K * OCH;      // its 96 columns (k, o)
constexpr int LDZ = KO + 8;      // staged dz row, in bf16
constexpr int NI = 128;          // input channels per block
constexpr int LDI = NI + 8;      // staged W or x row, in bf16
constexpr int GROWS = MROWS + 7; // g rows: the last frame's 25 padded to 32
constexpr int LDG = OCH + 8;     // staged g row, in bf16
constexpr int KVP = 80;          // (k, v) rows of A, padded
constexpr int WP = 32;           // joints w, padded
constexpr int LDA = WP + 8;      // A row, in bf16
constexpr int THREADS = 256;     // 8 warps
constexpr int DZ_UNITS = MF * (KVP / 16);  // dz GEMM: (frame, 16 rows)

// A [(k, v)][w] in bf16, zero-padded to KVP x WP; once per block.
__device__ __forceinline__ void stage_adjacency(const float* __restrict__ a,
                                                bf16* __restrict__ as,
                                                int tid) {
  for (int i = tid; i < KVP * LDA; i += THREADS) {
    const int kv = i / LDA, wv = i % LDA;
    as[i] = __float2bfloat16(kv < KV && wv < V ? a[kv * V + wv] : 0.f);
  }
}

// dz[(f * V + v)][k * OCH + o] = sum_w A[k, v, w] g[f * V + w][o] for the
// tile's five frames, on the tensor cores: per frame a (80 x 32) by
// (32 x 32) product, the joints w past 25 meeting zero columns of A (and
// the rows after them in g, which are data or staged zeros). Products of
// bf16 are exact and summed in f32; dz is rounded to bf16. Rows past n_rows
// come out zero from their zero g rows; the tile's padding rows 125..127
// are never written (the caller zeroes them once).
__device__ __forceinline__ void dz_products(const bf16* __restrict__ as,
                                            const bf16* __restrict__ g,
                                            bf16* __restrict__ dz, int warp,
                                            int lane) {
  using namespace mma_bf16;
  const int gq = lane / 4, q = lane % 4;
  for (int u = warp; u < DZ_UNITS; u += THREADS / 32) {
    const int f = u / (KVP / 16), m0 = u % (KVP / 16) * 16;
    float acc[4][4] = {};
    const bf16* gf = g + f * V * LDG;
#pragma unroll
    for (int kk = 0; kk < WP; kk += 16) {
      unsigned af[4];
      ldsm_x4(af, a_rows_at(as, LDA, m0, kk, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bq[4];
        ldsm_x4_trans(bq, b_cols_at(gf, LDG, np * 16, kk, lane));
        mma(acc[2 * np], af, bq[0], bq[1]);
        mma(acc[2 * np + 1], af, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kv = m0 + gq + 8 * half;
      if (kv >= KV) continue;
      bf16* row = dz + (f * V + kv % V) * LDZ + kv / V * OCH + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<bf162*>(row + nt * 8) = __floats2bfloat162_rn(
            acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

struct DxSmem {
  bf16 w[2][KO * LDI];  // W chunk [k * OCH + o][i], two stages
  bf16 dz[MT * LDZ];    // [row][k * OCH + o]; rows 125..127 zero
  bf16 g[GROWS * LDG];  // [row][o]
  bf16 a[KVP * LDA];    // A [(k, v)][w]
};

struct DwSmem {
  bf16 x[2][MT * LDI];   // x chunk [row][i], two stages
  bf16 dz[MT * LDZ];     // [row][k * OCH + o]; rows 125..127 zero
  bf16 g[GROWS * LDG];   // [row][o]
  bf16 a[KVP * LDA];     // A [(k, v)][w]
  float red[MF][KO];     // db: the five row groups' sums
};

// Persistent: block b takes tiles b, b + grid, ...; tile t is frame tile
// t / i_tiles and input channel tile t % i_tiles, so that neighbouring
// blocks share g in L2. w is the bf16 weight.
__global__ void __launch_bounds__(THREADS, 2)
    mma_dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                  const float* __restrict__ a, bf16* __restrict__ dx,
                  int frames, int c_in, int c_out) {
  using namespace mma_bf16;
  extern __shared__ float4 smem4[];
  DxSmem& s = *reinterpret_cast<DxSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // 32 rows x 64 input channels
  const int i_tiles = (c_in + NI - 1) / NI;
  const int tiles = (frames + MF - 1) / MF * i_tiles;
  const int chunks = (c_out + OCH - 1) / OCH;
  const int my_tiles = (tiles - int(blockIdx.x) + int(gridDim.x) - 1) /
                       int(gridDim.x);
  const int steps = my_tiles * chunks;  // (tile, chunk) pairs of this block
  const bool g_aligned = rows_aligned(g, c_out);
  const bool w_aligned = rows_aligned(w, c_in);

  stage_adjacency(a, s.a, tid);
  for (int i = tid; i < (MT - MROWS) * LDZ; i += THREADS)
    s.dz[MROWS * LDZ + i] = __float2bfloat16(0.f);

  auto tile_of = [&](int step) {
    return int(blockIdx.x) + step / chunks * int(gridDim.x);
  };
  auto stage = [&](int step) {  // g into its one buffer, W into step & 1
    const int t = tile_of(step);
    const int f0 = t / i_tiles * MF, i0 = t % i_tiles * NI;
    const int oc = step % chunks * OCH, n_o = min(OCH, c_out - oc);
    stage_tile<GROWS, OCH, THREADS, true>(
        s.g, LDG, g + size_t(f0) * V * c_out, c_out,
        min(MF, frames - f0) * V, oc, c_out, g_aligned, tid);
    for (int k = 0; k < K; ++k)
      stage_tile<OCH, NI, THREADS>(s.w[step & 1] + k * OCH * LDI, LDI,
                                   w + size_t(k * c_out + oc) * c_in, c_in,
                                   n_o, i0, c_in, w_aligned, tid);
    cp_async_commit();
  };

  float acc[2][8][4];
  if (steps > 0) stage(0);
  for (int step = 0; step < steps; ++step) {
    const int t = tile_of(step), c = step % chunks;
    const int f0 = t / i_tiles * MF, i0 = t % i_tiles * NI;
    const int n_rows = min(MF, frames - f0) * V;
    // the warp's input channels that the products need (up to a multiple
    // of 16 past c_in)
    const bool active = wn * 64 < (min(NI, c_in - i0) + 15) / 16 * 16;
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    cp_async_wait_all();
    __syncthreads();  // chunk c's g and W are in place
    dz_products(s.a, s.g, s.dz, warp, lane);
    __syncthreads();  // dz is complete; g is free
    if (step + 1 < steps) stage(step + 1);  // loads while this multiplies
    if (active) {
      const bf16* ws = s.w[step & 1];
#pragma unroll 2
      for (int kk = 0; kk < KO; kk += 16) {
        unsigned af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(af[mt], a_rows_at(s.dz, LDZ, wm * 32 + mt * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned bq[4];
          ldsm_x4_trans(bq, b_cols_at(ws, LDI, wn * 64 + np * 16, kk, lane));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(acc[mt][2 * np], af[mt], bq[0], bq[1]);
            mma(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // dz and W[step & 1] are consumed
    if (c + 1 < chunks || !active) continue;

    const int gq = lane / 4, q = lane % 4;
    const bool pair_store = c_in % 2 == 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 32 + mt * 16 + gq + 8 * half;
        if (row >= n_rows) continue;
        bf16* out = dx + (size_t(f0) * V + row) * c_in;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int i = i0 + wn * 64 + nt * 8 + 2 * q;
          const bf162 val = __floats2bfloat162_rn(acc[mt][nt][2 * half],
                                                  acc[mt][nt][2 * half + 1]);
          if (pair_store && i + 1 < c_in) {
            *reinterpret_cast<bf162*>(out + i) = val;
          } else {
            if (i < c_in) out[i] = val.x;
            if (i + 1 < c_in) out[i + 1] = val.y;
          }
        }
      }
  }
}

// One block per (split of the 5-frame chunks, OCH output channels, NI
// input channels); ws_w[split] gets the split's partial dW, ws_b[split]
// its partial db (from the blocks of input channel tile 0).
__global__ void __launch_bounds__(THREADS, 2)
    mma_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const float* __restrict__ a, float* __restrict__ ws_w,
                  float* __restrict__ ws_b, int frames, int c_in, int c_out) {
  using namespace mma_bf16;
  extern __shared__ float4 smem4[];
  DwSmem& s = *reinterpret_cast<DwSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;  // 48 rows of dW x 32 channels
  const int split = blockIdx.x, splits = gridDim.x;
  const int o0 = blockIdx.y * OCH, i0 = blockIdx.z * NI;
  const int n_o = min(OCH, c_out - o0);
  const int chunks = (frames + MF - 1) / MF;
  const int c_begin = int(static_cast<long long>(chunks) * split / splits);
  const int c_end = int(static_cast<long long>(chunks) * (split + 1) / splits);
  const bool active = wn * 32 < (min(NI, c_in - i0) + 15) / 16 * 16;
  // db: threads (row group, column pair) over the blocks of input tile 0
  const bool bias_thread = blockIdx.z == 0 && tid < MF * (KO / 2);
  const int bp = tid % (KO / 2), bg = tid / (KO / 2);
  const bool g_aligned = rows_aligned(g, c_out);
  const bool x_aligned = rows_aligned(x, c_in);

  stage_adjacency(a, s.a, tid);
  for (int i = tid; i < (MT - MROWS) * LDZ; i += THREADS)
    s.dz[MROWS * LDZ + i] = __float2bfloat16(0.f);

  auto rows_of = [&](int chunk) { return min(MF, frames - chunk * MF) * V; };
  auto stage = [&](int chunk, int buf) {  // g into its one buffer, x into buf
    const size_t r0 = size_t(chunk) * MROWS;
    stage_tile<GROWS, OCH, THREADS, true>(s.g, LDG, g + r0 * c_out, c_out,
                                          rows_of(chunk), o0, c_out,
                                          g_aligned, tid);
    stage_tile<MT, NI, THREADS>(s.x[buf], LDI, x + r0 * c_in, c_in,
                                rows_of(chunk), i0, c_in, x_aligned, tid);
    cp_async_commit();
  };

  float acc[3][4][4];
#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float bacc[2] = {0.f, 0.f};

  if (c_begin < c_end) stage(c_begin, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c's g and x are in place
    dz_products(s.a, s.g, s.dz, warp, lane);
    __syncthreads();  // dz is complete; g is free
    if (c + 1 < c_end) stage(c + 1, buf ^ 1);  // loads while c multiplies
    if (bias_thread) {  // the rows of frame bg, columns 2 bp and 2 bp + 1
      const bf16* col = s.dz + bg * V * LDZ + 2 * bp;
      for (int v = 0; v < V; ++v) {
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(col + v * LDZ));
        bacc[0] += d.x;
        bacc[1] += d.y;
      }
    }
    if (active) {
      const bf16* xs = s.x[buf];
#pragma unroll 2
      for (int kk = 0; kk < MT; kk += 16) {
        unsigned af[3][4];
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
          ldsm_x4_trans(af[mt],
                        a_cols_at(s.dz, LDZ, wm * 48 + mt * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bq[4];
          ldsm_x4_trans(bq, b_cols_at(xs, LDI, wn * 32 + np * 16, kk, lane));
#pragma unroll
          for (int mt = 0; mt < 3; ++mt) {
            mma(acc[mt][2 * np], af[mt], bq[0], bq[1]);
            mma(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // dz and x[buf] are consumed
  }

  float* pw = ws_w + size_t(split) * K * c_out * c_in;
  const int gq = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = wm * 48 + mt * 16 + gq + 8 * (e / 2);
      const int k = m / OCH, o = m % OCH;
      if (o >= n_o) continue;
      float* prow = pw + size_t(k * c_out + o0 + o) * c_in;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int i = i0 + wn * 32 + nt * 8 + 2 * q + e % 2;
        if (i < c_in) prow[i] = acc[mt][nt][e];
      }
    }
  if (blockIdx.z != 0) return;
  if (bias_thread) {
    s.red[bg][2 * bp] = bacc[0];
    s.red[bg][2 * bp + 1] = bacc[1];
  }
  __syncthreads();
  if (tid < KO && tid % OCH < n_o) {
    float total = 0.f;
    for (int r = 0; r < MF; ++r) total += s.red[r][tid];
    ws_b[size_t(split) * K * c_out + (tid / OCH) * c_out + o0 + tid % OCH] =
        total;
  }
}

int launch(const bf16* x, const bf16* g, const bf16* w, const float* a,
           bf16* dx, float* ws_w, float* ws_b, int frames, int c_in,
           int c_out, int splits, cudaStream_t stream) {
  const int dx_smem = int(sizeof(DxSmem));
  cudaError_t err = allow_smem(mma_dx_kernel, dx_smem);
  if (err != cudaSuccess) return int(err);
  const int tiles = (frames + MF - 1) / MF * ((c_in + NI - 1) / NI);
  mma_dx_kernel<<<mma_bf16::persistent_blocks(2, tiles), THREADS, dx_smem,
                  stream>>>(g, w, a, dx, frames, c_in, c_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int dw_smem = int(sizeof(DwSmem));
  err = allow_smem(mma_dw_kernel, dw_smem);
  if (err != cudaSuccess) return int(err);
  const dim3 dw_grid(splits, (c_out + OCH - 1) / OCH, (c_in + NI - 1) / NI);
  mma_dw_kernel<<<dw_grid, THREADS, dw_smem, stream>>>(
      x, g, a, ws_w, ws_b, frames, c_in, c_out);
  return int(cudaGetLastError());
}

}  // namespace mma_bwd

// The splits' partials of dW and db, summed in a fixed order.
int sum_splits(float* ws, float* dw, float* db, int c_in, int c_out,
               int splits, cudaStream_t stream) {
  const int n_w = K * c_out * c_in, n_b = K * c_out;
  float* ws_b = ws + size_t(splits) * n_w;
  cudaError_t err = channel_sums::launch(ws, splits, n_w, dw, stream);
  if (err != cudaSuccess) return int(err);
  return int(channel_sums::launch(ws_b, splits, n_b, db, stream));
}

}  // namespace

// x: (frames, V, c_in) in T; g: (frames, V, c_out) in T; w: (K * c_out,
// c_in) in T (the bf16 entry takes the weight cast to bf16); a: (K, V, V)
// f32. Out: dx like x; dw (K * c_out, c_in) f32; db (K * c_out,) f32. ws:
// splits * K * c_out * (c_in + 1) f32 of workspace; a split is a fixed
// share of the 2-frame (f32) or 5-frame (bf16) chunks. All
// contiguous, frames >= 1. Returns the first cudaError_t (0 on success).
extern "C" int sgcn_bwd_f32(const void* x, const void* g, const void* w,
                            const void* a, void* dx, void* dw, void* db,
                            void* ws, int frames, int c_in, int c_out,
                            int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_w = static_cast<float*>(ws);
  const int err =
      (c_in <= sgcn_f32::NARROW_C_IN ? launch_f32<true> : launch_f32<false>)(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(w), static_cast<const float*>(a),
          static_cast<float*>(dx), ws_w,
          ws_w + size_t(splits) * K * c_out * c_in, frames, c_in, c_out,
          splits, st);
  if (err != 0) return err;
  return sum_splits(ws_w, static_cast<float*>(dw), static_cast<float*>(db),
                    c_in, c_out, splits, st);
}

extern "C" int sgcn_bwd_bf16(const void* x, const void* g, const void* w,
                             const void* a, void* dx, void* dw, void* db,
                             void* ws, int frames, int c_in, int c_out,
                             int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_w = static_cast<float*>(ws);
  const int err = mma_bwd::launch(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(w), static_cast<const float*>(a),
      static_cast<bf16*>(dx), ws_w,
      ws_w + size_t(splits) * K * c_out * c_in, frames, c_in, c_out, splits,
      st);
  if (err != 0) return err;
  return sum_splits(ws_w, static_cast<float*>(dw), static_cast<float*>(db),
                    c_in, c_out, splits, st);
}

// Dynamic shared memory of the f32 kernels (sgcn_tile_f32.cuh), in bytes:
// the forward, dx and dW.
extern "C" void sgcn_f32_smem_bytes(int* fwd, int* dx, int* dw) {
  *fwd = int(sizeof(sgcn_f32::FwdSmem));
  *dx = int(sizeof(sgcn_f32::DxSmem));
  *dw = int(sizeof(sgcn_f32::DwSmem));
}
