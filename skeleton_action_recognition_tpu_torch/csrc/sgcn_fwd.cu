// Fused ST-GCN spatial graph conv, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel skeleton_action_recognition_tpu/ops/pallas/sgcn.py::
// _fwd_kernel (make_fused_graph_conv with with_stats=False). Per frame f of
// x (F, V, C_in):
//
//     z[k, v, o]   = sum_c x[f, v, c] * W[k * C_out + o, c] + b[k * C_out + o]
//     out[f, w, o] = sum_k sum_v A[k, v, w] * z[k, v, o]
//
// W is nn.Linear's (K * C_out, C_in) weight, partition-major rows.
//
// What bounds it on the H100: z is three times the size of the output, and
// the unfused version writes it to device memory and reads it back. At the
// widest block (C_in = C_out = 256) a frame costs 9.8 MFLOP and the unfused
// version moves x, z twice and out: ~48 FLOP per byte in f32, ~96 in bf16.
// In bf16 that is below the ~295 FLOP/B at which the tensor cores and not
// device memory set the pace, so the bf16 layer is bound by device-memory
// bytes once its products run on the tensor cores. In f32 with TF32 off the
// products run on the CUDA cores, whose ridge is ~67 TFLOP/s / 3.35 TB/s =
// ~20 FLOP/B, so both paths are bound by CUDA-core FLOPs there. Both
// kernels keep z in shared memory: each frame's x is read once and its
// output written once (4x fewer bytes than the unfused version).
//
// f32 (sgcn_fwd_kernel, on the CUDA cores, never TF32): one thread block
// per (FRAMES frames, CO_TILE output channels); thread (f, o) owns frame f
// and output channel o.
//   1. Each block lists, per output joint w, the nonzero A[k, v, w] (a
//      handful of the K * V entries of a column).
//   2. Thread (f, o) keeps z[f, k, v, o] for all k, v in 75 registers and
//      loops over C_in in chunks of 32. Each chunk of x (coalesced along
//      C_in, read as float4) and of W (coalesced along C_in, stored
//      transposed so a warp reads it along o) is staged in shared memory.
//   3. z + b is written to shared memory over the chunks' place.
//   4. Thread (f, o) sums, for each w, its column's listed A[k, v, w] times
//      z[f, k, v, o], and writes out[f, w, o].
//
// bf16 (mma_fwd_kernel): every product on the tensor cores through
// mma_bf16.cuh's mma.sync.m16n8k16 with f32 sums (the TPU kernel's jnp.dot
// with f32 accumulation), in two GEMMs per tile of MF = 5 frames and CO = 32
// output channels:
//   1. z = x W^T + b: the 125 rows (f, v), padded to 128, by the 96 columns
//      (k, o), its depth C_in walked in chunks of 64. The chunks of x and of
//      W (cast to bf16 once per call by the wrapper, the rounding the TPU
//      kernel does) are staged by cp.async two deep, so that the next chunk
//      loads while this one is multiplied; x rows that are not 16-byte
//      aligned (C_in = 3) are staged element by element, zero-padded to a
//      depth of 16. The 8 warps hold 32 x 48 of the tile each, in f32
//      registers. z + b is rounded to bf16 (the TPU kernel rounds z to its
//      matmul type) into shared memory, [f][(k, v)][o].
//   2. out_f = A^T z_f per frame: the 25 joints w (padded to 32) by the 32
//      channels, depth the 75 (k, v) (padded to 80), against the dense
//      adjacency in bf16, staged once per block. On the tensor cores the
//      1,875 dense entries cost less than a loop over the 73 nonzeros on the
//      CUDA cores, whose issue slots it would take; the products are exact
//      and the sums f32 in both.
// The kernel is persistent (two blocks on each SM walk the tiles), so the
// adjacency is staged once per block and the next tile's first chunk loads
// while this tile's epilogue runs. The padding rows and the frames past the
// input's end are zero in and never stored.
// A is rounded to x's dtype, as the TPU kernel casts it to its matmul type.
// All sums are f32.
//
// The stats entry points (sgcn_fwd_stats_*) also replace the TPU kernel
// _fwd_stats_kernel (make_fused_graph_conv with with_stats=True): the
// epilogue sums, per output channel, the output and its square over every
// (frame, joint) row, in f32 and on the value rounded to x's dtype (what a
// BatchNorm reading out back would see). The threads of a channel meet in
// shared memory in a fixed order, each block writes its partial to a
// workspace, and channel_sums.cuh adds the partials in a fixed order: no
// float atomics, so repeats are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "channel_sums.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int V = 25;        // NTU RGB+D joints
constexpr int K = 3;         // spatial partitions
constexpr int KV = K * V;

// ---------------------------------------------------------------------------
// f32, on the CUDA cores.

constexpr int FRAMES = 2;    // frames per block
constexpr int CO_TILE = 64;  // output channels per block
constexpr int THREADS = FRAMES * CO_TILE;
constexpr int C_CHUNK = 32;                   // input channels per chunk
constexpr int W_STRIDE = K * CO_TILE + 1;     // padded: conflict-free stores
constexpr int X_FLOATS = FRAMES * V * C_CHUNK;  // x chunk [f][v][c]
constexpr int W_FLOATS = C_CHUNK * W_STRIDE;    // W chunk [c][k * CO_TILE + o]
constexpr int Z_FLOATS = FRAMES * K * V * CO_TILE;  // z [f][k][v][o]
constexpr int REGION = X_FLOATS + W_FLOATS > Z_FLOATS ? X_FLOATS + W_FLOATS
                                                      : Z_FLOATS;
constexpr int MAX_NNZ = KV;  // nonzeros a column of A can hold
static_assert(K * V * V <= REGION, "A is staged in the chunk region");

struct Smem {
  float region[REGION];         // dense A, then the x and W chunks, then z
  float bias[K * CO_TILE];      // b[k][o]
  float a_val[V][MAX_NNZ];      // nonzero A[k, v, w] of column w
  unsigned char a_kv[V][MAX_NNZ];  // their k * V + v
  int a_nnz[V];
  float red[2][THREADS];        // the stats epilogue's per-thread sums
};

// With STATS, partials[blockIdx.x][0 or 1][c_out] gets the block's sums of
// out and out^2 over its frames.
template <bool STATS>
__global__ void __launch_bounds__(THREADS)
    sgcn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ a,
                    float* __restrict__ out, float* __restrict__ partials,
                    int frames, int c_in, int c_out) {
  extern __shared__ float4 smem4[];
  Smem& s = *reinterpret_cast<Smem*>(smem4);
  float* xs = s.region;             // x chunk [f][v][C_CHUNK]
  float* ws = s.region + X_FLOATS;  // W chunk [c][W_STRIDE]
  float* zs = s.region;             // z [f][k][v][o], after the chunks

  const int tid = threadIdx.x;
  const int f = tid / CO_TILE, o = tid % CO_TILE;
  const int f0 = blockIdx.x * FRAMES;
  const int o0 = blockIdx.y * CO_TILE;
  const int n_f = min(FRAMES, frames - f0);

  for (int i = tid; i < K * CO_TILE; i += THREADS) {
    const int oo = o0 + i % CO_TILE;
    s.bias[i] = oo < c_out ? b[(i / CO_TILE) * c_out + oo] : 0.f;
  }
  for (int i = tid; i < K * V * V; i += THREADS) s.region[i] = a[i];
  __syncthreads();
  if (tid < V) {  // thread w lists column w
    int n = 0;
    for (int kv = 0; kv < KV; ++kv) {
      const float av = s.region[kv * V + tid];
      if (av != 0.f) {
        s.a_val[tid][n] = av;
        s.a_kv[tid][n] = static_cast<unsigned char>(kv);
        ++n;
      }
    }
    s.a_nnz[tid] = n;
  }

  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;

  // frames are contiguous rows of V * c_in values
  const float* xg = x + size_t(f0) * V * c_in;
  for (int c0 = 0; c0 < c_in; c0 += C_CHUNK) {
    __syncthreads();  // dense A listed / previous chunk consumed
    for (int i = tid; i < X_FLOATS; i += THREADS) {
      const int row = i / C_CHUNK, c = c0 + i % C_CHUNK;
      xs[i] = (row < n_f * V && c < c_in) ? xg[size_t(row) * c_in + c] : 0.f;
    }
    for (int i = tid; i < C_CHUNK * K * CO_TILE; i += THREADS) {
      const int j = i / C_CHUNK, cl = i % C_CHUNK;  // j = k * CO_TILE + o
      const int row_o = o0 + j % CO_TILE;
      const int c = c0 + cl;
      ws[cl * W_STRIDE + j] =
          (row_o < c_out && c < c_in)
              ? w[size_t((j / CO_TILE) * c_out + row_o) * c_in + c]
              : 0.f;
    }
    __syncthreads();
    // zero-filled past c_in, so a partial chunk runs to a multiple of 4
    const int n_c = min(C_CHUNK, (c_in - c0 + 3) / 4 * 4);
    for (int cl = 0; cl < n_c; cl += 4) {
      float wk[4][K];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k)
          wk[j][k] = ws[(cl + j) * W_STRIDE + k * CO_TILE + o];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 xv = *reinterpret_cast<const float4*>(
            &xs[(f * V + v) * C_CHUNK + cl]);
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[k][v] += xv.x * wk[0][k] + xv.y * wk[1][k] + xv.z * wk[2][k] +
                       xv.w * wk[3][k];
      }
    }
  }
  __syncthreads();  // every thread is done with the chunks

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float bias = s.bias[k * CO_TILE + o];
#pragma unroll
    for (int v = 0; v < V; ++v)
      zs[((f * K + k) * V + v) * CO_TILE + o] = acc[k][v] + bias;
  }
  __syncthreads();

  float s_sum = 0.f, s_sq = 0.f;
  if (f < n_f && o0 + o < c_out) {
    const float* zf = zs + f * K * V * CO_TILE + o;
    float* og = out + size_t(f0 + f) * V * c_out + o0 + o;
    for (int wv = 0; wv < V; ++wv) {
      float sum = 0.f;
      for (int i = 0; i < s.a_nnz[wv]; ++i)
        sum += s.a_val[wv][i] * zf[s.a_kv[wv][i] * CO_TILE];
      og[size_t(wv) * c_out] = sum;
      if (STATS) {
        s_sum += sum;
        s_sq += sum * sum;
      }
    }
  }
  if (!STATS) return;
  s.red[0][tid] = s_sum;
  s.red[1][tid] = s_sq;
  __syncthreads();
  if (f == 0 && o0 + o < c_out) {
    float sum = 0.f, sq = 0.f;
    for (int ff = 0; ff < FRAMES; ++ff) {
      sum += s.red[0][ff * CO_TILE + o];
      sq += s.red[1][ff * CO_TILE + o];
    }
    float* part = partials + size_t(blockIdx.x) * 2 * c_out + o0 + o;
    part[0] = sum;
    part[c_out] = sq;
  }
}

// ---------------------------------------------------------------------------
// bf16, on the tensor cores.

namespace mma_fwd {

using mma_bf16::bf16;
using mma_bf16::bf162;

constexpr int MF = 5;             // frames per tile
constexpr int MROWS = MF * V;     // its 125 rows (f, v)
constexpr int MT = 128;           // rows, padded to 16-row MMA tiles
constexpr int CO = 32;            // output channels per tile
constexpr int NT = K * CO;        // 96 columns (k, o)
constexpr int KC = 64;            // input channels per chunk
constexpr int LDS = KC + 8;       // staged x or W row, in bf16
constexpr int KVP = 80;           // (k, v) rows of a frame's z, padded
constexpr int LDZ = CO + 8;       // z row, in bf16
constexpr int WP = 32;            // joints w, padded
constexpr int LDA = KVP + 8;      // A^T row, in bf16
constexpr int THREADS = 256;      // 8 warps
constexpr int UNITS = MF * 2 * 2; // adjacency GEMM: (frame, 16 w, 16 o)
constexpr int X_ELEMS = MT * LDS;
constexpr int W_ELEMS = NT * LDS;

struct Smem {
  bf16 x[2][X_ELEMS];        // x chunk [row][c], two stages
  bf16 w[2][W_ELEMS];        // W chunk [k * CO + o][c], two stages
  bf16 z[MF * KVP * LDZ];    // z [f][k * V + v][o]; rows 75..79 zero
  bf16 at[WP * LDA];         // A^T [w][k * V + v], zero-padded
  float bias[NT];            // b[k][o]
  float red[2][MF * 2][CO];  // the stats epilogue's per-unit sums
};

// One tile: rows f0 * V.. of n_rows, output channels o0.. of n_o.
struct Tile {
  int f0, n_rows, o0, n_o, index;
};

__device__ __forceinline__ Tile tile_at(int t, int co_tiles, int frames,
                                        int c_out) {
  Tile tile;
  tile.index = t / co_tiles;  // the frame tile: its stats partial's row
  tile.f0 = tile.index * MF;
  tile.n_rows = min(MF, frames - tile.f0) * V;
  tile.o0 = (t % co_tiles) * CO;
  tile.n_o = min(CO, c_out - tile.o0);
  return tile;
}

// With STATS, partials[frame tile][0 or 1][c_out] gets the tile's sums of
// out and out^2. w is the bf16 weight. Block b takes tiles b, b + grid,
// ...; tile t is frame tile t / co_tiles and output channel tile
// t % co_tiles, so that neighbouring blocks share x in L2.
template <bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
    mma_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ a,
                   bf16* __restrict__ out, float* __restrict__ partials,
                   int frames, int c_in, int c_out) {
  using namespace mma_bf16;
  extern __shared__ float4 smem4[];
  Smem& s = *reinterpret_cast<Smem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // 32 rows x 48 columns of z
  const int gq = lane / 4, q = lane % 4;
  const int co_tiles = (c_out + CO - 1) / CO;
  const int tiles = (frames + MF - 1) / MF * co_tiles;
  const int chunks = (c_in + KC - 1) / KC;
  const int my_tiles = (tiles - int(blockIdx.x) + int(gridDim.x) - 1) /
                       int(gridDim.x);
  const int steps = my_tiles * chunks;  // (tile, chunk) pairs of this block
  const bool x_aligned = rows_aligned(x, c_in);
  const bool w_aligned = rows_aligned(w, c_in);

  // once per block: A^T in bf16 and z's padding rows, both zero-padded
  for (int i = tid; i < WP * LDA; i += THREADS) {
    const int wv = i / LDA, kv = i % LDA;
    s.at[i] = __float2bfloat16(wv < V && kv < KV ? a[kv * V + wv] : 0.f);
  }
  for (int i = tid; i < MF * (KVP - KV) * LDZ; i += THREADS) {
    const int f = i / ((KVP - KV) * LDZ), r = i % ((KVP - KV) * LDZ);
    s.z[(f * KVP + KV) * LDZ + r] = __float2bfloat16(0.f);
  }

  auto stage = [&](int step) {
    const Tile tile = tile_at(blockIdx.x + step / chunks * gridDim.x,
                              co_tiles, frames, c_out);
    const int c0 = step % chunks * KC, buf = step & 1;
    stage_tile<MT, KC, THREADS>(s.x[buf], LDS,
                                x + size_t(tile.f0) * V * c_in, c_in,
                                tile.n_rows, c0, c_in, x_aligned, tid);
    for (int k = 0; k < K; ++k)
      stage_tile<CO, KC, THREADS>(s.w[buf] + k * CO * LDS, LDS,
                                  w + size_t(k * c_out + tile.o0) * c_in,
                                  c_in, tile.n_o, c0, c_in, w_aligned, tid);
    cp_async_commit();
  };

  float acc[2][6][4];
  if (steps > 0) stage(0);
  for (int step = 0; step < steps; ++step) {
    const Tile tile = tile_at(blockIdx.x + step / chunks * gridDim.x,
                              co_tiles, frames, c_out);
    const int c = step % chunks;
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      for (int i = tid; i < NT; i += THREADS) {
        const int o = i % CO;
        s.bias[i] = o < tile.n_o ? b[(i / CO) * c_out + tile.o0 + o] : 0.f;
      }
    }
    if (step + 1 < steps) {  // the next chunk loads while this one multiplies
      stage(step + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk c is in place
    const bf16* xs = s.x[step & 1];
    const bf16* ws = s.w[step & 1];
    const int depth = min(KC, c_in - c * KC);  // zero-padded to 16
    for (int kk = 0; kk < depth; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], a_rows_at(xs, LDS, wm * 32 + mt * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        unsigned bq[4];
        ldsm_x4(bq, b_rows_at(ws, LDS, wn * 48 + np * 16, kk, lane));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(acc[mt][2 * np], af[mt], bq[0], bq[1]);
          mma(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // chunk c is consumed: its buffers may be refilled
    if (c + 1 < chunks) continue;

    // z + b, rounded to bf16: z[f][k * V + v][o]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 32 + mt * 16 + gq + 8 * half;
        if (row >= MROWS) continue;
        const int f = row / V, v = row % V;
#pragma unroll
        for (int nt = 0; nt < 6; ++nt) {
          const int col = wn * 48 + nt * 8 + 2 * q;  // even: one k for both
          const int k = col / CO, o = col % CO;
          *reinterpret_cast<bf162*>(s.z + (f * KVP + k * V + v) * LDZ + o) =
              __floats2bfloat162_rn(acc[mt][nt][2 * half] + s.bias[col],
                                    acc[mt][nt][2 * half + 1] +
                                        s.bias[col + 1]);
        }
      }
    __syncthreads();

    // out_f = A^T z_f: unit (f, 16 joints, 16 channels) per warp in turn
    const bool pair_store = c_out % 2 == 0;
    for (int u = warp; u < UNITS; u += THREADS / 32) {
      const int f = u / 4, mw = (u / 2) % 2, nh = u % 2;
      float oacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* zf = s.z + f * KVP * LDZ;
#pragma unroll
      for (int kk = 0; kk < KVP; kk += 16) {
        unsigned af[4], bq[4];
        ldsm_x4(af, a_rows_at(s.at, LDA, mw * 16, kk, lane));
        ldsm_x4_trans(bq, b_cols_at(zf, LDZ, nh * 16, kk, lane));
        mma(oacc[0], af, bq[0], bq[1]);
        mma(oacc[1], af, bq[2], bq[3]);
      }
      float s_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float s_sq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      const bool frame_in = f * V < tile.n_rows;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wv = mw * 16 + gq + 8 * half;
        if (!frame_in || wv >= V) continue;
        bf16* og = out + (size_t(tile.f0 + f) * V + wv) * c_out + tile.o0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int o = nh * 16 + nt * 8 + 2 * q;
          const bf162 val = __floats2bfloat162_rn(oacc[nt][2 * half],
                                                  oacc[nt][2 * half + 1]);
          if (pair_store && o + 1 < tile.n_o) {
            *reinterpret_cast<bf162*>(og + o) = val;
          } else {
            if (o < tile.n_o) og[o] = val.x;
            if (o + 1 < tile.n_o) og[o + 1] = val.y;
          }
          if (STATS) {  // on the rounded values; past n_o they are zero
            const float2 r = __bfloat1622float2(val);
            s_sum[nt][0] += r.x;
            s_sum[nt][1] += r.y;
            s_sq[nt][0] += r.x * r.x;
            s_sq[nt][1] += r.y * r.y;
          }
        }
      }
      if (STATS) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float t0 = lane_group_sum(s_sum[nt][e]);
            const float t1 = lane_group_sum(s_sq[nt][e]);
            if (gq == 0) {
              const int o = nh * 16 + nt * 8 + 2 * q + e;
              s.red[0][f * 2 + mw][o] = t0;
              s.red[1][f * 2 + mw][o] = t1;
            }
          }
      }
    }
    if constexpr (STATS) {
      __syncthreads();
      if (tid < 2 * CO) {
        const int which = tid / CO, ol = tid % CO;
        if (ol < tile.n_o) {
          float total = 0.f;
          for (int r = 0; r < MF * 2; ++r) total += s.red[which][r][ol];
          partials[(size_t(tile.index) * 2 + which) * c_out + tile.o0 + ol] =
              total;
        }
      }
    }
  }
}

}  // namespace mma_fwd

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// With STATS, ws holds one partial of 2 * c_out floats per frame tile
// (block row), and sums gets the 2 * c_out channel sums (out, then out^2).
template <bool STATS>
int launch_f32(const void* x, const void* w, const void* b, const void* a,
               void* out, void* ws, void* sums, int frames, int c_in,
               int c_out, cudaStream_t stream) {
  const int smem = int(sizeof(Smem));
  cudaError_t err = allow_smem(sgcn_fwd_kernel<STATS>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((frames + FRAMES - 1) / FRAMES,
                  (c_out + CO_TILE - 1) / CO_TILE);
  sgcn_fwd_kernel<STATS><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<float*>(out), static_cast<float*>(ws), frames, c_in, c_out);
  err = cudaGetLastError();
  if (!STATS || err != cudaSuccess) return int(err);
  return int(channel_sums::launch(static_cast<const float*>(ws), grid.x,
                                  2 * c_out, static_cast<float*>(sums),
                                  stream));
}

template <bool STATS>
int launch_bf16(const void* x, const void* w, const void* b, const void* a,
                void* out, void* ws, void* sums, int frames, int c_in,
                int c_out, cudaStream_t stream) {
  namespace m = mma_fwd;
  const int smem = int(sizeof(m::Smem));
  cudaError_t err = allow_smem(m::mma_fwd_kernel<STATS>, smem);
  if (err != cudaSuccess) return int(err);
  const int frame_tiles = (frames + m::MF - 1) / m::MF;
  const int blocks = mma_bf16::persistent_blocks(
      2, frame_tiles * ((c_out + m::CO - 1) / m::CO));
  m::mma_fwd_kernel<STATS><<<blocks, m::THREADS, smem, stream>>>(
      static_cast<const m::bf16*>(x), static_cast<const m::bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<m::bf16*>(out), static_cast<float*>(ws), frames, c_in,
      c_out);
  err = cudaGetLastError();
  if (!STATS || err != cudaSuccess) return int(err);
  return int(channel_sums::launch(static_cast<const float*>(ws), frame_tiles,
                                  2 * c_out, static_cast<float*>(sums),
                                  stream));
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

}  // namespace

// x: (frames, V, c_in); b: (K * c_out,) f32; a: (K, V, V) f32; out:
// (frames, V, c_out) like x; w: (K * c_out, c_in), f32 for the f32 entries
// and bf16 for the bf16 ones. All contiguous. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int sgcn_fwd_f32(const void* x, const void* w, const void* b,
                            const void* a, void* out, int frames, int c_in,
                            int c_out, void* stream) {
  return launch_f32<false>(x, w, b, a, out, nullptr, nullptr, frames, c_in,
                           c_out, as_stream(stream));
}

extern "C" int sgcn_fwd_bf16(const void* x, const void* w, const void* b,
                             const void* a, void* out, int frames, int c_in,
                             int c_out, void* stream) {
  return launch_bf16<false>(x, w, b, a, out, nullptr, nullptr, frames, c_in,
                            c_out, as_stream(stream));
}

// As sgcn_fwd_*, plus ws: one partial of 2 * c_out f32 per frame tile (2
// frames in f32, 5 in bf16) of workspace, and sums: (2 * c_out,) f32, the
// sums of out and of out^2 over all frames and joints per output channel.
extern "C" int sgcn_fwd_stats_f32(const void* x, const void* w,
                                  const void* b, const void* a, void* out,
                                  void* ws, void* sums, int frames, int c_in,
                                  int c_out, void* stream) {
  return launch_f32<true>(x, w, b, a, out, ws, sums, frames, c_in, c_out,
                          as_stream(stream));
}

extern "C" int sgcn_fwd_stats_bf16(const void* x, const void* w,
                                   const void* b, const void* a, void* out,
                                   void* ws, void* sums, int frames, int c_in,
                                   int c_out, void* stream) {
  return launch_bf16<true>(x, w, b, a, out, ws, sums, frames, c_in, c_out,
                           as_stream(stream));
}
