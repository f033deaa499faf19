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
// f32 (sgcn_f32::fwd_kernel in sgcn_tile_f32.cuh, on the CUDA cores, never
// TF32): a register-blocked tile of 5 frames x 32 output channels, z = x W^T
// + b as a (125 rows, padded to 128) x 96 (k, o) product with an 8 x 8
// block of accumulators a thread and the depth C_in staged in chunks of 16
// by cp.async (W^T transposed once a call by the wrapper); then z + b in
// shared memory and out_f = A^T z_f per frame over each column's nonzero A
// (see the header's notes).
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
#include "sgcn_tile_f32.cuh"

namespace {

constexpr int V = 25;        // NTU RGB+D joints
constexpr int K = 3;         // spatial partitions
constexpr int KV = K * V;

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

// With STATS, ws holds one partial of 2 * c_out floats per frame tile,
// and sums gets the 2 * c_out channel sums (out, then out^2).
template <bool STATS>
int launch_f32(const void* x, const void* w, const void* b, const void* a,
               void* out, void* ws, void* sums, int frames, int c_in,
               int c_out, cudaStream_t stream) {
  namespace f = sgcn_f32;
  const int smem = int(sizeof(f::FwdSmem));
  cudaError_t err = allow_smem(f::fwd_kernel<STATS>, smem);
  if (err != cudaSuccess) return int(err);
  f::fwd_kernel<STATS><<<f::fwd_blocks(frames, c_out), f::FWD_THREADS, smem,
                         stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<float*>(out), static_cast<float*>(ws), frames, c_in, c_out);
  err = cudaGetLastError();
  if (!STATS || err != cudaSuccess) return int(err);
  return int(channel_sums::launch(static_cast<const float*>(ws),
                                  (frames + f::MF - 1) / f::MF, 2 * c_out,
                                  static_cast<float*>(sums), stream));
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
// (frames, V, c_out) like x; w: the f32 entries take the weight transposed,
// (c_in, K * c_out) f32, the bf16 ones as it is, (K * c_out, c_in) bf16.
// All contiguous. Returns the cudaError_t of the launch (0 on success).
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

// As sgcn_fwd_*, plus ws: one partial of 2 * c_out f32 per frame tile (5
// frames) of workspace, and sums: (2 * c_out,) f32, the
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
