// The fused temporal chain's bf16 kernels on the tensor cores: the same
// functions as tconv_tile.cuh's tile_kernel (the forward, replacing the TPU
// kernel skeleton_action_recognition_tpu/ops/pallas/tconv.py::_fwd_kernel,
// and the input gradient of its backward, _bwd_kernel) and tconv_bwd.cu's
// wgrad_kernel (the weight and bias gradients of _bwd_kernel), with the
// products of bf16 operands summed in f32 by mma.sync.m16n8k16.
//
// What bounds them on the H100: each is a GEMM of 9 * C * C multiply-adds
// a (clip, frame, joint) row against 4 C bytes of bf16 activations in and
// out, 4.5 C FLOP per byte: at C >= 64 the bf16 tensor cores (989 TFLOP/s
// dense) and not device memory (3.35 TB/s) bound them. mma.sync reaches a
// part of that peak (wgmma is later work); what else costs is what the same
// warps do beside the products: the copies into shared memory and the
// affine (15-25% of each kernel on an H100).
//
// Fragments: as mma_bf16.cuh states (lane = 4 g + q); every fragment comes
// from ldmatrix.x4, and every tile arrives by cp.async 16-byte copies in a
// ring of two stages, so that the next chunk loads while this one is
// multiplied. Rows that are not 16-byte aligned (C not a multiple of 8) are
// staged by 32-bit loads instead, at once.
//
// mma_tile_kernel (#4, and #5's input gradient): persistent, one block an
// SM walking tiles of (clip, MT = 512 rows of the clip, CT = 64 output
// channels); neighbouring tiles share their rows in L2. The rows t * 25 + v
// of a clip are contiguous, so a tap dt is a shift of (dt - 4) * 25 rows and
// a tile needs 100 halo rows on each side (1.39 staged rows an output row).
// A chunk of CK = 32 reduction channels stages A (MT + 200 rows, [row][k])
// and the bf16 weight operand for all 9 taps ([dt][n][k], cast and permuted
// once a call by the wrapper); the tap dt reads A from row 25 dt on. In the
// forward the affine and the ReLU are applied once an element, in shared
// memory, after the chunk arrives; halo rows outside the clip arrive as
// zeros and stay zero (the SAME padding is on h, and relu(shift) is not 0).
// The 8 warps hold 64 rows x 64 channels each (128 f32 accumulators a
// thread). The input gradient's epilogue reads s from a tile of s staged by
// cp.async as one more step of the ring. The epilogues write the output and
// per-channel partial sums, met across lanes by a fixed butterfly of
// shuffles and across warps in shared memory in a fixed order.
//
// mma_wgrad_kernel (#5's dW and dbias): dW[:, :, dt] = gue^T h_dt, a
// product of depth rows. One block an SM per (split of the clips, 64 output
// channels, 64 input channels, all 9 taps). A split's clips are walked as
// one stream of rows with 100 zero rows after each clip (and before the
// first), so that every tap of a row reads its own clip or zeros: the SAME
// padding. Chunks of RC = 256 rows of gue and h arrive as they lie in memory
// ([row][channel]); h fills a ring of 2 RC + 200 rows, so each row of h is
// staged and transformed once and the taps' halo never reloads. A (gue^T)
// comes from ldmatrix.trans at the chunk's rows, shared by the 9 taps; B of
// tap dt from ldmatrix.trans at row 25 dt on (any row: ldmatrix takes one
// address a row). Warps hold 32 output x 16 input channels x 9 taps. dbias
// is gue^T times a column of ones on the tensor cores, the row steps dealt
// to the warps in a fixed rotation. Each block writes its split's partial of
// dW (and of dbias) as wgrad_kernel does, and channel_sums.cuh adds the
// splits in a fixed order: repeats are bit-identical.
//
// The affine of both kernels runs between the barriers of a chunk, each
// thread on groups of 8 channels that stay its own (their scales and shifts
// loaded once a chunk). Interleaving the next chunk's copies and affine with
// this chunk's products, each thread on its own copies with one barrier a
// step, was slower on an H100 (#4 12.1 against 11.3 ms, #5 25.2 against
// 22.2): with one block of 8 warps an SM, every instruction a warp adds
// delays its own products, wherever it stands.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "tconv_tile.cuh"

namespace tconv_mma {

using mma_bf16::a_cols_at;
using mma_bf16::a_rows_at;
using mma_bf16::b_rows_at;
using mma_bf16::bf16;
using mma_bf16::bf162;
using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait_all;
using mma_bf16::cp_async_wait_one;
using mma_bf16::lane_group_sum;
using mma_bf16::ldsm_x4;
using mma_bf16::ldsm_x4_trans;
using mma_bf16::mma;
using mma_bf16::rows_aligned;

using tconv::HALO;
using tconv::KS;
using tconv::V;

constexpr int HALO_ROWS = HALO * V;    // 100
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Stage columns [c0, c0 + COLS) of rows r < rows into dst_row(r): src_row(r)
// is the row's start in device memory, or nullptr for a row of zeros;
// columns at or past c are zeros. aligned (16-byte aligned rows, c and c0
// multiples of 8): by cp.async in 16-byte groups, which the caller commits
// and waits for; else by 32-bit loads (c and c0 even), at once. any: a
// valid device address (a zero-filled group reads nothing from it).
template <int COLS, typename Src, typename Dst>
__device__ __forceinline__ void stage_rows(int rows, Src src_row, Dst dst_row,
                                           int c0, int c, bool aligned,
                                           const bf16* any, int tid) {
  if (aligned) {
    constexpr int G = COLS / 8;
    for (int i = tid; i < rows * G; i += THREADS) {
      const int r = i / G, k = (i % G) * 8;
      const bf16* src = src_row(r);
      const bool ok = src != nullptr && c0 + k < c;
      cp_async16(dst_row(r) + k, ok ? src + c0 + k : any, ok);
    }
  } else {
    constexpr int P = COLS / 2;
    for (int i = tid; i < rows * P; i += THREADS) {
      const int r = i / P, k = (i % P) * 2;
      const bf16* src = src_row(r);
      bf162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (src != nullptr && c0 + k < c)
        v = *reinterpret_cast<const bf162*>(src + c0 + k);
      *reinterpret_cast<bf162*>(dst_row(r) + k) = v;
    }
  }
}

// h = relu(s * scale + shift) rounded to bf16, in place, on the 8 staged
// elements at p; ss[e] = (scale, shift) of its channel e, (0, 0) past c
// (where the element is zero and stays so).
__device__ __forceinline__ void affine_relu8(bf16* p, const float2 (&ss)[8]) {
  uint4 raw = *reinterpret_cast<uint4*>(p);
  bf162* h = reinterpret_cast<bf162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(h[e]);
    f.x = fmaxf(tconv::affine(f.x, ss[2 * e].x, ss[2 * e].y), 0.f);
    f.y = fmaxf(tconv::affine(f.y, ss[2 * e + 1].x, ss[2 * e + 1].y), 0.f);
    h[e] = __floats2bfloat162_rn(f.x, f.y);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---------------------------------------------------------------------------
// The tile kernel: the forward (MODE_FWD) and the input gradient
// (MODE_DGRAD).

constexpr int MT = 512;                // rows per tile
constexpr int CT = 64;                 // output channels per tile
constexpr int CK = 32;                 // reduction channels per chunk
constexpr int LD = CK + 8;             // staged A or weight row, in bf16
constexpr int LDS = CT + 8;            // staged s row (input gradient)
constexpr int A_ROWS = MT + 2 * HALO_ROWS;
constexpr int A_ELEMS = A_ROWS * LD;
constexpr int STAGE_ELEMS = A_ELEMS + KS * CT * LD;
static_assert(MT * LDS <= STAGE_ELEMS, "the s tile fits a stage");
static_assert(MT == WARPS * 64, "a warp holds 64 rows");
static_assert(THREADS % (CK / 8) == 0, "a thread's A groups share channels");

struct TileSmem {
  bf16 stage[2][STAGE_ELEMS];  // A [row][k], then the weight [dt][n][k]; or
                               // the s tile [row][LDS]
  float red[2][WARPS][CT];     // [sum][warp][channel]
};

// Row tiles of a clip, and the partials of the two channel sums: one per
// (clip, row tile) and channel.
__host__ __device__ inline int row_tiles(int t_len) {
  return (t_len * V + MT - 1) / MT;
}
inline int tile_parts(int nm, int t_len) { return nm * row_tiles(t_len); }

// tconv::tile_kernel<MODE>'s function for bf16 operands, rounded to bf16
// where that file's header says, on the tensor cores. w: the bf16 weight
// operand [dt][j][k] (9, c, c): W[j, k, dt] in the forward, W[k, j, 8 - dt]
// in the input gradient.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    mma_tile_kernel(const bf16* __restrict__ in, const bf16* __restrict__ s_in,
                    const bf16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    float* __restrict__ partials, int nm, int t_len, int c) {
  constexpr bool FWD = MODE == tconv::MODE_FWD;
  extern __shared__ float4 smem4[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int clip_rows = t_len * V;
  const int rtiles = row_tiles(t_len);
  const int ctiles = (c + CT - 1) / CT;
  const int chunks = (c + CK - 1) / CK;
  const int per_tile = chunks + (FWD ? 0 : 1);  // + the s tile's step
  const int tiles = nm * rtiles * ctiles;
  const int my_tiles =
      (tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const int steps = my_tiles * per_tile;
  const bool aligned = c % 8 == 0 && rows_aligned(in, c) &&
                       rows_aligned(w, c) &&
                       (FWD || rows_aligned(s_in, c));

  // step -> its tile: row tile rt (clip rt / rtiles), rows r0.., channels
  // j0..; sub: its chunk, or chunks for the s tile
  struct Step {
    int rt, r0, j0, sub;
    size_t clip;
  };
  auto step_at = [&](int step) {
    Step st;
    const int t = int(blockIdx.x) + step / per_tile * int(gridDim.x);
    st.sub = step % per_tile;
    st.rt = t / ctiles;
    st.j0 = t % ctiles * CT;
    st.r0 = st.rt % rtiles * MT;
    st.clip = size_t(st.rt / rtiles) * clip_rows * c;
    return st;
  };

  auto stage = [&](int step) {
    const Step st = step_at(step);
    bf16* buf = sm.stage[step & 1];
    if (st.sub == chunks) {  // the input gradient's s tile
      stage_rows<CT>(
          MT,
          [&](int r) {
            const int gr = st.r0 + r;
            return gr < clip_rows ? s_in + st.clip + size_t(gr) * c
                                  : static_cast<const bf16*>(nullptr);
          },
          [&](int r) { return buf + r * LDS; }, st.j0, c, aligned, in, tid);
    } else {
      const int c0 = st.sub * CK;
      stage_rows<CK>(
          A_ROWS,
          [&](int r) {
            const int gr = st.r0 - HALO_ROWS + r;
            return gr >= 0 && gr < clip_rows
                       ? in + st.clip + size_t(gr) * c
                       : static_cast<const bf16*>(nullptr);
          },
          [&](int r) { return buf + r * LD; }, c0, c, aligned, in, tid);
      stage_rows<CK>(
          KS * CT,
          [&](int r) {
            const int j = st.j0 + r % CT;
            return j < c ? w + (size_t(r / CT) * c + j) * c
                         : static_cast<const bf16*>(nullptr);
          },
          [&](int r) { return buf + A_ELEMS + r * LD; }, c0, c, aligned, in,
          tid);
    }
    cp_async_commit();
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the epilogue's sums of this lane's two channels of n8 tile nt, met
  // across the lanes of a column and the warps, into the tile's partials
  auto reduce_sums = [&](const Step& st) {
    __syncthreads();
    if (tid < 2 * CT) {
      const int which = tid / CT, jl = tid % CT;
      if (st.j0 + jl < c) {
        float total = 0.f;
        for (int r = 0; r < WARPS; ++r) total += sm.red[which][r][jl];
        partials[(size_t(st.rt) * 2 + which) * c + st.j0 + jl] = total;
      }
    }
  };
  auto put_sums = [&](int nt, const float (&s0)[2], const float (&s1)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = lane_group_sum(s0[e]), a1 = lane_group_sum(s1[e]);
      if (g == 0) {
        sm.red[0][warp][nt * 8 + 2 * q + e] = a0;
        sm.red[1][warp][nt * 8 + 2 * q + e] = a1;
      }
    }
  };

  if (steps > 0) stage(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      stage(step + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const Step st = step_at(step);
    bf16* buf = sm.stage[step & 1];
    if (st.sub < chunks) {
      const int c0 = st.sub * CK;
      if (FWD) {  // h = relu(s * scale + shift) on the rows of the clip
        // (THREADS is a multiple of CK / 8: a thread's channels are fixed)
        const int kl = tid % (CK / 8) * 8, k = c0 + kl;
        if (k < c) {
          float2 ss[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            ss[e] = k + e < c ? make_float2(__ldg(scale + k + e),
                                            __ldg(shift + k + e))
                              : make_float2(0.f, 0.f);
          for (int i = tid; i < A_ROWS * (CK / 8); i += THREADS) {
            const int gr = st.r0 - HALO_ROWS + i / (CK / 8);
            if (gr >= 0 && gr < clip_rows)
              affine_relu8(buf + i / (CK / 8) * LD + kl, ss);
          }
        }
        __syncthreads();
      }
      const bf16* a = buf;
      const bf16* wb = buf + A_ELEMS;
#pragma unroll 1
      for (int dt = 0; dt < KS; ++dt) {
#pragma unroll
        for (int kk = 0; kk < CK; kk += 16) {
          if (c0 + kk >= c) break;  // zeros past c
          unsigned af[4][4], bfr[4][4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            ldsm_x4(af[mt],
                    a_rows_at(a, LD, warp * 64 + mt * 16 + dt * V, kk, lane));
#pragma unroll
          for (int np = 0; np < 4; ++np)
            ldsm_x4(bfr[np], b_rows_at(wb + dt * CT * LD, LD, np * 16, kk,
                                       lane));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              mma(acc[mt][nt], af[mt], bfr[nt / 2][(nt % 2) * 2],
                  bfr[nt / 2][(nt % 2) * 2 + 1]);
        }
      }
    }
    const bool last = FWD ? st.sub == chunks - 1 : st.sub == chunks;
    if (last) {
      // epilogue: the output, and this lane's part of the channel sums of
      // channels nt * 8 + 2 q + e
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
        const int j = st.j0 + nt * 8 + 2 * q;  // c is even: j + 1 < c too
        if (j < c) {
          // bias (forward); scale, shift (input gradient)
          float2 p0, p1 = make_float2(0.f, 0.f);
          if (FWD) {
            p0 = make_float2(bias[j], bias[j + 1]);
          } else {
            p0 = make_float2(scale[j], scale[j + 1]);
            p1 = make_float2(shift[j], shift[j + 1]);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int lr = warp * 64 + mt * 16 + g + 8 * half;
              const int gr = st.r0 + lr;
              if (gr >= clip_rows) continue;
              bf162* o = reinterpret_cast<bf162*>(out + st.clip +
                                                  size_t(gr) * c + j);
              const float v0 = acc[mt][nt][2 * half];
              const float v1 = acc[mt][nt][2 * half + 1];
              if (FWD) {
                const bf162 u = __floats2bfloat162_rn(v0 + p0.x, v1 + p0.y);
                *o = u;
                const float2 r = __bfloat1622float2(u);
                s0[0] += r.x;
                s0[1] += r.y;
                s1[0] += r.x * r.x;
                s1[1] += r.y * r.y;
              } else {
                const float2 sv = __bfloat1622float2(
                    *reinterpret_cast<const bf162*>(buf + lr * LDS + nt * 8 +
                                                    2 * q));
                const float g0 =
                    tconv::affine(sv.x, p0.x, p1.x) > 0.f ? v0 : 0.f;
                const float g1 =
                    tconv::affine(sv.y, p0.y, p1.y) > 0.f ? v1 : 0.f;
                *o = __floats2bfloat162_rn(g0 * p0.x, g1 * p0.y);
                s0[0] += g0 * sv.x;
                s0[1] += g1 * sv.y;
                s1[0] += g0;
                s1[1] += g1;
              }
            }
        }
        put_sums(nt, s0, s1);
      }
      reduce_sums(st);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    __syncthreads();  // this stage is consumed before stage(step + 2)
  }
}

template <int MODE>
cudaError_t launch_tile(const bf16* in, const bf16* s_in, const bf16* w,
                        const float* scale, const float* shift,
                        const float* bias, bf16* out, float* partials, int nm,
                        int t_len, int c, cudaStream_t stream) {
  const int smem = int(sizeof(TileSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mma_tile_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles = tile_parts(nm, t_len) * ((c + CT - 1) / CT);
  mma_tile_kernel<MODE>
      <<<mma_bf16::persistent_blocks(1, tiles), THREADS, smem, stream>>>(
          in, s_in, w, scale, shift, bias, out, partials, nm, t_len, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The weight and bias gradients.

constexpr int RC = 256;                          // rows per chunk
constexpr int WG_CO = 64;                        // output channels per block
constexpr int WG_CI = 64;                        // input channels per block
constexpr int LDW = 64 + 8;                      // staged gue or h row
constexpr int H_RING = 2 * RC + 2 * HALO_ROWS;   // rows of the h ring
// 0x3f80: bf16 1.0, twice: the B fragment of a column of ones (dbias)
constexpr unsigned ONES = 0x3f803f80u;
static_assert(THREADS % (WG_CI / 8) == 0, "a thread's h groups share channels");

struct WgradSmem {
  bf16 g[2][RC * LDW];       // gue [row][co], two stages
  bf16 h[H_RING * LDW];      // h [stream row % H_RING][ci]
  float bias_red[4][WG_CO];  // dbias of the warps of each input quarter
  float2 affine[WG_CI];      // (scale, shift) of the block's input channels
};

// ws: [split][9 * c * c + c], as tconv_bwd.cu's wgrad_kernel; a split is
// the clips [nm * split / splits, nm * (split + 1) / splits). A split's
// stream: clip i's row r is row i * (clip_rows + 100) + r; the rows between
// are zero. gue's stream row p meets h's stream row p + 25 dt in tap dt, h's
// stream running 100 rows behind (its row q is position q - 100).
__global__ void __launch_bounds__(THREADS, 1)
    mma_wgrad_kernel(const bf16* __restrict__ s, const bf16* __restrict__ gue,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ ws,
                     int nm, int t_len, int c) {
  extern __shared__ float4 smem4[];
  WgradSmem& sm = *reinterpret_cast<WgradSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 2, wn = warp / 2;  // 32 co, 16 ci each
  const int split = blockIdx.x, splits = gridDim.x;
  const int o0 = blockIdx.y * WG_CO, i0 = blockIdx.z * WG_CI;
  const int clip_rows = t_len * V;
  const int period = clip_rows + HALO_ROWS;
  const int n_begin = int(static_cast<long long>(nm) * split / splits);
  const int n_end = int(static_cast<long long>(nm) * (split + 1) / splits);
  const int clips = n_end - n_begin;
  const int chunks = (clips * period - HALO_ROWS + RC - 1) / RC;
  const bool bias_block = blockIdx.z == 0;
  const bool aligned =
      c % 8 == 0 && rows_aligned(s, c) && rows_aligned(gue, c);

  for (int i = tid; i < WG_CI; i += THREADS) {
    const int k = i0 + i;
    sm.affine[i] = k < c ? make_float2(scale[k], shift[k])
                         : make_float2(0.f, 0.f);
  }

  // the start of the clip row at stream position u, or nullptr (a zero row)
  auto row_at = [&](const bf16* base, int u) {
    if (u < 0) return static_cast<const bf16*>(nullptr);
    const int i = u / period, r = u % period;
    return i < clips && r < clip_rows
               ? base + (size_t(n_begin + i) * clip_rows + r) * c
               : static_cast<const bf16*>(nullptr);
  };
  // h's stream rows staged with chunk i: [h_lo(i), (i + 1) RC + 200)
  auto h_lo = [](int i) { return i == 0 ? 0 : i * RC + 2 * HALO_ROWS; };

  auto stage = [&](int i) {
    bf16* gb = sm.g[i & 1];
    stage_rows<WG_CO>(
        RC, [&](int r) { return row_at(gue, i * RC + r); },
        [&](int r) { return gb + r * LDW; }, o0, c, aligned, gue, tid);
    const int lo = h_lo(i);
    stage_rows<WG_CI>(
        (i + 1) * RC + 2 * HALO_ROWS - lo,
        [&](int r) { return row_at(s, lo + r - HALO_ROWS); },
        [&](int r) { return sm.h + (lo + r) % H_RING * LDW; }, i0, c,
        aligned, s, tid);
    cp_async_commit();
  };

  float acc[KS][2][2][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][mi][ni][e] = 0.f;
  // dbias as gue^T times a column of ones on the tensor cores, the row
  // steps dealt out to the four input quarters (wn) in turn
  float accb[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) accb[mi][e] = 0.f;
  // this lane's ldmatrix row of a 16-row step, and its column offset
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_col = wn * 16 + ((lane >> 4) << 3);

  if (chunks > 0) stage(0);
  for (int i = 0; i < chunks; ++i) {
    if (i + 1 < chunks) {
      stage(i + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    // h = relu(s * scale + shift) on the new rows of the clips (THREADS
    // is a multiple of WG_CI / 8: a thread's channels are fixed)
    const int lo = h_lo(i), n_new = (i + 1) * RC + 2 * HALO_ROWS - lo;
    const int kl = tid % (WG_CI / 8) * 8;
    if (i0 + kl < c) {
      float2 ss[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) ss[e] = sm.affine[kl + e];
      for (int j = tid; j < n_new * (WG_CI / 8); j += THREADS) {
        const int r = j / (WG_CI / 8);
        if (row_at(s, lo + r - HALO_ROWS) != nullptr)
          affine_relu8(sm.h + (lo + r) % H_RING * LDW + kl, ss);
      }
    }
    __syncthreads();
    const bf16* gb = sm.g[i & 1];
#pragma unroll 1
    for (int kk = 0; kk < RC; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_trans(af[mi], a_cols_at(gb, LDW, wm * 32 + mi * 16, kk, lane));
      if (bias_block && ((kk >> 4) & 3) == wn) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(accb[mi], af[mi], ONES, ONES);
      }
      const int row0 = (i * RC + kk + b_row) % H_RING;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        int row = row0 + dt * V;
        if (row >= H_RING) row -= H_RING;
        unsigned bfr[4];
        ldsm_x4_trans(bfr, sm.h + row * LDW + b_col);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            mma(acc[dt][mi][ni], af[mi], bfr[2 * ni], bfr[2 * ni + 1]);
      }
    }
    __syncthreads();  // this stage is consumed before stage(i + 2)
  }

  const size_t n_w = size_t(KS) * c * c;
  float* pw = ws + size_t(split) * (n_w + c);
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = o0 + wm * 32 + mi * 16 + g + 8 * (e / 2);
          const int ci = i0 + wn * 16 + ni * 8 + 2 * q + e % 2;
          if (o < c && ci < c)
            pw[(size_t(o) * c + ci) * KS + dt] = acc[dt][mi][ni][e];
        }
  if (bias_block) {  // every column of accb holds its row's sum
    if (q == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        sm.bias_red[wn][wm * 32 + mi * 16 + g] = accb[mi][0];
        sm.bias_red[wn][wm * 32 + mi * 16 + g + 8] = accb[mi][2];
      }
    }
    __syncthreads();
    if (tid < WG_CO && o0 + tid < c) {
      float total = 0.f;
      for (int r = 0; r < 4; ++r) total += sm.bias_red[r][tid];
      pw[n_w + o0 + tid] = total;
    }
  }
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
