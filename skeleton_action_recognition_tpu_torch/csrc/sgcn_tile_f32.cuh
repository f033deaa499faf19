// The f32 kernels of the fused spatial graph conv, on the CUDA cores (never
// TF32): the forward and its statistics entry (sgcn_fwd.cu, kernels #1 and
// #2) and the backward's dx and dW/db kernels (sgcn_bwd.cu, kernel #3). The
// f32 counterpart of mma_bf16.cuh, which serves the bf16 entries.
//
// What bounds them on the H100: in f32 with TF32 off every product runs on
// the CUDA cores (67 TFLOP/s), and at the model's widths each is a GEMM of
// ~3 * 25 * C FLOP per byte of its operands: operations, not bytes. So what
// sets their time is how many instructions other than FFMAs a warp issues:
// shared-memory loads, staging, the adjacency contraction, barriers. Each
// product is a register-blocked tile: a thread holds an 8 x 8 block of f32
// accumulators, rows {4 tm .. 4 tm + 3, M/2 + 4 tm .. + 3} (or, in the
// forward, tm + 16 i) and columns {4 tn .. 4 tn + 3, N/2 + 4 tn .. + 3}, and
// reads 4 float4s of its operands from shared memory per 64 FFMAs; a
// warp's lanes are 8 (m) x 4 (n), so a float4 load of a warp reads 128 or
// 64 contiguous bytes. The depth arrives in chunks by cp.async while the
// previous chunk multiplies (stage_rows: a few instructions a 16-byte
// copy). At most 168 registers a thread, none spilled.
//
//   forward (fwd_kernel<STATS>): z = x W^T + b over a tile of 5 frames (125
//     rows, padded to 128) x 96 columns (k, o) of 32 output channels, depth
//     C_in in chunks of 16, three in flight. x is staged as it lies,
//     [row][c], and a thread reads a float4 of each of its 8 strided rows
//     for 4 steps of the depth (fma_rows); W arrives transposed once a call
//     by the wrapper, (C_in, 3 C_out), and is staged as it lies. z + b goes
//     to shared memory, and out_f = A^T z_f per frame walks each column's
//     nonzero A[k, v, w] (73 of the 1,875 at the model's graph). With STATS
//     the epilogue sums the stored values per channel in a fixed order into
//     one partial per frame tile, summed by channel_sums.cuh. Persistent,
//     two blocks an SM of 6 warps.
//   dx (dx_kernel<NARROW>): dx = dz W over a tile of 5 frames x 64 input
//     channels, depth 3 C_out in chunks of 16 output channels (48 (k, o)).
//     W's chunk (already [(k, o)][i]) is staged before the previous chunk's
//     dz, g's after it; dz is computed once per tile and chunk from the
//     staged g into [(k, o)][row]. Persistent, three blocks an SM of 4
//     warps; the input channel tiles of a frame tile run at once on
//     neighbouring blocks and share g in L2.
//   dW/db (dw_kernel<NARROW>): dW = dz^T x over 192 (k, o) of 64 output
//     channels x 64 input channels, depth the rows of a fixed split of the
//     frames, in chunks of 2 frames (50 rows). x's chunk is staged before
//     the previous chunk's dz, g's after it; dz goes to [row][(k, o)]; db is
//     summed from it by the threads that compute it (each owns the same
//     (k, v, 4 channels) in every chunk), in shared memory. Each split
//     writes its partial to a workspace, summed in a fixed order by
//     channel_sums.cuh: no float atomics. One wave of two blocks an SM.
// dz[f, k, v, o] = sum_w A[k, v, w] g[f, w, o] walks each row's nonzero A
// (listed once a block, from A staged whole). Rows of C_in = 3 (12 bytes)
// or of an odd width are staged by 4-byte copies, and C_in <= 4 takes the
// backward's NARROW instances (a thread a row, 4 columns), where 8 x 8
// blocks would waste 20x the products. Every sum is taken in an order fixed
// by the shapes alone, so two launches give bit-identical results.
//
// On an H100 (scripts/torch_sgcn_bench.py, probes of patched builds) the
// products reach ~55-60% of the FFMA peak with the staging taken out; the
// staging costs ~10%, the backward's dz ~8% each in dx and dW.

#pragma once

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace sgcn_f32 {

constexpr int V = 25;        // NTU RGB+D joints
constexpr int K = 3;         // spatial partitions
constexpr int KV = K * V;
constexpr int MF = 5;        // frames of a row tile
constexpr int MROWS = MF * V;  // its 125 rows (f, v)
constexpr int BM = 128;      // rows, padded
constexpr int LDM = BM + 4;  // a [depth][row] operand's row stride

// Threads of an M x N tile of 8 x 8 blocks, and the warps along m.
template <int M, int N>
struct Grid {
  static constexpr int TMT = M / 8, TNT = N / 8;
  static constexpr int THREADS = TMT * TNT;
  static constexpr int WM = TMT / 8;
  static_assert(TMT % 8 == 0 && TNT % 4 == 0, "8 x 4 lanes a warp");
};

// This thread's place in the tile: tm, tn, and wn, its warp's index along n
// (the warp's columns are 16 wn .. 16 wn + 15 and N/2 + the same).
template <int M, int N>
struct Place {
  int tm, tn, wn;
  __device__ __forceinline__ explicit Place(int tid) {
    const int warp = tid / 32, lane = tid % 32;
    tm = (warp % Grid<M, N>::WM) * 8 + lane % 8;
    wn = warp / Grid<M, N>::WM;
    tn = wn * 4 + lane / 8;
  }
  // row i < 8 and column quad h < 2 of the thread's block
  __device__ __forceinline__ int row(int i) const {
    return (i < 4 ? 0 : M / 2) + 4 * tm + i % 4;
  }
  __device__ __forceinline__ int col(int h) const {
    return h * (N / 2) + 4 * tn;
  }
  // row i of the block of fma_rows: strided, tm + M / 8 * i
  __device__ __forceinline__ int strided_row(int i) const {
    return tm + M / 8 * i;
  }
};

// acc[i][j] += sum_d a[d][row(i)] b[d][col(j)] for d < depth, in d order.
template <int M, int N>
__device__ __forceinline__ void fma_tile(float (&acc)[8][8],
                                         const float* __restrict__ a,
                                         int lda, const float* __restrict__ b,
                                         int ldb, int depth,
                                         const Place<M, N>& p) {
  a += 4 * p.tm;
  b += 4 * p.tn;
#pragma unroll 2
  for (int d = 0; d < depth; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + d * lda);
    const float4 a1 = *reinterpret_cast<const float4*>(a + d * lda + M / 2);
    const float4 b0 = *reinterpret_cast<const float4*>(b + d * ldb);
    const float4 b1 = *reinterpret_cast<const float4*>(b + d * ldb + N / 2);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The same with a stored [m][d] (row stride lda = 4 mod 8: the 8 rows m
// a warp reads at once fall in distinct banks) and the thread's rows
// strided_row(i): a float4 of a row covers 4 steps of d, so the depth is a
// multiple of 4.
template <int M, int N>
__device__ __forceinline__ void fma_rows(float (&acc)[8][8],
                                         const float* __restrict__ a,
                                         int lda, const float* __restrict__ b,
                                         int ldb, int depth,
                                         const Place<M, N>& p) {
  a += p.tm * lda;
  b += 4 * p.tn;
#pragma unroll 1
  for (int d = 0; d < depth; d += 4) {
    float4 ar[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      ar[i] = *reinterpret_cast<const float4*>(a + i * (M / 8) * lda + d);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 b0 = *reinterpret_cast<const float4*>(b + (d + dd) * ldb);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + (d + dd) * ldb + N / 2);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = dd == 0   ? ar[i].x
                         : dd == 1 ? ar[i].y
                         : dd == 2 ? ar[i].z
                                   : ar[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// 4 bytes from global to shared memory, asynchronously; zero where !valid
// (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma_bf16::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, ROWS) and columns [0, COLS) of the row-major matrix src (row
// stride ld; rows < n_rows and columns < n_cols hold data) into dst[r * lds
// + c], zero elsewhere, by cp.async, which the caller commits and waits
// for: 16-byte copies where aligned (ld and n_cols multiples of 4, src
// 16-byte aligned), else 4-byte ones. A thread's 16-byte groups lie in one
// column, THREADS / (COLS / 4) rows apart: its pointers step by a constant,
// a few instructions a copy (the staging is a tenth of a chunk's issue
// slots otherwise).
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, int lds,
                                           const float* src, int ld,
                                           int n_rows, int n_cols,
                                           bool aligned, int tid) {
  if (aligned) {
    constexpr int G = COLS / 4, STEP = THREADS / G;
    static_assert(COLS % 4 == 0 && THREADS % G == 0,
                  "a thread's groups in one column");
    const int c = 4 * (tid % G);
    const bool c_ok = c < n_cols;
    int r = tid / G;
    float* d = dst + r * lds + c;
    const float* s = src + size_t(r) * ld + c;
#pragma unroll
    for (int i = 0; i < (ROWS + STEP - 1) / STEP; ++i) {
      if (ROWS % STEP != 0 && r >= ROWS) break;
      const bool ok = c_ok && r < n_rows;
      mma_bf16::cp_async16(d, ok ? s : src, ok);
      r += STEP;
      d += STEP * lds;
      s += size_t(STEP) * ld;
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const bool ok = r < n_rows && c < n_cols;
      cp_async4(dst + r * lds + c, ok ? src + size_t(r) * ld + c : src, ok);
    }
  }
}

// Four floats to dst: one float4 where vec (dst 16-byte aligned) and all
// four are in (n > 3), else the first min(n, 4) one by one.
__device__ __forceinline__ void store4(float* dst, int n, float4 v,
                                       bool vec) {
  if (vec && n > 3) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  if (n > 0) dst[0] = v.x;
  if (n > 1) dst[1] = v.y;
  if (n > 2) dst[2] = v.z;
  if (n > 3) dst[3] = v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// The nonzero A[k, v, w] of each row kv = k V + v, in w order (the
// backward's dz = A g).
struct RowLists {
  float val[KV][V];
  unsigned char w[KV][V];
  int n[KV];
};

// ... and of each column w, in kv order (the forward's out = A^T z).
struct ColLists {
  float val[V][KV];
  unsigned char kv[V][KV];
  int n[V];
};

// The dense A (K, V, V) into shared memory, by all THREADS threads at once;
// the caller synchronises before listing it.
template <int THREADS>
__device__ __forceinline__ void stage_adjacency(const float* __restrict__ a,
                                                float* as, int tid) {
  for (int i = tid; i < KV * V; i += THREADS) as[i] = a[i];
}

// Threads 0..KV-1 list row kv of the staged A; the caller synchronises.
__device__ __forceinline__ void list_rows(const float* as, RowLists& l,
                                          int tid) {
  if (tid >= KV) return;
  int n = 0;
  for (int w = 0; w < V; ++w) {
    const float av = as[tid * V + w];
    if (av != 0.f) {
      l.val[tid][n] = av;
      l.w[tid][n] = static_cast<unsigned char>(w);
      ++n;
    }
  }
  l.n[tid] = n;
}

// Threads 0..V-1 list column w of the staged A; the caller synchronises.
__device__ __forceinline__ void list_cols(const float* as, ColLists& l,
                                          int tid) {
  if (tid >= V) return;
  int n = 0;
  for (int kv = 0; kv < KV; ++kv) {
    const float av = as[kv * V + tid];
    if (av != 0.f) {
      l.val[tid][n] = av;
      l.kv[tid][n] = static_cast<unsigned char>(kv);
      ++n;
    }
  }
  l.n[tid] = n;
}

// dz[f][4 oq .. 4 oq + 3] of row kv for the frames f < FRAMES of the staged
// g chunk (row stride ldg), summed over row kv's nonzero A in w order.
// Callers walk items (kv, oq) with oq fastest, so that the few rows with
// several nonzeros (4 of 25 joints' at most, at the model's graph) hold up
// one pass of one warp, not one lane of most.
template <int FRAMES>
__device__ __forceinline__ void dz_row(const RowLists& l, const float* gs,
                                       int ldg, int kv, int oq,
                                       float4 (&d)[FRAMES]) {
#pragma unroll
  for (int f = 0; f < FRAMES; ++f) d[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < l.n[kv]; ++j) {
    const float* gw = gs + l.w[kv][j] * ldg + 4 * oq;
    const float av = l.val[kv][j];
#pragma unroll
    for (int f = 0; f < FRAMES; ++f)
      fma4(d[f], av, *reinterpret_cast<const float4*>(gw + f * V * ldg));
  }
}

// The (tile, chunk) steps of a persistent block, in order: tiles
// blockIdx.x, + gridDim.x, ..., each of `chunks` chunks, tile t being
// (major, minor) = (t / n_minor, t % n_minor). Walk::next moves a Step on
// without a division (one costs ~20 instructions, a tenth of a short
// chunk's products).
struct Step {
  int major, minor, chunk;
};

struct Walk {
  int n_minor, chunks, step_major, step_minor;

  __device__ __forceinline__ Walk(int n_minor_, int chunks_)
      : n_minor(n_minor_),
        chunks(chunks_),
        step_major(int(gridDim.x) / n_minor_),
        step_minor(int(gridDim.x) % n_minor_) {}
  __device__ __forceinline__ Step first() const {
    return Step{int(blockIdx.x) / n_minor, int(blockIdx.x) % n_minor, 0};
  }
  __device__ __forceinline__ void next(Step& s) const {
    if (++s.chunk < chunks) return;
    s.chunk = 0;
    next_tile(s);
  }
  __device__ __forceinline__ void next_tile(Step& s) const {
    s.major += step_major;
    s.minor += step_minor;
    if (s.minor >= n_minor) {
      s.minor -= n_minor;
      ++s.major;
    }
  }
};

// ---------------------------------------------------------------------------
// Forward: out = A^T (x W^T + b) per frame, and with STATS the channel sums.

constexpr int FWD_CO = 32;           // output channels of a tile
constexpr int FWD_N = K * FWD_CO;    // its 96 columns (k, o)
constexpr int FWD_KC = 16;           // input channels of a chunk
constexpr int FWD_LDX = FWD_KC + 4;  // staged x row
constexpr int FWD_LDW = FWD_N + 4;   // staged W^T row
using FwdGrid = Grid<BM, FWD_N>;
constexpr int FWD_THREADS = FwdGrid::THREADS;  // 192
constexpr int FWD_BLOCKS = 2;                  // blocks an SM
constexpr int FWD_STAGES = 3;                  // chunk stages

struct FwdSmem {
  float x[FWD_STAGES][BM * FWD_LDX];      // x chunk [row][c]
  float w[FWD_STAGES][FWD_KC * FWD_LDW];  // W^T chunk [c][k * FWD_CO + o]
  float z[MF * KV * FWD_CO];     // z + b [f][k * V + v][o]; first, dense A
  float bias[FWD_N];             // b[k][o]
  float red[2][V][FWD_CO];       // the stats epilogue's per-joint sums
  ColLists cols;
};

// Persistent: block b takes tiles b, b + grid, ...; tile t is frame tile
// t / co_tiles and output channel tile t % co_tiles, so that the blocks at
// work at once share x in L2. The chunks of a block's tiles form one
// stream: the next tile's first chunk loads while this tile's epilogue
// runs. wt is the weight transposed, (C_in, K * C_out). With STATS,
// partials[frame tile][0 or 1][c_out] gets the tile's sums of out and out^2.
template <bool STATS>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS)
    fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ b, const float* __restrict__ a,
               float* __restrict__ out, float* __restrict__ partials,
               int frames, int c_in, int c_out) {
  extern __shared__ float4 smem4[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem4);
  const int tid = threadIdx.x;
  const Place<BM, FWD_N> p(tid);
  const int co_tiles = (c_out + FWD_CO - 1) / FWD_CO;
  const int tiles = (frames + MF - 1) / MF * co_tiles;
  const int chunks = (c_in + FWD_KC - 1) / FWD_KC;
  const int my_tiles = (tiles - int(blockIdx.x) + int(gridDim.x) - 1) /
                       int(gridDim.x);
  const int steps = my_tiles * chunks;
  const bool x_aligned = c_in % 4 == 0 && aligned16(x);
  const bool w_aligned = c_out % 4 == 0 && aligned16(wt);
  const bool vec = c_out % 4 == 0 && aligned16(out);
  // tiles (frame tile, output channel tile): sc the next step staged
  const Walk walk(co_tiles, chunks);
  Step sc = walk.first();
  int staged = 0;
  // one commit group a step, empty past the last, so that waiting for all
  // but the newest FWD_STAGES - 2 groups means the next chunk is in
  auto stage_next = [&]() {
    if (staged < steps) {
      const int f0 = sc.major * MF, o0 = sc.minor * FWD_CO;
      const int c0 = sc.chunk * FWD_KC, buf = staged % FWD_STAGES;
      stage_rows<BM, FWD_KC, FWD_THREADS>(
          s.x[buf], FWD_LDX, x + size_t(f0) * V * c_in + c0, c_in,
          min(MF, frames - f0) * V, c_in - c0, x_aligned, tid);
      for (int k = 0; k < K; ++k)
        stage_rows<FWD_KC, FWD_CO, FWD_THREADS>(
            s.w[buf] + k * FWD_CO, FWD_LDW,
            wt + size_t(c0) * K * c_out + k * c_out + o0, K * c_out,
            c_in - c0, min(FWD_CO, c_out - o0), w_aligned, tid);
      walk.next(sc);
    }
    ++staged;
    mma_bf16::cp_async_commit();
  };

  for (int i = 0; i < FWD_STAGES - 1; ++i) stage_next();
  stage_adjacency<FWD_THREADS>(a, s.z, tid);
  __syncthreads();
  list_cols(s.z, s.cols, tid);
  cp_async_wait<FWD_STAGES - 2>();
  __syncthreads();  // lists and the first chunk in place

  Step ct = walk.first();  // the tile computed
  for (int step = 0; step < steps; walk.next_tile(ct)) {
    const int index = ct.major, f0 = index * MF, n_f = min(MF, frames - f0);
    const int o0 = ct.minor * FWD_CO, n_o = min(FWD_CO, c_out - o0);
    for (int i = tid; i < FWD_N; i += FWD_THREADS) {  // read after a chunk
      const int o = i % FWD_CO;
      s.bias[i] = o < n_o ? b[(i / FWD_CO) * c_out + o0 + o] : 0.f;
    }
    {
      float acc[8][8];  // the tile's z, dead once stored
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < chunks; ++c, ++step) {
        const int buf = step % FWD_STAGES;
        stage_next();  // step + FWD_STAGES - 1, into the stage step - 1 left
        // zero-filled past c_in: a partial chunk runs to a multiple of 4
        const int depth = min(FWD_KC, (c_in - c * FWD_KC + 3) / 4 * 4);
        fma_rows(acc, s.x[buf], FWD_LDX, s.w[buf], FWD_LDW, depth, p);
        cp_async_wait<FWD_STAGES - 2>();
        __syncthreads();  // this chunk consumed, the next in place
      }
      // z + b: rows of the frames in, column quads of one k
      const int n_rows = n_f * V;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = p.strided_row(i);
        if (r >= n_rows) continue;
        const int f = r / V, v = r % V;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = p.col(h), k = n / FWD_CO, o = n % FWD_CO;
          *reinterpret_cast<float4*>(s.z + (f * KV + k * V + v) * FWD_CO +
                                     o) =
              make_float4(acc[i][4 * h] + s.bias[n],
                          acc[i][4 * h + 1] + s.bias[n + 1],
                          acc[i][4 * h + 2] + s.bias[n + 2],
                          acc[i][4 * h + 3] + s.bias[n + 3]);
        }
      }
    }
    __syncthreads();

    // out[f, w, o..o+3] = sum over column w's nonzeros of A[kv, w] z[f, kv]
    for (int e = tid; e < V * (FWD_CO / 4); e += FWD_THREADS) {
      const int wv = e / (FWD_CO / 4), o = 4 * (e % (FWD_CO / 4));
      float4 sum[MF];
#pragma unroll
      for (int f = 0; f < MF; ++f) sum[f] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < s.cols.n[wv]; ++j) {
        const float* zc = s.z + s.cols.kv[wv][j] * FWD_CO + o;
        const float av = s.cols.val[wv][j];
#pragma unroll
        for (int f = 0; f < MF; ++f)
          if (f < n_f)
            fma4(sum[f], av,
                 *reinterpret_cast<const float4*>(zc + f * KV * FWD_CO));
      }
      float4 s1 = make_float4(0.f, 0.f, 0.f, 0.f), s2 = s1;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        if (f >= n_f || o >= n_o) continue;
        store4(out + (size_t(f0 + f) * V + wv) * c_out + o0 + o, n_o - o,
               sum[f], vec);
        if (STATS) {  // channels past n_o are zero: W's rows and b are
          s1.x += sum[f].x;
          s1.y += sum[f].y;
          s1.z += sum[f].z;
          s1.w += sum[f].w;
          s2.x += sum[f].x * sum[f].x;
          s2.y += sum[f].y * sum[f].y;
          s2.z += sum[f].z * sum[f].z;
          s2.w += sum[f].w * sum[f].w;
        }
      }
      if (STATS) {
        *reinterpret_cast<float4*>(&s.red[0][wv][o]) = s1;
        *reinterpret_cast<float4*>(&s.red[1][wv][o]) = s2;
      }
    }
    if (!STATS) continue;
    __syncthreads();
    if (tid < 2 * FWD_CO) {  // the 25 joints' sums of a channel, in order
      const int which = tid / FWD_CO, o = tid % FWD_CO;
      if (o < n_o) {
        float total = 0.f;
        for (int wv = 0; wv < V; ++wv) total += s.red[which][wv][o];
        partials[(size_t(index) * 2 + which) * c_out + o0 + o] = total;
      }
    }
  }
}

// Blocks of fwd_kernel.
inline int fwd_blocks(int frames, int c_out) {
  return mma_bf16::persistent_blocks(
      FWD_BLOCKS, (frames + MF - 1) / MF * ((c_out + FWD_CO - 1) / FWD_CO));
}

// ---------------------------------------------------------------------------
// Backward, dx = dz W.

constexpr int NARROW_C_IN = 4;       // C_in of the backward's narrow paths
constexpr int DX_N = 64;             // input channels of a tile
constexpr int DX_OC = 16;            // output channels of a chunk
constexpr int DX_DEPTH = K * DX_OC;  // its 48 (k, o)
constexpr int DX_LDG = DX_OC + 4;    // staged g row
constexpr int DX_LDW = DX_N + 4;     // staged W row
using DxGrid = Grid<BM, DX_N>;
constexpr int DX_THREADS = DxGrid::THREADS;  // 128
constexpr int DX_BLOCKS = 3;                 // blocks an SM

struct DxSmem {
  float g[MROWS * DX_LDG];           // g chunk [row][o]
  float w[2][DX_DEPTH * DX_LDW];     // W chunk [k * DX_OC + o][i], two stages
  float dz[DX_DEPTH * LDM];          // dz chunk [k * DX_OC + o][row]; first,
                                     // dense A
  RowLists rows;
};

// dx's dz of row kv, channels 4 oq.., for FRAMES frames of the staged g
// chunk (row stride DX_LDG), into the [k * DX_OC + o][row] column col.
template <int FRAMES>
__device__ __forceinline__ void dz_store(const RowLists& l, const float* gs,
                                         int kv, int oq, float* col) {
  float4 d[FRAMES];
  dz_row(l, gs, DX_LDG, kv, oq, d);
#pragma unroll
  for (int f = 0; f < FRAMES; ++f) {
    col[f * V] = d[f].x;
    col[LDM + f * V] = d[f].y;
    col[2 * LDM + f * V] = d[f].z;
    col[3 * LDM + f * V] = d[f].w;
  }
}

// Persistent: block b takes tiles b, b + grid, ...; tile t is frame tile
// t / i_tiles and input channel tile t % i_tiles, so that the blocks at
// work at once share g in L2 (each input channel tile computes its own dz,
// 2 and 4 times a frame tile at C_in = 128 and 256). The (tile, chunk)
// steps of a block form one stream, as in the forward. NARROW (C_in <= 4,
// the first block's 3): a thread a row, 4 columns, in acc[0], in place of
// the 8 x 8 blocks, whose waste there would cost more than the product.
template <bool NARROW>
__global__ void __launch_bounds__(DX_THREADS, DX_BLOCKS)
    dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
              const float* __restrict__ a, float* __restrict__ dx,
              int frames, int c_in, int c_out) {
  static_assert(DX_THREADS == BM, "a thread a row where NARROW");
  extern __shared__ float4 smem4[];
  DxSmem& s = *reinterpret_cast<DxSmem*>(smem4);
  const int tid = threadIdx.x;
  const Place<BM, DX_N> p(tid);
  const int i_tiles = (c_in + DX_N - 1) / DX_N;
  const int tiles = (frames + MF - 1) / MF * i_tiles;
  const int chunks = (c_out + DX_OC - 1) / DX_OC;
  const int my_tiles = (tiles - int(blockIdx.x) + int(gridDim.x) - 1) /
                       int(gridDim.x);
  const int steps = my_tiles * chunks;
  const bool g_aligned = c_out % 4 == 0 && aligned16(g);
  const bool w_aligned = c_in % 4 == 0 && aligned16(w);
  const bool vec = c_in % 4 == 0 && aligned16(dx);
  // tiles (frame tile, input channel tile): sc the next step staged
  const Walk walk(i_tiles, chunks);
  Step sc = walk.first();
  // W's chunk into its stage, early (before the previous chunk's dz); g's
  // into its one buffer once that dz is done
  auto stage_w = [&](int buf) {
    const int i0 = sc.minor * DX_N, oc = sc.chunk * DX_OC;
    for (int k = 0; k < K; ++k)
      stage_rows<DX_OC, DX_N, DX_THREADS>(
          s.w[buf] + k * DX_OC * DX_LDW, DX_LDW,
          w + size_t(k * c_out + oc) * c_in + i0, c_in, c_out - oc,
          min(DX_N, c_in - i0), w_aligned, tid);
    mma_bf16::cp_async_commit();
  };
  auto stage_g = [&]() {
    const int f0 = sc.major * MF, oc = sc.chunk * DX_OC;
    stage_rows<MROWS, DX_OC, DX_THREADS>(
        s.g, DX_LDG, g + size_t(f0) * V * c_out + oc, c_out,
        min(MF, frames - f0) * V, c_out - oc, g_aligned, tid);
    mma_bf16::cp_async_commit();
    walk.next(sc);
  };

  if (steps > 0) {
    stage_w(0);
    stage_g();
  }
  stage_adjacency<DX_THREADS>(a, s.dz, tid);
  __syncthreads();
  list_rows(s.dz, s.rows, tid);
  mma_bf16::cp_async_wait_all();
  __syncthreads();  // lists and the first chunk in place

  Step ct = walk.first();  // the tile computed
  for (int step = 0; step < steps; walk.next_tile(ct)) {
    const int f0 = ct.major * MF, i0 = ct.minor * DX_N;
    const int n_i = min(DX_N, c_in - i0);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < chunks; ++c, ++step) {
      const int buf = step & 1;
      const bool more = step + 1 < steps;
      if (more) stage_w(buf ^ 1);  // step + 1's; consumed at step - 1
      // dz of the chunk, [k * DX_OC + o][row]; frames past the input's end
      // meet zero g
      for (int e = tid; e < KV * (DX_OC / 4); e += DX_THREADS) {
        const int kv = e / (DX_OC / 4), oq = e % (DX_OC / 4);
        float* col = s.dz + ((kv / V) * DX_OC + 4 * oq) * LDM + kv % V;
        // frames 0-2, then 3-4: fewer registers than all five at once
        dz_store<3>(s.rows, s.g, kv, oq, col);
        dz_store<MF - 3>(s.rows, s.g + 3 * V * DX_LDG, kv, oq, col + 3 * V);
      }
      __syncthreads();  // dz complete; g free
      if (more) stage_g();  // step + 1's, loads while this one multiplies
      if constexpr (NARROW) {
        const float* dzr = s.dz + tid;
        const float* wr = s.w[buf];
#pragma unroll 4
        for (int d = 0; d < DX_DEPTH; ++d) {
          const float dv = dzr[d * LDM];
          const float4 wv =
              *reinterpret_cast<const float4*>(wr + d * DX_LDW);
          acc[0][0] = fmaf(dv, wv.x, acc[0][0]);
          acc[0][1] = fmaf(dv, wv.y, acc[0][1]);
          acc[0][2] = fmaf(dv, wv.z, acc[0][2]);
          acc[0][3] = fmaf(dv, wv.w, acc[0][3]);
        }
      } else if (16 * p.wn < n_i) {
        fma_tile(acc, s.dz, LDM, s.w[buf], DX_LDW, DX_DEPTH, p);
      }
      if (more) mma_bf16::cp_async_wait_all();
      __syncthreads();  // dz and W[buf] consumed, the next chunk in place
    }

    const int n_rows = min(MF, frames - f0) * V;
    if constexpr (NARROW) {
      if (tid < n_rows)
        store4(dx + (size_t(f0) * V + tid) * c_in + i0, n_i,
               make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]),
               vec);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = p.row(i);
      if (r >= n_rows) continue;  // the padding rows and frames past the end
      float* drow = dx + (size_t(f0) * V + r) * c_in + i0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = p.col(h);
        if (n < n_i)
          store4(drow + n, n_i - n,
                 make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]),
                 vec);
      }
    }
  }
}

// Blocks of dx_kernel.
inline int dx_blocks(int frames, int c_in) {
  return mma_bf16::persistent_blocks(
      DX_BLOCKS, (frames + MF - 1) / MF * ((c_in + DX_N - 1) / DX_N));
}

// ---------------------------------------------------------------------------
// Backward, the splits' partials of dW = dz^T x and db = sum dz.

constexpr int DW_MF = 2;             // frames of a chunk
constexpr int DW_ROWS = DW_MF * V;   // its 50 rows
constexpr int DW_OC = 64;            // output channels of a block
constexpr int DW_M = K * DW_OC;      // its 192 rows (k, o) of dW
constexpr int DW_N = 64;             // input channels of a block
constexpr int DW_LDZ = DW_M + 4;
constexpr int DW_LDX = DW_N + 4;
constexpr int DW_LDG = DW_OC + 4;
using DwGrid = Grid<DW_M, DW_N>;
constexpr int DW_THREADS = DwGrid::THREADS;  // 192

struct DwSmem {
  float g[DW_ROWS * DW_LDG];      // g chunk [row][o]
  float x[2][DW_ROWS * DW_LDX];   // x chunk [row][i], two stages
  float dz[DW_ROWS * DW_LDZ];     // dz chunk [row][k * DW_OC + o]; first,
                                  // dense A
  float db[KV][DW_OC];            // db's sums by row kv
  RowLists rows;
};

// A block is (split blockIdx.x of the 2-frame chunks, output channel tile
// blockIdx.y of 64, input channel tile blockIdx.z of 64); ws_w[split] gets
// the split's partial dW, ws_b[split] its partial db (from the blocks of
// input channel tile 0). NARROW (C_in <= 4, the first block's 3): a thread
// a row m of dW, 4 columns, in acc[0], in place of the 8 x 8 blocks.
template <bool NARROW>
__global__ void __launch_bounds__(DW_THREADS, 2)
    dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ a, float* __restrict__ ws_w,
              float* __restrict__ ws_b, int frames, int c_in, int c_out) {
  static_assert(DW_THREADS == DW_M, "a thread a row of dW where NARROW");
  extern __shared__ float4 smem4[];
  DwSmem& s = *reinterpret_cast<DwSmem*>(smem4);
  const int tid = threadIdx.x;
  const Place<DW_M, DW_N> p(tid);
  const int split = blockIdx.x, splits = gridDim.x;
  const int o0 = blockIdx.y * DW_OC, i0 = blockIdx.z * DW_N;
  const int n_o = min(DW_OC, c_out - o0), n_i = min(DW_N, c_in - i0);
  const int chunks = (frames + DW_MF - 1) / DW_MF;
  const int c_begin = int(static_cast<long long>(chunks) * split / splits);
  const int c_end = int(static_cast<long long>(chunks) * (split + 1) / splits);
  const bool with_db = blockIdx.z == 0;
  const bool g_aligned = c_out % 4 == 0 && aligned16(g);
  const bool x_aligned = c_in % 4 == 0 && aligned16(x);
  // x's chunk into its stage, early (before the previous chunk's dz); g's
  // into its one buffer once that dz is done
  auto rows_of = [&](int chunk) {
    return min(DW_MF, frames - chunk * DW_MF) * V;
  };
  auto stage_x = [&](int chunk) {
    stage_rows<DW_ROWS, DW_N, DW_THREADS>(
        s.x[(chunk - c_begin) & 1], DW_LDX,
        x + size_t(chunk) * DW_ROWS * c_in + i0, c_in, rows_of(chunk), n_i,
        x_aligned, tid);
    mma_bf16::cp_async_commit();
  };
  auto stage_g = [&](int chunk) {
    stage_rows<DW_ROWS, DW_OC, DW_THREADS>(
        s.g, DW_LDG, g + size_t(chunk) * DW_ROWS * c_out + o0, c_out,
        rows_of(chunk), n_o, g_aligned, tid);
    mma_bf16::cp_async_commit();
  };

  if (c_begin < c_end) {
    stage_x(c_begin);
    stage_g(c_begin);
  }
  stage_adjacency<DW_THREADS>(a, s.dz, tid);
  if (with_db)
    for (int i = tid; i < KV * DW_OC; i += DW_THREADS) (&s.db[0][0])[i] = 0.f;
  __syncthreads();
  list_rows(s.dz, s.rows, tid);
  mma_bf16::cp_async_wait_all();
  __syncthreads();  // lists, db zeroed and the first chunk in place

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const bool more = c + 1 < c_end;
    if (more) stage_x(c + 1);  // x[buf ^ 1] was consumed at chunk c - 1
    // dz of the chunk, [row][k * DW_OC + o]: the same items a thread every
    // chunk, so that it alone adds to their db; rows past the input's end
    // meet zero g
    for (int e = tid; e < KV * (DW_OC / 4); e += DW_THREADS) {
      const int kv = e / (DW_OC / 4), oq = e % (DW_OC / 4);
      float4 d[DW_MF];
      dz_row(s.rows, s.g, DW_LDG, kv, oq, d);
      const int k = kv / V, v = kv % V;
#pragma unroll
      for (int f = 0; f < DW_MF; ++f)
        *reinterpret_cast<float4*>(s.dz + (f * V + v) * DW_LDZ + k * DW_OC +
                                   4 * oq) = d[f];
      if (with_db) {
        float4& sum = *reinterpret_cast<float4*>(&s.db[kv][4 * oq]);
#pragma unroll
        for (int f = 0; f < DW_MF; ++f) {
          sum.x += d[f].x;
          sum.y += d[f].y;
          sum.z += d[f].z;
          sum.w += d[f].w;
        }
      }
    }
    __syncthreads();  // dz complete; g free
    if (more) stage_g(c + 1);  // loads while this one multiplies
    if constexpr (NARROW) {
      const float* dzm = s.dz + tid;
      const float* xr = s.x[buf];
#pragma unroll 5
      for (int r = 0; r < DW_ROWS; ++r) {
        const float dv = dzm[r * DW_LDZ];
        const float4 xv = *reinterpret_cast<const float4*>(xr + r * DW_LDX);
        acc[0][0] = fmaf(dv, xv.x, acc[0][0]);
        acc[0][1] = fmaf(dv, xv.y, acc[0][1]);
        acc[0][2] = fmaf(dv, xv.z, acc[0][2]);
        acc[0][3] = fmaf(dv, xv.w, acc[0][3]);
      }
    } else if (16 * p.wn < n_i) {
      fma_tile(acc, s.dz, DW_LDZ, s.x[buf], DW_LDX, DW_ROWS, p);
    }
    if (more) mma_bf16::cp_async_wait_all();
    __syncthreads();  // dz and x[buf] consumed, the next chunk in place
  }

  float* pw = ws_w + size_t(split) * K * c_out * c_in;
  const bool vec = c_in % 4 == 0 && aligned16(ws_w);
  if (NARROW && tid % DW_OC < n_o)
    store4(pw + size_t(tid / DW_OC * c_out + o0 + tid % DW_OC) * c_in + i0,
           n_i, make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]),
           vec);
#pragma unroll
  for (int i = 0; i < 8 && !NARROW; ++i) {
    const int m = p.row(i), k = m / DW_OC, o = m % DW_OC;
    if (o >= n_o) continue;
    float* prow = pw + size_t(k * c_out + o0 + o) * c_in + i0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = p.col(h);
      if (n < n_i)
        store4(prow + n, n_i - n,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]),
               vec);
    }
  }
  if (!with_db) return;
  for (int m = tid; m < DW_M; m += DW_THREADS) {  // db's 25 rows, in order
    const int k = m / DW_OC, o = m % DW_OC;
    if (o >= n_o) continue;
    float total = 0.f;
    for (int v = 0; v < V; ++v) total += s.db[k * V + v][o];
    ws_b[size_t(split) * K * c_out + k * c_out + o0 + o] = total;
  }
}

inline dim3 dw_grid(int splits, int c_in, int c_out) {
  return dim3(splits, (c_out + DW_OC - 1) / DW_OC,
              (c_in + DW_N - 1) / DW_N);
}

}  // namespace sgcn_f32
