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
// device memory set the pace, so the unfused bf16 layer is bound by
// device-memory bytes. In f32 with TF32 off the unfused GEMM runs on the CUDA
// cores, whose ridge is ~67 TFLOP/s / 3.35 TB/s = ~20 FLOP/B, so both paths
// are bound by CUDA-core FLOPs there, and the kernel gains only where the z
// traffic and the adjacency bmm weigh most (small C_in). This kernel keeps z
// in shared memory: each frame's x is read once and its output written once
// (4x fewer bytes). It computes on the CUDA cores (67 TFLOP/s f32), not the
// tensor cores, so that FLOP rate is its own limit; wgmma is later work.
//
// Design: one thread block per (FRAMES frames, CO_TILE output channels);
// thread (f, o) owns frame f and output channel o.
//   1. Each block lists, per output joint w, the nonzero A[k, v, w] (a
//      handful of the K * V entries of a column).
//   2. Thread (f, o) keeps z[f, k, v, o] for all k, v in 75 registers and
//      loops over C_in in chunks of 32. Each chunk of x (coalesced along
//      C_in, read as float4) and of W (coalesced along C_in, stored
//      transposed so a warp reads it along o) is staged in shared memory.
//   3. z + b is written to shared memory over the chunks' place (rounded to
//      bf16 first for bf16 inputs, as the TPU kernel rounds z to its matmul
//      type).
//   4. Thread (f, o) sums, for each w, its column's listed A[k, v, w] times
//      z[f, k, v, o], and writes out[f, w, o] in x's dtype.
// A and W are rounded to x's dtype on load, as the TPU kernel casts them to
// its matmul type. All sums are f32.
//
// The stats entry points (sgcn_fwd_stats_*) also replace the TPU kernel
// _fwd_stats_kernel (make_fused_graph_conv with with_stats=True): the
// epilogue sums, per output channel, the output and its square over every
// (frame, joint) row, in f32 and on the value rounded to x's dtype (what a
// BatchNorm reading out back would see). The two threads of a channel meet
// in shared memory, each block writes its partial to a workspace, and
// channel_sums.cuh adds the partials in a fixed order: no float atomics, so
// repeats are bit-identical. The epilogue adds two FMAs per output element
// and 8 bytes of workspace per (block, channel), against the 50 output
// values (FRAMES = 2 frames of 25 joints) the block writes for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "channel_sums.cuh"

namespace {

constexpr int V = 25;        // NTU RGB+D joints
constexpr int K = 3;         // spatial partitions
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
constexpr int MAX_NNZ = K * V;  // nonzeros a column of A can hold
static_assert(K * V * V <= REGION, "A is staged in the chunk region");

struct Smem {
  float region[REGION];         // dense A, then the x and W chunks, then z
  float bias[K * CO_TILE];      // b[k][o]
  float a_val[V][MAX_NNZ];      // nonzero A[k, v, w] of column w
  unsigned char a_kv[V][MAX_NNZ];  // their k * V + v
  int a_nnz[V];
  float red[2][THREADS];        // the stats epilogue's per-thread sums
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to T's precision and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// With STATS, partials[blockIdx.x][0 or 1][c_out] gets the block's sums of
// out and out^2 over its frames.
template <typename T, bool STATS>
__global__ void __launch_bounds__(THREADS)
    sgcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ a,
                    T* __restrict__ out, float* __restrict__ partials,
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
  for (int i = tid; i < K * V * V; i += THREADS) s.region[i] = round_to<T>(a[i]);
  __syncthreads();
  if (tid < V) {  // thread w lists column w
    int n = 0;
    for (int kv = 0; kv < K * V; ++kv) {
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
  const T* xg = x + size_t(f0) * V * c_in;
  for (int c0 = 0; c0 < c_in; c0 += C_CHUNK) {
    __syncthreads();  // dense A listed / previous chunk consumed
    for (int i = tid; i < X_FLOATS; i += THREADS) {
      const int row = i / C_CHUNK, c = c0 + i % C_CHUNK;
      xs[i] = (row < n_f * V && c < c_in)
                  ? to_float(xg[size_t(row) * c_in + c])
                  : 0.f;
    }
    for (int i = tid; i < C_CHUNK * K * CO_TILE; i += THREADS) {
      const int j = i / C_CHUNK, cl = i % C_CHUNK;  // j = k * CO_TILE + o
      const int row_o = o0 + j % CO_TILE;
      const int c = c0 + cl;
      ws[cl * W_STRIDE + j] =
          (row_o < c_out && c < c_in)
              ? round_to<T>(
                    w[size_t((j / CO_TILE) * c_out + row_o) * c_in + c])
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
      zs[((f * K + k) * V + v) * CO_TILE + o] = round_to<T>(acc[k][v] + bias);
  }
  __syncthreads();

  float s_sum = 0.f, s_sq = 0.f;
  if (f < n_f && o0 + o < c_out) {
    const float* zf = zs + f * K * V * CO_TILE + o;
    T* og = out + size_t(f0 + f) * V * c_out + o0 + o;
    for (int wv = 0; wv < V; ++wv) {
      float sum = 0.f;
      for (int i = 0; i < s.a_nnz[wv]; ++i)
        sum += s.a_val[wv][i] * zf[s.a_kv[wv][i] * CO_TILE];
      const T val = from_float<T>(sum);
      og[size_t(wv) * c_out] = val;
      if (STATS) {
        const float r = to_float(val);
        s_sum += r;
        s_sq += r * r;
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

// With STATS, ws holds blocks * 2 * c_out floats of partials, and sums gets
// the 2 * c_out channel sums (out, then out^2).
template <typename T, bool STATS>
int launch(const void* x, const void* w, const void* b, const void* a,
           void* out, void* ws, void* sums, int frames, int c_in, int c_out,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int smem = int(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      sgcn_fwd_kernel<T, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((frames + FRAMES - 1) / FRAMES,
                  (c_out + CO_TILE - 1) / CO_TILE);
  sgcn_fwd_kernel<T, STATS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<T*>(out), static_cast<float*>(ws), frames, c_in, c_out);
  err = cudaGetLastError();
  if (!STATS || err != cudaSuccess) return int(err);
  return int(channel_sums::launch(static_cast<const float*>(ws), grid.x,
                                  2 * c_out, static_cast<float*>(sums),
                                  stream));
}

}  // namespace

// x: (frames, V, c_in) in T; w: (K * c_out, c_in) f32; b: (K * c_out,) f32;
// a: (K, V, V) f32; out: (frames, V, c_out) in T. All contiguous. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sgcn_fwd_f32(const void* x, const void* w, const void* b,
                            const void* a, void* out, int frames, int c_in,
                            int c_out, void* stream) {
  return launch<float, false>(x, w, b, a, out, nullptr, nullptr, frames, c_in,
                              c_out, stream);
}

extern "C" int sgcn_fwd_bf16(const void* x, const void* w, const void* b,
                             const void* a, void* out, int frames, int c_in,
                             int c_out, void* stream) {
  return launch<__nv_bfloat16, false>(x, w, b, a, out, nullptr, nullptr,
                                      frames, c_in, c_out, stream);
}

// As sgcn_fwd_*, plus ws: ceil(frames / FRAMES) * 2 * c_out f32 of
// workspace, and sums: (2 * c_out,) f32, the sums of out and of out^2 over
// all frames and joints per output channel.
extern "C" int sgcn_fwd_stats_f32(const void* x, const void* w,
                                  const void* b, const void* a, void* out,
                                  void* ws, void* sums, int frames, int c_in,
                                  int c_out, void* stream) {
  return launch<float, true>(x, w, b, a, out, ws, sums, frames, c_in, c_out,
                             stream);
}

extern "C" int sgcn_fwd_stats_bf16(const void* x, const void* w,
                                   const void* b, const void* a, void* out,
                                   void* ws, void* sums, int frames, int c_in,
                                   int c_out, void* stream) {
  return launch<__nv_bfloat16, true>(x, w, b, a, out, ws, sums, frames, c_in,
                                     c_out, stream);
}
