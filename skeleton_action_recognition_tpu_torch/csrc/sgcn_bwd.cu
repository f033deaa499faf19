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
// (dx and dW), so the kernel, which computes on the CUDA cores in f32, is
// bound by their ~67 TFLOP/s; in bf16 the plain version runs its two GEMMs
// on the tensor cores and is bound by the dz bytes instead. This kernel
// never stores dz: each block recomputes the dz it needs from g in shared
// memory (dz costs ~73 FMAs per frame and channel against 3 * 25 * C_in for
// dx), so g and x are read and dx written once each, plus a small workspace.
//
// dW and db are sums over all F * V rows (1.9 M at B = 128). Blocks run in no
// order, so there are no cross-block accumulators and no float atomics:
//   1. sgcn_bwd_dx_kernel: one block per (DX_FRAMES frames, DX_CI input
//      channels); thread (f, i) keeps dx[f, v, i] and dx[f, v, i + 32] for
//      the 25 joints in registers and loops over (k, o) in chunks of OC
//      output channels: the chunk of g is staged, dz is computed from it
//      through each row's nonzero A[k, v, :], and W's chunk is staged.
//   2. sgcn_bwd_dw_kernel: one block per (split of the frames, DW_OT output
//      channels, DW_IT input channels); thread (o pair, i octet) keeps the
//      3 x 2 x 8 dW partials in registers and loops over its split's frames
//      in chunks of DW_FRAMES, with dz recomputed the same way. Each block
//      writes its partial for its fixed split to the workspace.
//   3. sgcn_bwd_reduce_kernel: sums the splits' partials in split order.
// Every sum is taken in an order fixed by the shapes alone, so two launches
// on the same inputs give bit-identical dx, dW and db.
//
// Rounding follows the TPU kernel: g arrives in x's dtype, A and W are
// rounded to it on load, dz is rounded to it after its f32 sum, dx is summed
// in f32 and stored in x's dtype, dW and db are summed and stored in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int V = 25;  // NTU RGB+D joints
constexpr int K = 3;   // spatial partitions
constexpr int KV = K * V;

constexpr int OC = 16;                            // dx: output channels per chunk
constexpr int DX_FRAMES = 4;                      // dx: frames per block
constexpr int DX_CI = 64;                         // dx: input channels per block
constexpr int DX_THREADS = DX_FRAMES * (DX_CI / 2);

constexpr int DW_FRAMES = 2;                      // dW: frames per chunk
constexpr int DW_ROWS = DW_FRAMES * V;
constexpr int DW_OT = 32;                         // dW: output channels per block
constexpr int DW_IT = 64;                         // dW: input channels per block
constexpr int DW_THREADS = (DW_OT / 2) * (DW_IT / 8);

constexpr int REDUCE_THREADS = 256;

// Nonzero A[k, v, w] of each row (k, v), in w order, rounded to x's dtype.
struct RowList {
  float val[KV][V];
  unsigned char w[KV][V];
  int nnz[KV];
};

struct DxSmem {
  float dz[DX_FRAMES * KV * OC];  // [f][k][v][o], rows of OC for float4 loads
  float g[DX_FRAMES * V * OC];    // [f][w][o]
  float w[K * OC * DX_CI];        // [k][o][i]
  RowList rows;
};

struct DwSmem {
  float dz[DW_ROWS * K * DW_OT];  // [f * V + v][k][o]
  float x[DW_ROWS * DW_IT];       // [f * V + v][i]
  float g[DW_ROWS * DW_OT];       // [f * V + w][o]
  RowList rows;
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

// Threads 0..KV-1 list row kv of A. The caller synchronises before use.
template <typename T>
__device__ void list_rows(const float* __restrict__ a, RowList& rows) {
  const int kv = threadIdx.x;
  if (kv >= KV) return;
  int n = 0;
  for (int w = 0; w < V; ++w) {
    const float av = round_to<T>(a[kv * V + w]);
    if (av != 0.f) {
      rows.val[kv][n] = av;
      rows.w[kv][n] = static_cast<unsigned char>(w);
      ++n;
    }
  }
  rows.nnz[kv] = n;
}

// dz for row kv of frame-local g (stride ld between joints), rounded to T.
template <typename T>
__device__ __forceinline__ float dz_at(const RowList& rows, int kv,
                                       const float* gf, int ld) {
  float sum = 0.f;
  for (int j = 0; j < rows.nnz[kv]; ++j)
    sum += rows.val[kv][j] * gf[rows.w[kv][j] * ld];
  return round_to<T>(sum);
}

template <typename T>
__global__ void __launch_bounds__(DX_THREADS)
    sgcn_bwd_dx_kernel(const T* __restrict__ g, const float* __restrict__ w,
                       const float* __restrict__ a, T* __restrict__ dx,
                       int frames, int c_in, int c_out) {
  extern __shared__ float4 smem4[];
  DxSmem& s = *reinterpret_cast<DxSmem*>(smem4);
  const int tid = threadIdx.x;
  const int f = tid / (DX_CI / 2), il = tid % (DX_CI / 2);
  const int f0 = blockIdx.x * DX_FRAMES;
  const int i0 = blockIdx.y * DX_CI;
  const int n_f = min(DX_FRAMES, frames - f0);

  list_rows<T>(a, s.rows);

  float acc[V][2];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v][0] = acc[v][1] = 0.f;

  const T* gg = g + size_t(f0) * V * c_out;
  for (int o0 = 0; o0 < c_out; o0 += OC) {
    __syncthreads();  // rows listed / previous chunk consumed
    for (int idx = tid; idx < DX_FRAMES * V * OC; idx += DX_THREADS) {
      const int row = idx / OC, o = o0 + idx % OC;  // row = f * V + w
      s.g[idx] = (row < n_f * V && o < c_out)
                     ? to_float(gg[size_t(row) * c_out + o])
                     : 0.f;
    }
    for (int idx = tid; idx < K * OC * DX_CI; idx += DX_THREADS) {
      const int i = i0 + idx % DX_CI, ko = idx / DX_CI;
      const int o = o0 + ko % OC;
      s.w[idx] = (o < c_out && i < c_in)
                     ? round_to<T>(w[size_t((ko / OC) * c_out + o) * c_in + i])
                     : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < DX_FRAMES * KV * OC; idx += DX_THREADS) {
      const int o = idx % OC, fkv = idx / OC;
      const int kv = fkv % KV, ff = fkv / KV;
      s.dz[idx] = dz_at<T>(s.rows, kv, s.g + ff * V * OC + o, OC);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int oc = 0; oc < OC; oc += 4) {
        float w0[4], w1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w0[j] = s.w[(k * OC + oc + j) * DX_CI + il];
          w1[j] = s.w[(k * OC + oc + j) * DX_CI + il + DX_CI / 2];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float4 d = *reinterpret_cast<const float4*>(
              &s.dz[((f * K + k) * V + v) * OC + oc]);
          acc[v][0] += d.x * w0[0] + d.y * w0[1] + d.z * w0[2] + d.w * w0[3];
          acc[v][1] += d.x * w1[0] + d.y * w1[1] + d.z * w1[2] + d.w * w1[3];
        }
      }
    }
  }

  if (f >= n_f) return;
  T* out = dx + size_t(f0 + f) * V * c_in;
  const int ia = i0 + il, ib = i0 + il + DX_CI / 2;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (ia < c_in) out[v * c_in + ia] = from_float<T>(acc[v][0]);
    if (ib < c_in) out[v * c_in + ib] = from_float<T>(acc[v][1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
    sgcn_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ a, float* __restrict__ ws_w,
                       float* __restrict__ ws_b, int frames, int c_in,
                       int c_out) {
  extern __shared__ float4 smem4[];
  DwSmem& s = *reinterpret_cast<DwSmem*>(smem4);
  const int tid = threadIdx.x;
  const int po = tid % (DW_OT / 2), pi = tid / (DW_OT / 2);
  const int split = blockIdx.x, splits = gridDim.x;
  const int o0 = blockIdx.y * DW_OT, i0 = blockIdx.z * DW_IT;
  const int f_begin = int(static_cast<long long>(frames) * split / splits);
  const int f_end = int(static_cast<long long>(frames) * (split + 1) / splits);

  list_rows<T>(a, s.rows);

  float acc[K][2][8];
  float bacc[K][2];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bacc[k][j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[k][j][i] = 0.f;
    }

  for (int fc = f_begin; fc < f_end; fc += DW_FRAMES) {
    const int n_rows = min(DW_FRAMES, f_end - fc) * V;
    __syncthreads();  // rows listed / previous chunk consumed
    const T* gg = g + size_t(fc) * V * c_out;
    for (int idx = tid; idx < DW_ROWS * DW_OT; idx += DW_THREADS) {
      const int row = idx / DW_OT, o = o0 + idx % DW_OT;
      s.g[idx] = (row < n_rows && o < c_out)
                     ? to_float(gg[size_t(row) * c_out + o])
                     : 0.f;
    }
    const T* xg = x + size_t(fc) * V * c_in;
    for (int idx = tid; idx < DW_ROWS * DW_IT; idx += DW_THREADS) {
      const int row = idx / DW_IT, i = i0 + idx % DW_IT;
      s.x[idx] = (row < n_rows && i < c_in)
                     ? to_float(xg[size_t(row) * c_in + i])
                     : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < DW_ROWS * K * DW_OT; idx += DW_THREADS) {
      const int o = idx % DW_OT, rk = idx / DW_OT;
      const int k = rk % K, row = rk / K;
      const int ff = row / V, v = row % V;
      s.dz[idx] = dz_at<T>(s.rows, k * V + v, s.g + ff * V * DW_OT + o, DW_OT);
    }
    __syncthreads();
    for (int row = 0; row < n_rows; ++row) {
      const float4 xa =
          *reinterpret_cast<const float4*>(&s.x[row * DW_IT + pi * 8]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&s.x[row * DW_IT + pi * 8 + 4]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 d = *reinterpret_cast<const float2*>(
            &s.dz[(row * K + k) * DW_OT + po * 2]);
        bacc[k][0] += d.x;
        bacc[k][1] += d.y;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[k][0][i] += d.x * xv[i];
          acc[k][1][i] += d.y * xv[i];
        }
      }
    }
  }

  const size_t n_w = size_t(K) * c_out * c_in;
  float* pw = ws_w + size_t(split) * n_w;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = o0 + po * 2 + j;
      if (o >= c_out) continue;
      float* prow = pw + size_t(k * c_out + o) * c_in;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ii = i0 + pi * 8 + i;
        if (ii < c_in) prow[ii] = acc[k][j][i];
      }
      if (blockIdx.z == 0 && pi == 0)
        ws_b[size_t(split) * K * c_out + k * c_out + o] = bacc[k][j];
    }
}

// out[j] = sum over p in 0..splits-1, in that order, of ws[p * n + j].
__global__ void __launch_bounds__(REDUCE_THREADS)
    sgcn_bwd_reduce_kernel(const float* __restrict__ ws, int splits, int n,
                           float* __restrict__ out) {
  const int j = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (j >= n) return;
  float sum = 0.f;
  for (int p = 0; p < splits; ++p) sum += ws[size_t(p) * n + j];
  out[j] = sum;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch(const void* x, const void* g, const void* w, const void* a,
           void* dx, void* dw, void* db, void* ws, int frames, int c_in,
           int c_out, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* af = static_cast<const float*>(a);
  const int n_w = K * c_out * c_in, n_b = K * c_out;
  float* ws_w = static_cast<float*>(ws);
  float* ws_b = ws_w + size_t(splits) * n_w;

  const int dx_smem = int(sizeof(DxSmem));
  cudaError_t err = allow_smem(sgcn_bwd_dx_kernel<T>, dx_smem);
  if (err != cudaSuccess) return int(err);
  const dim3 dx_grid((frames + DX_FRAMES - 1) / DX_FRAMES,
                     (c_in + DX_CI - 1) / DX_CI);
  sgcn_bwd_dx_kernel<T><<<dx_grid, DX_THREADS, dx_smem, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(w), af,
      static_cast<T*>(dx), frames, c_in, c_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int dw_smem = int(sizeof(DwSmem));
  err = allow_smem(sgcn_bwd_dw_kernel<T>, dw_smem);
  if (err != cudaSuccess) return int(err);
  const dim3 dw_grid(splits, (c_out + DW_OT - 1) / DW_OT,
                     (c_in + DW_IT - 1) / DW_IT);
  sgcn_bwd_dw_kernel<T><<<dw_grid, DW_THREADS, dw_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), af, ws_w, ws_b,
      frames, c_in, c_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  sgcn_bwd_reduce_kernel<<<(n_w + REDUCE_THREADS - 1) / REDUCE_THREADS,
                           REDUCE_THREADS, 0, stream>>>(
      ws_w, splits, n_w, static_cast<float*>(dw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  sgcn_bwd_reduce_kernel<<<(n_b + REDUCE_THREADS - 1) / REDUCE_THREADS,
                           REDUCE_THREADS, 0, stream>>>(
      ws_b, splits, n_b, static_cast<float*>(db));
  return int(cudaGetLastError());
}

}  // namespace

// x: (frames, V, c_in) in T; g: (frames, V, c_out) in T; w: (K * c_out, c_in)
// f32; a: (K, V, V) f32. Out: dx like x; dw (K * c_out, c_in) f32; db
// (K * c_out,) f32. ws: splits * K * c_out * (c_in + 1) f32 of workspace.
// All contiguous, frames >= 1. Returns the first cudaError_t (0 on success).
extern "C" int sgcn_bwd_f32(const void* x, const void* g, const void* w,
                            const void* a, void* dx, void* dw, void* db,
                            void* ws, int frames, int c_in, int c_out,
                            int splits, void* stream) {
  return launch<float>(x, g, w, a, dx, dw, db, ws, frames, c_in, c_out,
                       splits, stream);
}

extern "C" int sgcn_bwd_bf16(const void* x, const void* g, const void* w,
                             const void* a, void* dx, void* dw, void* db,
                             void* ws, int frames, int c_in, int c_out,
                             int splits, void* stream) {
  return launch<__nv_bfloat16>(x, g, w, a, dx, dw, db, ws, frames, c_in,
                               c_out, splits, stream);
}
