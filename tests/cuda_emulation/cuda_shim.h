// The CUDA constructs of the f32 spatial graph-conv kernels
// (sgcn_tile_f32.cuh), the STFT kernels (stft_fft.cuh), the spline radar
// kernels (radar_spline.cuh), the block-tail kernels (block_tail.cuh) and
// CTR-GCN's aggregation kernels (ctrgc_tile.cuh),
// emulated on the CPU: a block's threads are std::threads, __syncthreads a
// barrier, dynamic shared memory a static array, blockIdx and threadIdx
// thread-local. Force-included (-include) before a kernels' header; see
// tests/test_torch_sgcn_emulated.py, tests/test_torch_stft_emulated.py,
// tests/test_torch_radar_emulated.py,
// tests/test_torch_block_tail_emulated.py and
// tests/test_torch_ctrgc_emulated.py.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
extern thread_local dim3 emu_threadIdx, emu_blockIdx;
extern dim3 emu_gridDim;
extern std::barrier<>* emu_bar;
#define threadIdx emu_threadIdx
#define blockIdx emu_blockIdx
#define gridDim emu_gridDim
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
// single roundings, never contracted into an FMA (the host build has no
// -mfma)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
