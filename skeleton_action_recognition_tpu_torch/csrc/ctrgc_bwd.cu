// CTR-GCN's channel-wise graph aggregation, backward, for Hopper (sm_90a):
// the C entry points of ctrgc_tile.cuh's aggregate_bwd, which holds the
// design and what bounds it. It replaces no TPU kernel (the JAX package
// has no CTR-GCN).
//
// ctrgc_bwd_<T>, T in {f32, bf16}: dz (n, c, t, v) and x3 (n, k, c, t, v)
// in T, s (n, k, c, v, v) f32. Out: dx3 like x3, ds like s. Every tensor
// contiguous, v <= 32. Returns the first cudaError_t of the launch (0 on
// success).

#include "ctrgc_tile.cuh"

namespace {

template <typename T>
int backward(const void* dz, const void* x3, const void* s, void* dx3,
             void* ds, int n, int k, int c, int t, int v, void* stream) {
  const ctrgc::Geometry g(k, t, v);
  const long long planes = (long long)n * c;
  if (planes == 0) return 0;
  const size_t plane = ctrgc::bwd_plane_bytes(g, sizeof(T));
  const int ppb = ctrgc::planes_per_block(g.bwd_items(), plane);
  const size_t smem = ppb * plane;
  cudaError_t err = cudaFuncSetAttribute(
      ctrgc::aggregate_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (planes + ppb - 1) / ppb;
  ctrgc::aggregate_bwd<T><<<dim3(unsigned(blocks)), ctrgc::THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dz), static_cast<const T*>(x3),
      static_cast<const float*>(s), static_cast<T*>(dx3),
      static_cast<float*>(ds), planes, k, c, t, v, ppb);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ctrgc_bwd_f32(const void* dz, const void* x3, const void* s,
                             void* dx3, void* ds, int n, int k, int c, int t,
                             int v, void* stream) {
  return backward<float>(dz, x3, s, dx3, ds, n, k, c, t, v, stream);
}

extern "C" int ctrgc_bwd_bf16(const void* dz, const void* x3, const void* s,
                              void* dx3, void* ds, int n, int k, int c, int t,
                              int v, void* stream) {
  return backward<__nv_bfloat16>(dz, x3, s, dx3, ds, n, k, c, t, v, stream);
}
