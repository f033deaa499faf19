// CTR-GCN's channel-wise graph aggregation, forward, for Hopper (sm_90a):
// the C entry points of ctrgc_tile.cuh's aggregate_fwd, which holds the
// design and what bounds it. It replaces no TPU kernel (the JAX package
// has no CTR-GCN).
//
// ctrgc_fwd_<T>, T in {f32, bf16}: x3 (n, k, c, t, v) in T, s (n, k, c, v,
// v) f32, z (n, c, t, v) in T; every tensor contiguous, v <= 32. Returns
// the first cudaError_t of the launch (0 on success).

#include "ctrgc_tile.cuh"

namespace {

template <typename T>
int forward(const void* x3, const void* s, void* z, int n, int k, int c,
            int t, int v, void* stream) {
  const ctrgc::Geometry g(k, t, v);
  const long long planes = (long long)n * c;
  if (planes == 0) return 0;
  const size_t plane = ctrgc::fwd_plane_bytes(g, sizeof(T));
  const int ppb = ctrgc::planes_per_block(g.fwd_items(), plane);
  const size_t smem = ppb * plane;
  cudaError_t err = cudaFuncSetAttribute(
      ctrgc::aggregate_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (planes + ppb - 1) / ppb;
  ctrgc::aggregate_fwd<T><<<dim3(unsigned(blocks)), ctrgc::THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x3), static_cast<const float*>(s),
      static_cast<T*>(z), planes, k, c, t, v, ppb);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ctrgc_fwd_f32(const void* x3, const void* s, void* z, int n,
                             int k, int c, int t, int v, void* stream) {
  return forward<float>(x3, s, z, n, k, c, t, v, stream);
}

extern "C" int ctrgc_fwd_bf16(const void* x3, const void* s, void* z, int n,
                              int k, int c, int t, int v, void* stream) {
  return forward<__nv_bfloat16>(x3, s, z, n, k, c, t, v, stream);
}
