// Channels-first BatchNorm in training, for Hopper (sm_90a): the C entry
// points of channel_norm.cuh's four kernels, which hold their design and
// what bounds them. They replace no TPU kernel (the JAX package has no
// CTR-GCN); torch's one-block-per-channel NCHW kernels ran here before.
//
// Entry points are named by x's type and y's: channel_norm_fwd_<x>_<y>,
// channel_norm_bwd_<x>_<y>, with <x>, <y> in {f32, bf16}. x and dy are
// (n, c, l) with each sample's (c, l) contiguous and samples x_stride and
// dy_stride elements apart; y and dx are contiguous; every per-channel
// tensor is (c,) f32. vec in {1, 2, 4, 8} divides l and both strides, and
// every tensor starts on a boundary of min(16, vec * its element size)
// bytes (ops/channel_norm.py::_vec picks it); a block takes ppc planes of
// one channel, c <= 65535, n * l counted exactly in f32. Each returns the
// first cudaError_t of its launches (0 on success).

#include <type_traits>

#include "channel_norm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using channel_norm::SMEM_BYTES;
using channel_norm::THREADS;

template <int VEC, typename F>
cudaError_t with_vec(F&& f) {
  f(std::integral_constant<int, VEC>{});
  return cudaGetLastError();
}

// f(std::integral_constant<int, vec>) for the vec the caller asked for
template <typename F>
cudaError_t dispatch(int vec, F&& f) {
  switch (vec) {
    case 8: return with_vec<8>(f);
    case 4: return with_vec<4>(f);
    case 2: return with_vec<2>(f);
    case 1: return with_vec<1>(f);
  }
  return cudaErrorInvalidValue;
}

dim3 grid(int n, int c, int ppc) {
  return dim3(unsigned((n + ppc - 1) / ppc), unsigned(c));
}

template <typename TI, typename TO>
int forward(const void* x, void* y, const void* w, const void* b,
            void* running_mean, void* running_var, void* save_mean,
            void* save_invstd, void* ws, int n, int c, int l, int x_stride,
            int ppc, int vec, int update, float momentum, float eps,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dispatch(vec, [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    channel_norm::stats_pass<TI, VEC><<<grid(n, c, ppc), THREADS, SMEM_BYTES,
                                        st>>>(
        static_cast<const TI*>(x), x_stride, n, l, ppc,
        static_cast<float*>(ws));
    channel_norm::normalize_pass<TI, TO, VEC>
        <<<grid(n, c, ppc), THREADS, SMEM_BYTES, st>>>(
            static_cast<const TI*>(x), x_stride,
            static_cast<const float*>(ws), static_cast<const float*>(w),
            static_cast<const float*>(b), static_cast<float*>(running_mean),
            static_cast<float*>(running_var), static_cast<float*>(save_mean),
            static_cast<float*>(save_invstd), static_cast<TO*>(y), n, c, l,
            ppc, update, momentum, eps);
  }));
}

template <typename TI, typename TO>
int backward(const void* dy, const void* x, const void* w,
             const void* save_mean, const void* save_invstd, void* dx,
             void* grad_weight, void* grad_bias, void* ws, int n, int c,
             int l, int dy_stride, int x_stride, int ppc, int vec,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dispatch(vec, [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    channel_norm::reduce_pass<TI, TO, VEC>
        <<<grid(n, c, ppc), THREADS, SMEM_BYTES, st>>>(
            static_cast<const TO*>(dy), dy_stride, static_cast<const TI*>(x),
            x_stride, static_cast<const float*>(save_mean), n, l, ppc,
            static_cast<float*>(ws));
    // without dx, one block a channel writes the weight's gradients
    channel_norm::dx_pass<TI, TO, VEC>
        <<<dx != nullptr ? grid(n, c, ppc) : dim3(1, unsigned(c)), THREADS,
           SMEM_BYTES, st>>>(
            static_cast<const TO*>(dy), dy_stride, static_cast<const TI*>(x),
            x_stride, static_cast<const float*>(ws),
            static_cast<const float*>(w),
            static_cast<const float*>(save_mean),
            static_cast<const float*>(save_invstd), static_cast<TI*>(dx),
            static_cast<float*>(grad_weight), static_cast<float*>(grad_bias),
            n, c, l, ppc);
  }));
}

}  // namespace

// x: (n, c, l) in <x>; w, b: (c,) f32; running_mean, running_var: (c,) f32,
// updated in place when update != 0. Out: y (n, c, l) in <y>; save_mean,
// save_invstd (c,) f32. ws: 2 c ceil(n / ppc) f32 of workspace.
#define CHANNEL_NORM_FWD(NAME, TI, TO)                                       \
  extern "C" int NAME(const void* x, void* y, const void* w, const void* b, \
                      void* running_mean, void* running_var,               \
                      void* save_mean, void* save_invstd, void* ws, int n,  \
                      int c, int l, int x_stride, int ppc, int vec,         \
                      int update, float momentum, float eps,                \
                      void* stream) {                                       \
    return forward<TI, TO>(x, y, w, b, running_mean, running_var,          \
                           save_mean, save_invstd, ws, n, c, l, x_stride,  \
                           ppc, vec, update, momentum, eps, stream);        \
  }
CHANNEL_NORM_FWD(channel_norm_fwd_f32_f32, float, float)
CHANNEL_NORM_FWD(channel_norm_fwd_f32_bf16, float, bf16)
CHANNEL_NORM_FWD(channel_norm_fwd_bf16_f32, bf16, float)
CHANNEL_NORM_FWD(channel_norm_fwd_bf16_bf16, bf16, bf16)

// dy: (n, c, l) in <y>; x: (n, c, l) in <x>; w, save_mean, save_invstd:
// (c,) f32. Out: dx (n, c, l) in <x>, or null for none; grad_weight,
// grad_bias (c,) f32. ws: 2 c ceil(n / ppc) f32 of workspace.
#define CHANNEL_NORM_BWD(NAME, TI, TO)                                         \
  extern "C" int NAME(const void* dy, const void* x, const void* w,           \
                      const void* save_mean, const void* save_invstd,         \
                      void* dx, void* grad_weight, void* grad_bias, void* ws, \
                      int n, int c, int l, int dy_stride, int x_stride,       \
                      int ppc, int vec, void* stream) {                       \
    return backward<TI, TO>(dy, x, w, save_mean, save_invstd, dx,            \
                            grad_weight, grad_bias, ws, n, c, l, dy_stride,   \
                            x_stride, ppc, vec, stream);                      \
  }
CHANNEL_NORM_BWD(channel_norm_bwd_f32_f32, float, float)
CHANNEL_NORM_BWD(channel_norm_bwd_f32_bf16, float, bf16)
CHANNEL_NORM_BWD(channel_norm_bwd_bf16_f32, bf16, float)
CHANNEL_NORM_BWD(channel_norm_bwd_bf16_bf16, bf16, bf16)
