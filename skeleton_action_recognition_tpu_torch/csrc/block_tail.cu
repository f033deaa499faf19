// The tail of a fused ST-GCN block and the fold that feeds the temporal
// chain's backward, for Hopper (sm_90a): the C entry points of
// block_tail.cuh's three kernels, which hold their design and what bounds
// them. They replace no TPU kernel (XLA fuses this tail on the TPU).
//
// Entry points are named by u's type and, for the tail, the residual's:
// block_tail_fwd_<u>_<res>, block_tail_bwd_<u>_<res>, tconv_gue_<u>, with
// <u>, <res> in {f32, bf16}. Every tensor is contiguous, rows >= 1 rows of
// c channels, starting on a 16-byte boundary; vec in {1, 2, 4, 8} divides
// c and c / vec <= 256 (ops/tconv.py::_tail_vec picks it). Each returns the
// first cudaError_t of its launches (0 on success).

#include <type_traits>

#include "block_tail.cuh"
#include "channel_sums.cuh"

namespace {

using bf16 = __nv_bfloat16;
using block_tail::THREADS;

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

template <typename U, typename R>
int forward(const void* u, const void* scale, const void* shift,
            const void* res, void* out, int rows, int c, int vec,
            void* stream) {
  return int(dispatch(vec, [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    block_tail::forward_pass<U, R, VEC>
        <<<block_tail::blocks(rows, c, VEC), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const U*>(u), static_cast<const float*>(scale),
            static_cast<const float*>(shift), static_cast<const R*>(res),
            static_cast<float*>(out), rows, c);
  }));
}

template <typename U, typename R>
int backward(const void* g_out, const void* out, const void* u,
             const void* scale, void* g_u, void* g_res, void* ws, void* sums,
             int rows, int c, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int parts = block_tail::blocks(rows, c, vec);
  const cudaError_t err = dispatch(vec, [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    block_tail::backward_pass<U, R, VEC>
        <<<parts, THREADS, block_tail::backward_smem(c, VEC), st>>>(
            static_cast<const float*>(g_out), static_cast<const float*>(out),
            static_cast<const U*>(u), static_cast<const float*>(scale),
            static_cast<U*>(g_u), static_cast<R*>(g_res),
            static_cast<float*>(ws), rows, c);
  });
  if (err != cudaSuccess) return int(err);
  return int(channel_sums::launch(static_cast<const float*>(ws), parts,
                                  2 * c, static_cast<float*>(sums), st));
}

template <typename U>
int gue(const void* g_u, const void* u, const void* g_sum,
        const void* g_sumsq, void* out, int rows, int c, int vec,
        void* stream) {
  return int(dispatch(vec, [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    block_tail::gue_pass<U, VEC>
        <<<block_tail::blocks(rows, c, VEC), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const U*>(g_u), static_cast<const U*>(u),
            static_cast<const float*>(g_sum),
            static_cast<const float*>(g_sumsq), static_cast<U*>(out), rows,
            c);
  }));
}

}  // namespace

// u: (rows, c) in <u>; scale, shift: (c,) f32; res: (rows, c) in <res>, or
// null for none. Out: out (rows, c) f32.
#define BLOCK_TAIL_FWD(NAME, U, R)                                           \
  extern "C" int NAME(const void* u, const void* scale, const void* shift,  \
                      const void* res, void* out, int rows, int c, int vec, \
                      void* stream) {                                        \
    return forward<U, R>(u, scale, shift, res, out, rows, c, vec, stream);  \
  }
BLOCK_TAIL_FWD(block_tail_fwd_f32_f32, float, float)
BLOCK_TAIL_FWD(block_tail_fwd_f32_bf16, float, bf16)
BLOCK_TAIL_FWD(block_tail_fwd_bf16_f32, bf16, float)
BLOCK_TAIL_FWD(block_tail_fwd_bf16_bf16, bf16, bf16)

// g_out, out: (rows, c) f32; u: (rows, c) in <u>; scale: (c,) f32. Out: g_u
// like u; g_res (rows, c) in <res>, or null for none; sums (2 c,) f32, the
// sums of gm then of gm * u per channel. ws: 2 c f32 of workspace for each
// of block_tail.cuh's blocks(rows, c, vec) blocks.
#define BLOCK_TAIL_BWD(NAME, U, R)                                            \
  extern "C" int NAME(const void* g_out, const void* out, const void* u,     \
                      const void* scale, void* g_u, void* g_res, void* ws,   \
                      void* sums, int rows, int c, int vec, void* stream) {  \
    return backward<U, R>(g_out, out, u, scale, g_u, g_res, ws, sums, rows,  \
                          c, vec, stream);                                   \
  }
BLOCK_TAIL_BWD(block_tail_bwd_f32_f32, float, float)
BLOCK_TAIL_BWD(block_tail_bwd_f32_bf16, float, bf16)
BLOCK_TAIL_BWD(block_tail_bwd_bf16_f32, bf16, float)
BLOCK_TAIL_BWD(block_tail_bwd_bf16_bf16, bf16, bf16)

// g_u, u: (rows, c) in <u>; g_sum, g_sumsq: (c,) f32. Out: gue like u.
extern "C" int tconv_gue_f32(const void* g_u, const void* u,
                             const void* g_sum, const void* g_sumsq,
                             void* out, int rows, int c, int vec,
                             void* stream) {
  return gue<float>(g_u, u, g_sum, g_sumsq, out, rows, c, vec, stream);
}

extern "C" int tconv_gue_bf16(const void* g_u, const void* u,
                              const void* g_sum, const void* g_sumsq,
                              void* out, int rows, int c, int vec,
                              void* stream) {
  return gue<bf16>(g_u, u, g_sum, g_sumsq, out, rows, c, vec, stream);
}
