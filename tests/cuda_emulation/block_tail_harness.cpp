// Runs the block-tail kernels of csrc/block_tail.cuh in the CPU emulation of
// cuda_shim.h and holds them against the eager order of operations in f32
// and against f64 references.
//
//   block_tail_harness ROWS C VEC U RES
//
// U: f32 or bf16, the type of u; RES: none, f32 or bf16. The inputs come
// from a fixed seed. Prints, one "name value" a line: for out, g_u, g_res
// and gue the number of elements that differ from the same f32 operations
// taken in the eager order here (`*_ulps`: any difference at all), and the
// largest |kernel - f64| / max |f64|; for the two channel sums of the
// backward the largest |kernel - f64| / sum |terms| over the channels. The
// kernels' shared memory starts as NaN, and the workspace too.

#include <cstdlib>
#include <functional>
#include <memory>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "block_tail.cuh"

thread_local dim3 emu_threadIdx, emu_blockIdx;
dim3 emu_gridDim;
std::barrier<>* emu_bar;
namespace block_tail {
float red[1 << 13];  // backward_pass's extern __shared__ array
}

namespace {

using bf16 = __nv_bfloat16;

void launch(int grid, size_t smem, const std::function<void()>& body) {
  if (smem > sizeof(block_tail::red)) std::abort();
  emu_gridDim = dim3(grid);
  for (int x = 0; x < grid; ++x) {
    std::fill(block_tail::red, block_tail::red + smem / 4, NAN);
    std::barrier<> bar(block_tail::THREADS);
    emu_bar = &bar;
    std::vector<std::thread> team;
    for (int t = 0; t < block_tail::THREADS; ++t)
      team.emplace_back([&, t, x] {
        emu_threadIdx = dim3(t);
        emu_blockIdx = dim3(x);
        body();
      });
    for (auto& th : team) th.join();
  }
}

// a buffer aligned as a CUDA allocation is
template <typename T>
std::shared_ptr<T[]> buffer(size_t n) {
  void* p = std::aligned_alloc(256, (n * sizeof(T) + 255) / 256 * 256);
  return std::shared_ptr<T[]>(static_cast<T*>(p), [](T* q) { std::free(q); });
}

float f32(float x) { return x; }
float f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
T to(float x);
template <>
float to<float>(float x) {
  return x;
}
template <>
bf16 to<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
bool same(float a, float b) { return std::memcmp(&a, &b, 4) == 0; }
bool same(bf16 a, bf16 b) { return a.x == b.x; }

std::mt19937 rng(7);

template <typename T>
std::shared_ptr<T[]> randn(size_t n, float mean, float scale) {
  std::normal_distribution<float> d(mean, scale);
  auto v = buffer<T>(n);
  for (size_t i = 0; i < n; ++i) v[i] = to<T>(d(rng));
  return v;
}

struct Error {
  long long ulps = 0;
  double err = 0, scale = 0;
  template <typename T>
  void add(T got, T eager, double want) {
    ulps += !same(got, eager);
    err = std::max(err, std::fabs(double(f32(got)) - want));
    scale = std::max(scale, std::fabs(want));
    if (!std::isfinite(f32(got))) err = INFINITY;
  }
  void print(const char* name) const {
    std::printf("%s_ulps %lld\n%s %.3e\n", name, ulps, name,
                err / (scale > 0 ? scale : 1));
  }
};

template <typename U, typename R>
int run(long long rows, int c, int vec, bool has_res) {
  const size_t n = size_t(rows) * c;
  const auto u = randn<U>(n, 0.f, 1.f);
  const auto res = randn<R>(n, 0.f, 1.f);
  const auto g_out = randn<float>(n, 0.f, 1.f);
  const auto g_u_in = randn<U>(n, 0.f, 1.f);
  const auto scale = randn<float>(c, 0.f, 1.f);
  const auto shift = randn<float>(c, 0.f, 1.f);
  const auto g_sum = randn<float>(c, 0.f, 1.f);
  const auto g_sumsq = randn<float>(c, 0.f, 0.1f);
  auto out = buffer<float>(n);
  auto g_u = buffer<U>(n);
  auto g_res = buffer<R>(n);
  auto gue = buffer<U>(n);
  const int grid = block_tail::blocks(rows, c, vec);
  auto ws = buffer<float>(size_t(grid) * 2 * c);
  for (size_t i = 0; i < n; ++i) {
    out[i] = NAN;
    g_u[i] = gue[i] = to<U>(NAN);
    g_res[i] = to<R>(NAN);
  }
  for (size_t i = 0; i < size_t(grid) * 2 * c; ++i) ws[i] = NAN;

  const R* res_p = has_res ? res.get() : nullptr;
  R* g_res_p = has_res ? g_res.get() : nullptr;
  auto kernels = [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    launch(grid, 0, [&] {
      block_tail::forward_pass<U, R, VEC>(u.get(), scale.get(), shift.get(),
                                          res_p, out.get(), rows, c);
    });
    launch(grid, block_tail::backward_smem(c, VEC), [&] {
      block_tail::backward_pass<U, R, VEC>(g_out.get(), out.get(), u.get(),
                                           scale.get(), g_u.get(), g_res_p,
                                           ws.get(), rows, c);
    });
    launch(grid, 0, [&] {
      block_tail::gue_pass<U, VEC>(g_u_in.get(), u.get(), g_sum.get(),
                                   g_sumsq.get(), gue.get(), rows, c);
    });
  };
  switch (vec) {
    case 8: kernels(std::integral_constant<int, 8>{}); break;
    case 4: kernels(std::integral_constant<int, 4>{}); break;
    case 2: kernels(std::integral_constant<int, 2>{}); break;
    case 1: kernels(std::integral_constant<int, 1>{}); break;
    default: return 2;
  }

  Error e_out, e_gu, e_gres, e_gue;
  std::vector<double> sum(c), sum_u(c), abs_sum(c), abs_sum_u(c);
  for (size_t i = 0; i < n; ++i) {
    const int ch = int(i % c);
    const float x = f32(u[i]), r = has_res ? f32(res[i]) : 0.f;
    // the eager order: u.float() * scale2, + shift2, + res, relu
    float y = x * scale[ch];
    y = y + shift[ch];
    if (has_res) y = y + r;
    y = y <= 0.f ? 0.f : y;
    const double yd = std::max(0.0, double(x) * scale[ch] + shift[ch] + r);
    e_out.add(out[i], y, yd);
    // the backward, masked by the kernel's own out (the saved output)
    const float gm = out[i] <= 0.f ? 0.f : g_out[i];
    e_gu.add(g_u[i], to<U>(gm * scale[ch]), double(gm) * scale[ch]);
    if (has_res) e_gres.add(g_res[i], to<R>(gm), double(gm));
    sum[ch] += gm;
    sum_u[ch] += double(gm) * x;
    abs_sum[ch] += std::fabs(double(gm));
    abs_sum_u[ch] += std::fabs(double(gm) * x);
    // the fold: (g_u + g_sum) + ((2 u) * g_sumsq)
    const float gi = f32(g_u_in[i]);
    const float fold = (gi + g_sum[ch]) + ((2.f * x) * g_sumsq[ch]);
    e_gue.add(gue[i], to<U>(fold),
              double(gi) + g_sum[ch] + 2.0 * x * g_sumsq[ch]);
  }
  // the partials added in channel_sums.cuh's order is another order of f32
  // sums; here in block order
  double err_sum = 0, err_sum_u = 0;
  for (int ch = 0; ch < c; ++ch) {
    float s = 0.f, su = 0.f;
    for (int p = 0; p < grid; ++p) {
      s += ws[size_t(p) * 2 * c + ch];
      su += ws[size_t(p) * 2 * c + c + ch];
    }
    if (!std::isfinite(s) || !std::isfinite(su)) err_sum = INFINITY;
    err_sum = std::max(err_sum, std::fabs(s - sum[ch]) /
                                    std::max(abs_sum[ch], 1e-30));
    err_sum_u = std::max(err_sum_u, std::fabs(su - sum_u[ch]) /
                                        std::max(abs_sum_u[ch], 1e-30));
  }
  e_out.print("out");
  e_gu.print("g_u");
  if (has_res) e_gres.print("g_res");
  e_gue.print("gue");
  std::printf("sum %.3e\nsum_u %.3e\nblocks %d\n", err_sum, err_sum_u, grid);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const long long rows = std::atoll(argv[1]);
  const int c = std::atoi(argv[2]), vec = std::atoi(argv[3]);
  const std::string u(argv[4]), res(argv[5]);
  const bool has_res = res != "none";
  const bool res_bf16 = res == "bf16";
  if (u == "f32")
    return res_bf16 ? run<float, bf16>(rows, c, vec, has_res)
                    : run<float, float>(rows, c, vec, has_res);
  if (u == "bf16")
    return res_bf16 ? run<bf16, bf16>(rows, c, vec, has_res)
                    : run<bf16, float>(rows, c, vec, has_res);
  return 2;
}
