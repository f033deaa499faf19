// Runs the channels-first BatchNorm kernels of csrc/channel_norm.cuh in the
// CPU emulation of cuda_shim.h and holds them against f64 references.
//
//   channel_norm_harness N C L TI TO PPC VEC PAD
//
// TI: f32 or bf16, the type of x and dx; TO: f32 or bf16, the type of y and
// dy. A block takes PPC planes; VEC elements a thread's access. x is the
// first C channels and dy the last C of (N, C + PAD, L) tensors, so their
// samples lie (C + PAD) L elements apart, as a slice of a concatenation's
// gradient does. The inputs come from a fixed seed. Prints, one "name
// value" a line: the largest error of mean (over the channel's standard
// deviation), invstd, the running statistics (relative), y and dx (over
// the largest |f64| of the tensor), grad_weight and grad_bias (over the
// sum of their terms' magnitudes); y_ulps, the elements of y that differ
// from the same f32 operations on the kernels' own mean and invstd;
// repeat_bits, the output elements that differ between two runs;
// no_dx_bits, the weight gradients that differ when dx is not asked for;
// and the blocks of a launch. Shared memory, the workspace and every output
// start as NaN.

#include <cstdlib>
#include <functional>
#include <memory>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "channel_norm.cuh"

thread_local dim3 emu_threadIdx, emu_blockIdx;
dim3 emu_gridDim;
std::barrier<>* emu_bar;
namespace channel_norm {
float red[3 * THREADS];  // the kernels' extern __shared__ array
}

namespace {

using bf16 = __nv_bfloat16;
using channel_norm::THREADS;

// One team of THREADS threads runs the grid's blocks one after another,
// x fastest, shared memory refilled with NaN before each block.
void launch(dim3 grid, const std::function<void()>& body) {
  emu_gridDim = grid;
  std::barrier<> bar(THREADS);
  emu_bar = &bar;
  std::vector<std::thread> team;
  for (int t = 0; t < THREADS; ++t)
    team.emplace_back([&, t] {
      emu_threadIdx = dim3(t);
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          if (t == 0)
            std::fill(channel_norm::red, channel_norm::red + 3 * THREADS,
                      NAN);
          bar.arrive_and_wait();
          emu_blockIdx = dim3(x, y);
          body();
          bar.arrive_and_wait();
        }
    });
  for (auto& th : team) th.join();
}

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
uint32_t bits(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return u;
}
uint32_t bits(bf16 x) { return x.x; }

std::mt19937 rng(13);

template <typename T>
std::shared_ptr<T[]> fill(size_t n, float mean, float scale) {
  std::normal_distribution<float> d(mean, scale);
  auto v = buffer<T>(n);
  for (size_t i = 0; i < n; ++i) v[i] = to<T>(d(rng));
  return v;
}

template <typename T>
std::shared_ptr<T[]> nans(size_t n) {
  auto v = buffer<T>(n);
  for (size_t i = 0; i < n; ++i) v[i] = to<T>(NAN);
  return v;
}

std::shared_ptr<float[]> copy(const std::shared_ptr<float[]>& a, size_t n) {
  auto v = buffer<float>(n);
  std::copy(a.get(), a.get() + n, v.get());
  return v;
}

struct Outputs {
  std::shared_ptr<float[]> mean, invstd, rm, rv, gw, gb;
  size_t c;
};

template <typename TI, typename TO>
int run(int n, int c, int l, int ppc, int vec, int pad) {
  constexpr float eps = 1e-5f, momentum = 0.1f;
  const long long stride = (long long)(c + pad) * l;
  const size_t all = size_t(n) * stride, dense = size_t(n) * c * l;
  const int chunks = (n + ppc - 1) / ppc;
  const auto x_buf = fill<TI>(all, 3.f, 2.f);
  const auto dy_buf = fill<TO>(all, 0.5f, 1.f);
  const TI* x = x_buf.get();
  const TO* dy = dy_buf.get() + size_t(pad) * l;
  const auto w = fill<float>(c, 1.f, 0.25f);
  const auto b = fill<float>(c, 0.f, 1.f);
  const auto rm0 = fill<float>(c, 0.f, 0.1f);
  const auto rv0 = fill<float>(c, 1.f, 0.1f);
  const dim3 grid(chunks, c);

  auto pass = [&](bool with_dx, std::shared_ptr<TO[]>& y,
                  std::shared_ptr<TI[]>& dx) {
    Outputs o{nans<float>(c), nans<float>(c), copy(rm0, c), copy(rv0, c),
              nans<float>(c), nans<float>(c), size_t(c)};
    auto ws = nans<float>(size_t(2) * c * chunks);
    y = nans<TO>(dense);
    dx = nans<TI>(dense);
    auto kernels = [&](auto v) {
      constexpr int VEC = decltype(v)::value;
      launch(grid, [&] {
        channel_norm::stats_pass<TI, VEC>(x, stride, n, l, ppc, ws.get());
      });
      launch(grid, [&] {
        channel_norm::normalize_pass<TI, TO, VEC>(
            x, stride, ws.get(), w.get(), b.get(), o.rm.get(), o.rv.get(),
            o.mean.get(), o.invstd.get(), y.get(), n, c, l, ppc, 1, momentum,
            eps);
      });
      std::fill(ws.get(), ws.get() + size_t(2) * c * chunks, NAN);
      launch(grid, [&] {
        channel_norm::reduce_pass<TI, TO, VEC>(dy, stride, x, stride,
                                               o.mean.get(), n, l, ppc,
                                               ws.get());
      });
      launch(with_dx ? grid : dim3(1, c), [&] {
        channel_norm::dx_pass<TI, TO, VEC>(
            dy, stride, x, stride, ws.get(), w.get(), o.mean.get(),
            o.invstd.get(), with_dx ? dx.get() : nullptr, o.gw.get(),
            o.gb.get(), n, c, l, ppc);
      });
    };
    switch (vec) {
      case 8: kernels(std::integral_constant<int, 8>{}); break;
      case 4: kernels(std::integral_constant<int, 4>{}); break;
      case 2: kernels(std::integral_constant<int, 2>{}); break;
      case 1: kernels(std::integral_constant<int, 1>{}); break;
      default: std::abort();
    }
    return o;
  };
  std::shared_ptr<TO[]> y, y2, y3;
  std::shared_ptr<TI[]> dx, dx2, dx3;
  const Outputs o = pass(true, y, dx);
  const Outputs o2 = pass(true, y2, dx2);
  const Outputs o3 = pass(false, y3, dx3);

  // f64 references
  const double count = double(n) * l;
  double e_mean = 0, e_invstd = 0, e_rm = 0, e_rv = 0, e_gw = 0, e_gb = 0;
  double e_y = 0, s_y = 0, e_dx = 0, s_dx = 0;
  long long y_ulps = 0, repeat_bits = 0, no_dx_bits = 0;
  for (int ch = 0; ch < c; ++ch) {
    auto at = [&](int p, int i) {
      return size_t(p) * stride + size_t(ch) * l + i;
    };
    auto out = [&](int p, int i) { return (size_t(p) * c + ch) * l + i; };
    double s = 0;
    for (int p = 0; p < n; ++p)
      for (int i = 0; i < l; ++i) s += f32(x[at(p, i)]);
    const double mean = s / count;
    double m2 = 0, gb = 0, dot = 0, dabs = 0, gabs = 0;
    for (int p = 0; p < n; ++p)
      for (int i = 0; i < l; ++i) {
        const double xm = f32(x[at(p, i)]) - mean, g = f32(dy[at(p, i)]);
        m2 += xm * xm;
        gb += g;
        dot += g * xm;
        gabs += std::fabs(g);
        dabs += std::fabs(g * xm);
      }
    const double var = m2 / count, invstd = 1 / std::sqrt(var + eps);
    const double rm = (1 - double(momentum)) * rm0[ch] + momentum * mean;
    const double rv =
        (1 - double(momentum)) * rv0[ch] + momentum * m2 / (count - 1);
    auto rel = [](double got, double want) {
      return std::isfinite(got) ? std::fabs(got - want) / std::fabs(want)
                                : INFINITY;
    };
    e_mean = std::max(e_mean, std::isfinite(o.mean[ch])
                                  ? std::fabs(o.mean[ch] - mean) /
                                        std::sqrt(var)
                                  : INFINITY);
    e_invstd = std::max(e_invstd, rel(o.invstd[ch], invstd));
    e_rm = std::max(e_rm, rel(o.rm[ch], rm));
    e_rv = std::max(e_rv, rel(o.rv[ch], rv));
    e_gb = std::max(e_gb, std::isfinite(o.gb[ch])
                              ? std::fabs(o.gb[ch] - gb) / gabs
                              : INFINITY);
    e_gw = std::max(e_gw, std::isfinite(o.gw[ch])
                              ? std::fabs(o.gw[ch] - dot * invstd) /
                                    (dabs * invstd)
                              : INFINITY);
    // the kernels' f32 operations on their own statistics
    const float km = o.mean[ch];
    const float scale = o.invstd[ch] * w[ch];
    for (int p = 0; p < n; ++p)
      for (int i = 0; i < l; ++i) {
        const double xv = f32(x[at(p, i)]), g = f32(dy[at(p, i)]);
        const double yw = (xv - mean) * invstd * w[ch] + b[ch];
        const double dxw = w[ch] * invstd *
                           (g - gb / count -
                            (xv - mean) * invstd * invstd * dot / count);
        const TO yv = y[out(p, i)];
        const TI dv = dx[out(p, i)];
        e_y = std::max(e_y, std::isfinite(f32(yv))
                                ? std::fabs(f32(yv) - yw)
                                : INFINITY);
        s_y = std::max(s_y, std::fabs(yw));
        e_dx = std::max(e_dx, std::isfinite(f32(dv))
                                  ? std::fabs(f32(dv) - dxw)
                                  : INFINITY);
        s_dx = std::max(s_dx, std::fabs(dxw));
        const TO eager = to<TO>((f32(x[at(p, i)]) - km) * scale + b[ch]);
        y_ulps += bits(yv) != bits(eager);
        repeat_bits += bits(yv) != bits(y2[out(p, i)]);
        repeat_bits += bits(dv) != bits(dx2[out(p, i)]);
      }
    for (auto field : {&Outputs::mean, &Outputs::invstd, &Outputs::rm,
                       &Outputs::rv, &Outputs::gw, &Outputs::gb})
      repeat_bits += bits((o.*field)[ch]) != bits((o2.*field)[ch]);
    no_dx_bits += bits(o.gw[ch]) != bits(o3.gw[ch]);
    no_dx_bits += bits(o.gb[ch]) != bits(o3.gb[ch]);
  }
  std::printf("mean %.3e\ninvstd %.3e\nrunning_mean %.3e\nrunning_var %.3e\n",
              e_mean, e_invstd, e_rm, e_rv);
  std::printf("y %.3e\ndx %.3e\ngrad_weight %.3e\ngrad_bias %.3e\n",
              e_y / s_y, e_dx / s_dx, e_gw, e_gb);
  std::printf("y_ulps %lld\nrepeat_bits %lld\nno_dx_bits %lld\nblocks %d\n",
              y_ulps, repeat_bits, no_dx_bits, chunks * c);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int n = std::atoi(argv[1]), c = std::atoi(argv[2]),
            l = std::atoi(argv[3]), ppc = std::atoi(argv[6]),
            vec = std::atoi(argv[7]), pad = std::atoi(argv[8]);
  const std::string ti = argv[4], to_ = argv[5];
  if (ti == "f32" && to_ == "f32") return run<float, float>(n, c, l, ppc, vec, pad);
  if (ti == "f32" && to_ == "bf16") return run<float, bf16>(n, c, l, ppc, vec, pad);
  if (ti == "bf16" && to_ == "f32") return run<bf16, float>(n, c, l, ppc, vec, pad);
  if (ti == "bf16" && to_ == "bf16") return run<bf16, bf16>(n, c, l, ppc, vec, pad);
  return 2;
}
