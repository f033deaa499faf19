// Runs CTR-GCN's channel-wise aggregation kernels of csrc/ctrgc_tile.cuh in
// the CPU emulation of cuda_shim.h and holds them against the same f32
// operations in the kernels' order and against f64 references.
//
//   ctrgc_harness N K C T V DTYPE
//
// DTYPE: f32 or bf16, the type of x3, dz, z and dx3 (s and ds are f32). The
// inputs come from a fixed seed. Prints, one "name value" a line: for z,
// dx3 and ds the number of elements that differ from the f32 fused
// multiply-adds taken in the kernels' order here (`*_ulps`: any difference
// at all), and the largest |kernel - f64| / sum |terms| of an element; and
// the blocks of each launch. The kernels' shared memory starts as NaN, and
// so do their outputs.

#include <cstdlib>
#include <functional>
#include <memory>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "ctrgc_tile.cuh"

thread_local dim3 emu_threadIdx, emu_blockIdx;
dim3 emu_gridDim;
std::barrier<>* emu_bar;
namespace ctrgc {
alignas(16) float4 smem4[1 << 16];  // the kernels' extern __shared__ array
}

namespace {

using bf16 = __nv_bfloat16;

void launch(long long grid, size_t smem, const std::function<void()>& body) {
  if (smem > sizeof(ctrgc::smem4)) std::abort();
  emu_gridDim = dim3(unsigned(grid));
  for (long long x = 0; x < grid; ++x) {
    float* s = reinterpret_cast<float*>(ctrgc::smem4);
    std::fill(s, s + smem / 4 + 1, NAN);
    std::barrier<> bar(ctrgc::THREADS);
    emu_bar = &bar;
    std::vector<std::thread> team;
    for (int t = 0; t < ctrgc::THREADS; ++t)
      team.emplace_back([&, t, x] {
        emu_threadIdx = dim3(t);
        emu_blockIdx = dim3(unsigned(x));
        body();
      });
    for (auto& th : team) th.join();
  }
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
bool same(float a, float b) { return std::memcmp(&a, &b, 4) == 0; }
bool same(bf16 a, bf16 b) { return a.x == b.x; }

std::mt19937 rng(11);

template <typename T>
std::shared_ptr<T[]> randn(size_t n) {
  std::normal_distribution<float> d(0.f, 1.f);
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

// one output element: the kernel's value against the same fused
// multiply-adds in its order, and against f64 over sum |terms|
struct Error {
  long long ulps = 0;
  double err = 0;
  template <typename T>
  void add(T got, float ordered, double want, double abs_terms) {
    ulps += !same(got, to<T>(ordered));
    const double g = f32(got);
    if (!std::isfinite(g)) {
      err = INFINITY;
      return;
    }
    err = std::max(err, std::fabs(g - want) / std::max(abs_terms, 1e-30));
  }
  void print(const char* name) const {
    std::printf("%s_ulps %lld\n%s %.3e\n", name, ulps, name, err);
  }
};

template <typename T>
int run(int n, int k, int c, int t, int v) {
  const size_t xs = size_t(n) * k * c * t * v, ss = size_t(n) * k * c * v * v;
  const size_t zs = size_t(n) * c * t * v;
  const auto x3 = randn<T>(xs);
  const auto dz = randn<T>(zs);
  const auto s = randn<float>(ss);
  auto z = nans<T>(zs);
  auto dx3 = nans<T>(xs);
  auto ds = nans<float>(ss);

  // the launches as ctrgc_fwd.cu and ctrgc_bwd.cu make them
  const ctrgc::Geometry g(k, t, v);
  const long long planes = (long long)n * c;
  const size_t fwd_plane = ctrgc::fwd_plane_bytes(g, sizeof(T));
  const int fwd_ppb = ctrgc::planes_per_block(g.fwd_items(), fwd_plane);
  const long long fwd_grid = (planes + fwd_ppb - 1) / fwd_ppb;
  launch(fwd_grid, fwd_ppb * fwd_plane, [&] {
    ctrgc::aggregate_fwd<T>(x3.get(), s.get(), z.get(), planes, k, c, t, v,
                            fwd_ppb);
  });
  const size_t bwd_plane = ctrgc::bwd_plane_bytes(g, sizeof(T));
  const int bwd_ppb = ctrgc::planes_per_block(g.bwd_items(), bwd_plane);
  const long long bwd_grid = (planes + bwd_ppb - 1) / bwd_ppb;
  launch(bwd_grid, bwd_ppb * bwd_plane, [&] {
    ctrgc::aggregate_bwd<T>(dz.get(), x3.get(), s.get(), dx3.get(), ds.get(),
                            planes, k, c, t, v, bwd_ppb);
  });

  auto X = [&](int ni, int ki, int ci, int ti, int vi) {
    return f32(x3[(((size_t(ni) * k + ki) * c + ci) * t + ti) * v + vi]);
  };
  auto S = [&](int ni, int ki, int ci, int ui, int vi) {
    return s[(((size_t(ni) * k + ki) * c + ci) * v + ui) * v + vi];
  };
  auto DZ = [&](int ni, int ci, int ti, int ui) {
    return f32(dz[((size_t(ni) * c + ci) * t + ti) * v + ui]);
  };
  Error e_z, e_dx, e_ds;
  for (int ni = 0; ni < n; ++ni)
    for (int ci = 0; ci < c; ++ci) {
      for (int ti = 0; ti < t; ++ti)
        for (int ui = 0; ui < v; ++ui) {
          float acc = 0.f;
          double want = 0, abs_terms = 0;
          for (int ki = 0; ki < k; ++ki)
            for (int vi = 0; vi < v; ++vi) {
              const float a = X(ni, ki, ci, ti, vi), b = S(ni, ki, ci, ui, vi);
              acc = std::fmaf(a, b, acc);
              want += double(a) * b;
              abs_terms += std::fabs(double(a) * b);
            }
          e_z.add(z[((size_t(ni) * c + ci) * t + ti) * v + ui], acc, want,
                  abs_terms);
        }
      for (int ki = 0; ki < k; ++ki) {
        for (int ti = 0; ti < t; ++ti)
          for (int vi = 0; vi < v; ++vi) {
            float acc = 0.f;
            double want = 0, abs_terms = 0;
            for (int ui = 0; ui < v; ++ui) {
              const float a = DZ(ni, ci, ti, ui), b = S(ni, ki, ci, ui, vi);
              acc = std::fmaf(a, b, acc);
              want += double(a) * b;
              abs_terms += std::fabs(double(a) * b);
            }
            e_dx.add(dx3[(((size_t(ni) * k + ki) * c + ci) * t + ti) * v + vi],
                     acc, want, abs_terms);
          }
        for (int ui = 0; ui < v; ++ui)
          for (int vi = 0; vi < v; ++vi) {
            float acc = 0.f;
            double want = 0, abs_terms = 0;
            for (int ti = 0; ti < t; ++ti) {
              const float a = DZ(ni, ci, ti, ui), b = X(ni, ki, ci, ti, vi);
              acc = std::fmaf(a, b, acc);
              want += double(a) * b;
              abs_terms += std::fabs(double(a) * b);
            }
            e_ds.add(ds[(((size_t(ni) * k + ki) * c + ci) * v + ui) * v + vi],
                     acc, want, abs_terms);
          }
      }
    }
  e_z.print("z");
  e_dx.print("dx3");
  e_ds.print("ds");
  std::printf("fwd_blocks %lld\nbwd_blocks %lld\n", fwd_grid, bwd_grid);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const int n = std::atoi(argv[1]), k = std::atoi(argv[2]);
  const int c = std::atoi(argv[3]), t = std::atoi(argv[4]);
  const int v = std::atoi(argv[5]);
  const std::string dtype(argv[6]);
  if (dtype == "f32") return run<float>(n, k, c, t, v);
  if (dtype == "bf16") return run<bf16>(n, k, c, t, v);
  return 2;
}
