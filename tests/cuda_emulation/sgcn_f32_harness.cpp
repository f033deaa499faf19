// Runs the f32 spatial graph-conv kernels of csrc/sgcn_tile_f32.cuh in the
// CPU emulation of cuda_shim.h and holds them against f64 references.
//
//   sgcn_f32_harness ADJACENCY FRAMES C_IN C_OUT
//
// ADJACENCY: a file of the (3, 25, 25) f32 adjacency. The inputs come from
// a fixed seed. Prints the largest |kernel - reference| / max |reference|
// of out (forward and stats entries), the two channel sums, dx, dW and db,
// one "name value" a line. A block's shared memory starts as NaN, so that
// a read of anything a kernel did not write shows.

#include <functional>
#include <random>
#include <thread>
#include <vector>

#include "sgcn_tile_f32.cuh"

thread_local dim3 emu_threadIdx, emu_blockIdx;
dim3 emu_gridDim;
std::barrier<>* emu_bar;
namespace sgcn_f32 {
alignas(16) float4 smem4[1 << 16];  // the kernels' extern __shared__ array
}

namespace {

constexpr int V = 25, K = 3;

void launch(dim3 grid, int threads, size_t smem,
            const std::function<void()>& body) {
  if (smem > sizeof(sgcn_f32::smem4)) std::abort();
  emu_gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        float* s = reinterpret_cast<float*>(sgcn_f32::smem4);
        std::fill(s, s + smem / 4, NAN);
        std::barrier<> bar(threads);
        emu_bar = &bar;
        std::vector<std::thread> team;
        for (int t = 0; t < threads; ++t)
          team.emplace_back([&, t, x, y, z] {
            emu_threadIdx = dim3(t);
            emu_blockIdx = dim3(x, y, z);
            body();
          });
        for (auto& th : team) th.join();
      }
}

std::mt19937 rng(1);

std::vector<float> randn(size_t n, float scale) {
  std::normal_distribution<float> d(0.f, scale);
  std::vector<float> v(n);
  for (auto& e : v) e = d(rng);
  return v;
}

double rel_err(const std::vector<float>& got, const std::vector<double>& want) {
  double m = 0, e = 0;
  for (size_t i = 0; i < want.size(); ++i) {
    if (!std::isfinite(got[i])) return INFINITY;
    m = std::max(m, std::fabs(want[i]));
    e = std::max(e, std::fabs(got[i] - want[i]));
  }
  return e / (m > 0 ? m : 1);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  std::vector<float> a(K * V * V);
  FILE* fa = std::fopen(argv[1], "rb");
  if (!fa || std::fread(a.data(), 4, a.size(), fa) != a.size()) return 2;
  std::fclose(fa);
  const int F = std::atoi(argv[2]), ci = std::atoi(argv[3]),
            co = std::atoi(argv[4]), R = F * V;
  const auto x = randn(size_t(R) * ci, 1.f);
  const auto w = randn(size_t(K) * co * ci, std::sqrt(2.f / ci));
  const auto b = randn(K * co, 1.f), g = randn(size_t(R) * co, 1.f);
  std::vector<float> wt(w.size());  // W^T, as the wrapper hands it over
  for (int n = 0; n < K * co; ++n)
    for (int c = 0; c < ci; ++c)
      wt[size_t(c) * K * co + n] = w[size_t(n) * ci + c];

  // f64 references
  std::vector<double> z(size_t(R) * K * co), out(size_t(R) * co), s(co),
      ss(co);
  for (int r = 0; r < R; ++r)
    for (int n = 0; n < K * co; ++n) {
      double acc = b[n];
      for (int c = 0; c < ci; ++c)
        acc += double(x[size_t(r) * ci + c]) * w[size_t(n) * ci + c];
      z[size_t(r) * K * co + n] = acc;
    }
  for (int f = 0; f < F; ++f)
    for (int wv = 0; wv < V; ++wv)
      for (int o = 0; o < co; ++o) {
        double acc = 0;
        for (int kv = 0; kv < K * V; ++kv)
          acc += a[kv * V + wv] *
                 z[size_t(f * V + kv % V) * K * co + kv / V * co + o];
        out[size_t(f * V + wv) * co + o] = acc;
        s[o] += acc;
        ss[o] += acc * acc;
      }
  std::vector<double> dz(size_t(R) * K * co), dx(size_t(R) * ci),
      dw(size_t(K) * co * ci), db(K * co);
  for (int f = 0; f < F; ++f)
    for (int kv = 0; kv < K * V; ++kv)
      for (int o = 0; o < co; ++o) {
        double acc = 0;
        for (int wv = 0; wv < V; ++wv)
          acc += a[kv * V + wv] * double(g[size_t(f * V + wv) * co + o]);
        dz[size_t(f * V + kv % V) * K * co + kv / V * co + o] = acc;
      }
  for (int r = 0; r < R; ++r)
    for (int n = 0; n < K * co; ++n) {
      const double d = dz[size_t(r) * K * co + n];
      db[n] += d;
      for (int c = 0; c < ci; ++c) {
        dx[size_t(r) * ci + c] += d * w[size_t(n) * ci + c];
        dw[size_t(n) * ci + c] += d * x[size_t(r) * ci + c];
      }
    }

  // the kernels, launched as sgcn_fwd.cu and sgcn_bwd.cu launch them; the
  // partials summed here in their order
  namespace f = sgcn_f32;
  const int frame_tiles = (F + f::MF - 1) / f::MF;
  std::vector<float> kout(out.size(), NAN), kout2(out.size(), NAN),
      part(size_t(frame_tiles) * 2 * co, NAN);
  launch(dim3(f::fwd_blocks(F, co)), f::FWD_THREADS, sizeof(f::FwdSmem),
         [&] {
           f::fwd_kernel<false>(x.data(), wt.data(), b.data(), a.data(),
                                kout.data(), nullptr, F, ci, co);
         });
  launch(dim3(f::fwd_blocks(F, co)), f::FWD_THREADS, sizeof(f::FwdSmem),
         [&] {
           f::fwd_kernel<true>(x.data(), wt.data(), b.data(), a.data(),
                               kout2.data(), part.data(), F, ci, co);
         });
  std::vector<float> ks(co), kss(co);
  for (int p = 0; p < frame_tiles; ++p)
    for (int o = 0; o < co; ++o) {
      ks[o] += part[size_t(2 * p) * co + o];
      kss[o] += part[size_t(2 * p + 1) * co + o];
    }
  // ops/sgcn.py::backward_splits
  const int tiles =
      (co + f::DW_OC - 1) / f::DW_OC * ((ci + f::DW_N - 1) / f::DW_N);
  const int splits = std::max(1, std::min(2 * 132 / tiles, (F + 1) / 2));
  std::vector<float> kdx(dx.size(), NAN), wsw(size_t(splits) * dw.size(), NAN),
      wsb(size_t(splits) * db.size(), NAN);
  const bool narrow = ci <= f::NARROW_C_IN;
  launch(dim3(f::dx_blocks(F, ci)), f::DX_THREADS, sizeof(f::DxSmem), [&] {
    (narrow ? f::dx_kernel<true> : f::dx_kernel<false>)(
        g.data(), w.data(), a.data(), kdx.data(), F, ci, co);
  });
  launch(f::dw_grid(splits, ci, co), f::DW_THREADS, sizeof(f::DwSmem), [&] {
    (narrow ? f::dw_kernel<true> : f::dw_kernel<false>)(
        x.data(), g.data(), a.data(), wsw.data(), wsb.data(), F, ci, co);
  });
  std::vector<float> kdw(dw.size()), kdb(db.size());
  for (int sp = 0; sp < splits; ++sp) {
    for (size_t i = 0; i < kdw.size(); ++i) kdw[i] += wsw[sp * kdw.size() + i];
    for (size_t i = 0; i < kdb.size(); ++i) kdb[i] += wsb[sp * kdb.size() + i];
  }
  std::printf("out %.3e\nout_stats %.3e\ns %.3e\nss %.3e\n", rel_err(kout, out),
              rel_err(kout2, out), rel_err(ks, s), rel_err(kss, ss));
  std::printf("dx %.3e\ndW %.3e\ndb %.3e\n", rel_err(kdx, dx),
              rel_err(kdw, dw), rel_err(kdb, db));
  return 0;
}
