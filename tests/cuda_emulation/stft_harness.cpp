// Runs the STFT log-magnitude kernels of csrc/stft_fft.cuh (the forward,
// the backward and its reflect fold) in the CPU emulation of cuda_shim.h
// and holds them against f64 references: a direct DFT of the windowed
// frames and its adjoint.
//
//   stft_harness N_FFT HOP F T SIGNALS CENTER FFTSHIFT HAMMING
//
// The signals and the cotangent g come from a fixed seed; the window is the
// periodic Hann window, or with HAMMING = 1 the periodic Hamming window
// (w[0] = 0.08: the padding's first sample gets a cotangent), rounded to
// f32 as the wrapper hands over cos[0, :]. Prints, one
// "name value" a line: the largest |log-magnitude - reference| (log), the
// largest |exp(log-magnitude) - (|S| + eps)| over the largest |S| + eps
// (mag), the largest |dre - reference| and |dim - reference| over the
// largest reference value (dre, dim), and whether a second launch of each
// kernel gave the same bits (repeat, 1 or 0). Shared memory starts as NaN,
// so a read of anything a kernel did not write shows, and the part past a
// block's allocation must still be NaN after the block.

#include <cstring>
#include <functional>
#include <random>
#include <thread>
#include <vector>

#include "stft_fft.cuh"

thread_local dim3 emu_threadIdx, emu_blockIdx;
dim3 emu_gridDim;
std::barrier<>* emu_bar;
namespace stft_fft {
float smem[1 << 16];  // the kernels' extern __shared__ array
}

namespace {

namespace sf = stft_fft;
constexpr double kPi = 3.14159265358979323846;
constexpr float kEps = 1e-6f;

void launch(dim3 grid, int threads, size_t smem,
            const std::function<void()>& body) {
  constexpr size_t floats = sizeof(sf::smem) / 4;
  if (smem > sizeof(sf::smem)) std::abort();
  emu_gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::fill(sf::smem, sf::smem + floats, NAN);
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
        for (size_t i = smem / 4; i < floats; ++i)
          if (!std::isnan(sf::smem[i])) std::abort();  // wrote past it
      }
}

struct Args {
  int n_fft, hop, f, t, n, pad, fftshift, frames;
};

template <int N>
void run(const Args& a, const std::vector<float>& re,
         const std::vector<float>& im, const std::vector<float>& w,
         const std::vector<float>& tw, const std::vector<float>& g,
         std::vector<float>& out, std::vector<float>& dre,
         std::vector<float>& dim) {
  std::fill(out.begin(), out.end(), NAN);
  std::fill(dre.begin(), dre.end(), NAN);
  std::fill(dim.begin(), dim.end(), NAN);
  std::vector<float> edges(size_t(a.n) * 4 * a.pad + 1, NAN);
  constexpr int fg = sf::frames_per_round(N);
  launch(dim3((a.frames + fg - 1) / fg, a.n), sf::kThreads,
         4 * sf::fwd_smem_floats(N, a.hop), [&] {
           sf::fwd_kernel<N>(re.data(), im.data(), w.data(), tw.data(),
                             out.data(), a.t, a.hop, a.f, a.frames, a.pad,
                             a.fftshift, kEps);
         });
  const int len = sf::bwd_plan(N, a.hop).len, tp = a.t + 2 * a.pad;
  launch(dim3((tp + len - 1) / len, a.n), sf::kThreads,
         4 * sf::bwd_smem_floats(N, a.hop, a.f), [&] {
           sf::bwd_kernel<N>(re.data(), im.data(), w.data(), tw.data(),
                             g.data(), dre.data(), dim.data(), edges.data(),
                             a.t, a.hop, a.f, a.frames, a.pad, a.fftshift,
                             kEps);
         });
  if (a.pad > 0) {
    const int count = sf::fold_count(a.t, a.pad);
    launch(dim3((count + sf::kThreads - 1) / sf::kThreads, a.n),
           sf::kThreads, 0, [&] {
             sf::fold_kernel(dre.data(), dim.data(), edges.data(), a.t,
                             a.pad);
           });
  }
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
  if (argc != 9) return 2;
  Args a{};
  a.n_fft = std::atoi(argv[1]);
  a.hop = std::atoi(argv[2]);
  a.f = std::atoi(argv[3]);
  a.t = std::atoi(argv[4]);
  a.n = std::atoi(argv[5]);
  a.pad = std::atoi(argv[6]) ? a.n_fft / 2 : 0;
  a.fftshift = std::atoi(argv[7]);
  const double w0 = std::atoi(argv[8]) ? 0.54 : 0.5;
  const int N = a.n_fft, tp = a.t + 2 * a.pad;
  a.frames = (tp - N) / a.hop + 1;

  std::mt19937 rng(7);
  std::normal_distribution<float> normal(0.f, 1.f);
  std::vector<float> re(size_t(a.n) * a.t), im(re.size());
  for (auto& v : re) v = normal(rng);
  for (auto& v : im) v = normal(rng);
  std::vector<float> g(size_t(a.n) * a.f * a.frames);
  for (auto& v : g) v = normal(rng);
  std::vector<float> w(N), tw(2 * N);
  std::vector<double> c(N), s(N);
  for (int m = 0; m < N; ++m) {
    w[m] = float(w0 - (1 - w0) * std::cos(2 * kPi * m / N));
    c[m] = std::cos(2 * kPi * m / N);
    s[m] = std::sin(2 * kPi * m / N);
    tw[2 * m] = float(c[m]);
    tw[2 * m + 1] = float(s[m]);
  }

  // f64 references
  auto reflect = [&](int p) {
    int q = p - a.pad;
    return q < 0 ? -q : q >= a.t ? 2 * (a.t - 1) - q : q;
  };
  auto row = [&](int k) {
    return a.fftshift ? (k + a.f / 2) % a.f : k;
  };
  std::vector<double> lmag(g.size()), mag(g.size()), dre_ref(re.size()),
      dim_ref(re.size());
  std::vector<double> xr(N), xi(N), gr(N), gi(N);
  for (int n = 0; n < a.n; ++n)
    for (int i = 0; i < a.frames; ++i) {
      for (int m = 0; m < N; ++m) {
        const size_t at = size_t(n) * a.t + reflect(i * a.hop + m);
        xr[m] = double(re[at]) * w[m];
        xi[m] = double(im[at]) * w[m];
      }
      for (int k = 0; k < N; ++k) {
        gr[k] = gi[k] = 0;
        if (k >= a.f) continue;
        double sr = 0, si = 0;
        for (int m = 0; m < N; ++m) {
          const int e = int((long(k) * m) % N);
          sr += xr[m] * c[e] + xi[m] * s[e];
          si += xi[m] * c[e] - xr[m] * s[e];
        }
        const double m2 = sr * sr + si * si, mg = std::sqrt(m2);
        const size_t at = (size_t(n) * a.f + row(k)) * a.frames + i;
        lmag[at] = std::log(mg + kEps);
        mag[at] = mg + kEps;
        const double inv = m2 > 0 ? 1 / (mg * (mg + kEps)) : 0;
        gr[k] = g[at] * inv * sr;
        gi[k] = g[at] * inv * si;
      }
      for (int m = 0; m < N; ++m) {
        double dr = 0, di = 0;
        for (int k = 0; k < a.f; ++k) {
          const int e = int((long(k) * m) % N);
          dr += gr[k] * c[e] - gi[k] * s[e];
          di += gr[k] * s[e] + gi[k] * c[e];
        }
        const size_t at = size_t(n) * a.t + reflect(i * a.hop + m);
        dre_ref[at] += w[m] * dr;
        dim_ref[at] += w[m] * di;
      }
    }

  std::vector<float> out(g.size()), dre(re.size()), dim(re.size());
  std::vector<float> out2(g.size()), dre2(re.size()), dim2(re.size());
  auto both = [&](auto run_n) {
    run_n(out, dre, dim);
    run_n(out2, dre2, dim2);
  };
#define RUN(NN)                                                          \
  case NN:                                                               \
    both([&](auto& o, auto& d1, auto& d2) {                              \
      run<NN>(a, re, im, w, tw, g, o, d1, d2);                           \
    });                                                                  \
    break;
  switch (N) {
    RUN(64)
    RUN(128)
    RUN(256)
    RUN(512)
    RUN(1024)
    default:
      return 2;
  }
#undef RUN

  double log_err = 0, mag_err = 0, mag_max = 0;
  for (size_t i = 0; i < out.size(); ++i) {
    if (!std::isfinite(out[i])) {
      log_err = mag_err = INFINITY;
      break;
    }
    log_err = std::max(log_err, std::fabs(out[i] - lmag[i]));
    mag_err = std::max(mag_err, std::fabs(std::exp(double(out[i])) - mag[i]));
    mag_max = std::max(mag_max, mag[i]);
  }
  auto same = [](const std::vector<float>& p, const std::vector<float>& q) {
    return std::memcmp(p.data(), q.data(), 4 * p.size()) == 0;
  };
  std::printf("log %.3e\nmag %.3e\n", log_err, mag_err / mag_max);
  std::printf("dre %.3e\ndim %.3e\n", rel_err(dre, dre_ref),
              rel_err(dim, dim_ref));
  std::printf("repeat %d\n",
              int(same(out, out2) && same(dre, dre2) && same(dim, dim2)));
  return 0;
}
