// Runs the spline radar kernels of csrc/radar_spline.cuh (kernel #6's
// forward, kernel #7's backward in both instances and their sums) in the
// CPU emulation of cuda_shim.h and holds them against an f64
// transcription of their plain versions.
//
//   radar_harness N T_IN UP TILE EM LAMBDA ZERO_BODY SHUFFLE
//
// The monomials are laid out as spline_tile_plan lays them out: T_IN - 1
// segments over T_IN * UP rows on a uniform grid, each tile's rows in
// nondecreasing slots, rows past t_out zero. The coefficients, c and the
// output cotangent come from a fixed seed; with ZERO_BODY = 1 the second
// half of the last sample's pairs is an all-zero body (zero coefficients,
// c = 0); with SHUFFLE = 1 the slots of tile 0 run backwards, which the
// full backward must answer with NaN in that tile's dsrc/ddst. Prints, one
// "name value" a line: the largest |kernel - reference| over the largest
// sum of |terms| of an output (f32 rounding of a sum grows with its terms,
// not with its result, which cancels: dc, dloc and dlam sum terms of
// random sign) of re, im, dsrc, ddst (tiles 1 on with SHUFFLE), dc, dloc
// and dlam, the same of the loc/lambda instance's dloc and dlam
// (dloc_ll, dlam_ll), whether they equal the full instance's bit for bit
// (loc_lam_same), whether a second launch of every kernel gave the same
// bits (repeat), the largest number of slots a tile spans (max_slots) and
// the (sample, tile) blocks whose dsrc holds a NaN (nan_blocks). Shared
// memory starts as NaN, so a read of anything a kernel did not write
// shows, and the part past a block's allocation must still be NaN after
// the block.

#include <cstring>
#include <functional>
#include <random>
#include <thread>
#include <vector>

#include "radar_spline.cuh"

thread_local dim3 emu_threadIdx, emu_blockIdx;
dim3 emu_gridDim;
std::barrier<>* emu_bar;
namespace radar_spline {
alignas(16) float4 smem4[1 << 15];  // the kernels' extern __shared__ array
}

namespace {

namespace rs = radar_spline;
using Vec = std::vector<float>;

void launch(dim3 grid, int threads, size_t smem,
            const std::function<void()>& body) {
  constexpr size_t floats = sizeof(rs::smem4) / 4;
  float* s = reinterpret_cast<float*>(rs::smem4);
  if (smem > sizeof(rs::smem4)) std::abort();
  emu_gridDim = grid;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      std::fill(s, s + floats, NAN);
      std::barrier<> bar(threads);
      emu_bar = &bar;
      std::vector<std::thread> team;
      for (int t = 0; t < threads; ++t)
        team.emplace_back([&, t, x, y] {
          emu_threadIdx = dim3(t);
          emu_blockIdx = dim3(x, y);
          body();
        });
      for (auto& th : team) th.join();
      for (size_t i = smem / 4; i < floats; ++i)
        if (!std::isnan(s[i])) std::abort();  // wrote past it
    }
}

struct Shape {
  int n, t_out, tile, em, num_tiles, ns4;
};

struct Out {
  Vec re, im, dsrc, ddst, dc, dloc, dlam, dloc_ll, dlam_ll;
};

void run(const Shape& a, const Vec& e, const Vec& src, const Vec& dst,
         const Vec& c, const Vec& loc, const Vec& lam, const Vec& gre,
         const Vec& gim, Out& o) {
  const size_t out = size_t(a.n) * a.t_out, coef = src.size();
  o.re.assign(out, NAN);
  o.im.assign(out, NAN);
  o.dsrc.assign(coef, NAN);
  o.ddst.assign(coef, NAN);
  o.dc.assign(size_t(a.n) * a.em, NAN);
  o.dloc.assign(3, NAN);
  o.dlam.assign(1, NAN);
  o.dloc_ll.assign(3, NAN);
  o.dlam_ll.assign(1, NAN);
  const dim3 grid(a.num_tiles, a.n);
  launch(grid, rs::kFwdThreads, rs::fwd_smem_bytes(a.ns4, a.em), [&] {
    rs::fwd_kernel(e.data(), src.data(), dst.data(), c.data(), loc.data(),
                   lam.data(), o.re.data(), o.im.data(), a.num_tiles, a.ns4,
                   a.tile, a.em, a.t_out);
  });
  const size_t blocks = size_t(a.n) * a.num_tiles;
  for (const bool coef_grads : {true, false}) {
    Vec ws_dc(blocks * a.em, NAN), ws_s(blocks * 4, NAN);
    float* dloc = coef_grads ? o.dloc.data() : o.dloc_ll.data();
    float* dlam = coef_grads ? o.dlam.data() : o.dlam_ll.data();
    launch(grid, rs::kBwdThreads,
           rs::bwd_smem_bytes(a.ns4, a.tile, a.em, coef_grads), [&] {
             auto kernel = coef_grads ? rs::bwd_kernel<true>
                                      : rs::bwd_kernel<false>;
             kernel(e.data(), src.data(), dst.data(), c.data(), loc.data(),
                    lam.data(), gre.data(), gim.data(),
                    coef_grads ? o.dsrc.data() : nullptr,
                    coef_grads ? o.ddst.data() : nullptr,
                    coef_grads ? ws_dc.data() : nullptr, ws_s.data(),
                    a.num_tiles, a.ns4, a.tile, a.em, a.t_out);
           });
    launch(dim3(rs::reduce_blocks(a.n, a.em, coef_grads)),
           rs::kReduceThreads, 0, [&] {
             auto kernel = coef_grads ? rs::reduce_kernel<true>
                                      : rs::reduce_kernel<false>;
             kernel(ws_dc.data(), ws_s.data(),
                    coef_grads ? o.dc.data() : nullptr, dloc, dlam, a.n,
                    a.num_tiles, a.em);
           });
  }
}

// an f64 sum and the sum of its terms' magnitudes
struct Ref {
  std::vector<double> sum, abs;
  explicit Ref(size_t n) : sum(n, 0.0), abs(n, 0.0) {}
  void add(size_t i, double v) {
    sum[i] += v;
    abs[i] += std::fabs(v);
  }
};

double rel_err(const Vec& got, const Ref& want) {
  double m = 0, e = 0;
  for (size_t i = 0; i < want.sum.size(); ++i) {
    if (!std::isfinite(got[i])) return INFINITY;
    m = std::max(m, want.abs[i]);
    e = std::max(e, std::fabs(got[i] - want.sum[i]));
  }
  return e / (m > 0 ? m : 1);
}

bool same(const Vec& p, const Vec& q) {
  return p.size() == q.size() &&
         std::memcmp(p.data(), q.data(), 4 * p.size()) == 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int n = std::atoi(argv[1]), t_in = std::atoi(argv[2]),
            up = std::atoi(argv[3]), tile = std::atoi(argv[4]),
            em = std::atoi(argv[5]);
  const float lam_v = float(std::atof(argv[6]));
  const bool zero_body = std::atoi(argv[7]), shuffle = std::atoi(argv[8]);
  const int t_out = t_in * up, nseg = t_in - 1;
  const int num_tiles = (t_out + tile - 1) / tile;

  // the plan: each row's segment and u on the uniform knots, the tiles'
  // first segments and slot counts
  std::vector<int> seg(size_t(num_tiles) * tile);
  std::vector<double> u(seg.size(), 0.0);
  for (int t = 0; t < num_tiles * tile; ++t) {
    const int row = std::min(t, t_out - 1);
    const double x = double(row) / (t_out - 1) * nseg;
    seg[t] = std::min(int(x), nseg - 1);
    if (t < t_out) u[t] = (x - seg[t]) / nseg;
  }
  int ns = 0;
  std::vector<int> first(num_tiles);
  for (int j = 0; j < num_tiles; ++j) {
    first[j] = seg[size_t(j) * tile];
    ns = std::max(ns, seg[size_t(j) * tile + tile - 1] - first[j] + 1);
  }
  int max_slots = 0;
  for (int j = 0; j < num_tiles; ++j) {
    const int last = std::min((j + 1) * tile, t_out) - 1;
    if (j * tile < t_out)
      max_slots = std::max(max_slots, seg[last] - first[j] + 1);
  }
  const int ns4 = 4 * ns;
  auto slot_of = [&](int j, int t) {
    const int s = seg[t] - first[j];
    return shuffle && j == 0 ? ns - 1 - s : s;
  };
  Vec e(size_t(num_tiles) * ns4 * tile, 0.0f);
  for (int j = 0; j < num_tiles; ++j)
    for (int r = 0; r < tile; ++r) {
      const int t = j * tile + r;
      if (t >= t_out) continue;
      for (int k = 0; k < 4; ++k)
        e[(size_t(j) * ns4 + 4 * slot_of(j, t) + k) * tile + r] =
            float(std::pow(u[t], 3 - k));
    }

  // per-segment cubics of skeleton-like endpoints, as chip_smoke.py's
  // clips (normal x 0.3 m): the constant term ~0.3 m, each other term
  // ~0.1 m at the segment's end
  std::mt19937 rng(11);
  std::normal_distribution<double> normal(0.0, 1.0);
  const int f3 = 3 * em;
  std::vector<float> seg_src(size_t(n) * nseg * f3 * 4),
      seg_dst(seg_src.size());
  for (size_t i = 0; i < seg_src.size(); ++i) {
    const int k = int(i % 4);
    const double scale = (k == 3 ? 0.3 : 0.1) * std::pow(double(nseg), 3 - k);
    seg_src[i] = float(scale * normal(rng));
    seg_dst[i] = float(scale * normal(rng));
  }
  Vec c(size_t(n) * em);
  std::uniform_real_distribution<double> unif(0.005, 0.1);
  for (auto& v : c) v = float(unif(rng));
  auto empty = [&](int i, int p) {
    return zero_body && i == n - 1 && p >= em / 2;
  };
  for (int i = 0; i < n; ++i)
    for (int p = 0; p < em; ++p)
      if (empty(i, p)) c[size_t(i) * em + p] = 0.0f;
  Vec src(size_t(n) * num_tiles * f3 * ns4), dst(src.size());
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < num_tiles; ++j)
      for (int f = 0; f < f3; ++f)
        for (int s = 0; s < ns; ++s)
          for (int k = 0; k < 4; ++k) {
            const int sg = std::min(first[j] + s, nseg - 1);
            const int sl = shuffle && j == 0 ? ns - 1 - s : s;
            const size_t at =
                ((size_t(i) * num_tiles + j) * f3 + f) * ns4 + 4 * sl + k;
            const size_t from = ((size_t(i) * nseg + sg) * f3 + f) * 4 + k;
            const bool zero = empty(i, f % em);
            src[at] = zero ? 0.0f : seg_src[from];
            dst[at] = zero ? 0.0f : seg_dst[from];
          }
  const Vec loc = {0.1f, -0.2f, 0.3f}, lam = {lam_v};
  Vec gre(size_t(n) * t_out), gim(gre.size());
  for (auto& v : gre) v = float(normal(rng));
  for (auto& v : gim) v = float(normal(rng));

  // the f64 transcription of the plain versions
  Ref re_ref(gre.size()), im_ref(gre.size()), dsrc_ref(src.size()),
      ddst_ref(src.size()), dc_ref(c.size()), dloc_ref(3), dlam_ref(1);
  const double pi = 3.14159265358979323846;
  const double k = double(float(4 * pi)) / lam_v;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < num_tiles; ++j)
      for (int r = 0; r < tile; ++r) {
        const int t = j * tile + r;
        if (t >= t_out) continue;
        const int s = slot_of(j, t);
        double m[4];
        for (int q = 0; q < 4; ++q)
          m[q] = e[(size_t(j) * ns4 + 4 * s + q) * tile + r];
        const size_t at = size_t(i) * t_out + t;
        for (int p = 0; p < em; ++p) {
          double sp[3], dp[3];
          for (int co = 0; co < 3; ++co) {
            const size_t base =
                ((size_t(i) * num_tiles + j) * f3 + co * em + p) * ns4 + 4 * s;
            sp[co] = dp[co] = 0;
            for (int q = 0; q < 4; ++q) {
              sp[co] += double(src[base + q]) * m[q];
              dp[co] += double(dst[base + q]) * m[q];
            }
          }
          const double cv = c[size_t(i) * em + p];
          double rv[3], av[3], bv[3], dist2 = 0, dot = 0, a2 = 0, b2 = 0;
          for (int co = 0; co < 3; ++co) {
            rv[co] = sp[co] - loc[co];
            av[co] = loc[co] - (sp[co] + dp[co]) * 0.5;
            bv[co] = dp[co] - sp[co];
            dist2 += rv[co] * rv[co];
            dot += av[co] * bv[co];
            a2 += av[co] * av[co];
            b2 += bv[co] * bv[co];
          }
          const double dist = std::sqrt(dist2), na = std::sqrt(a2),
                       nb = std::sqrt(b2), den = na * nb + 1e-6;
          const double ct = dot / den, ct2 = ct * ct;
          const double uu = (1 - ct2) + cv * ct2, au = std::fabs(uu);
          const double amp = std::sqrt(pi * cv) / au, phase = k * dist;
          const double cp = std::cos(phase), sp_ = std::sin(phase);
          re_ref.add(at, amp * cp);
          im_ref.add(at, amp * sp_);
          const double g_amp = gre[at] * cp + gim[at] * sp_;
          const double g_phase = amp * (gim[at] * cp - gre[at] * sp_);
          const double g_u = (uu > 0 ? 1 : uu < 0 ? -1 : 0) *
                             (-(amp / au) * g_amp);
          const double g_ct = g_u * (2 * ct * (cv - 1));
          const double g_dot = g_ct / den, g_den = g_ct * (-ct / den);
          const double inv_na = na > 0 ? 1 / na : 0,
                       inv_nb = nb > 0 ? 1 / nb : 0,
                       inv_d = dist > 0 ? 1 / dist : 0;
          dc_ref.add(size_t(i) * em + p,
                     g_u * ct2 + g_amp * (cv > 0 ? amp / (2 * cv) : 0));
          dlam_ref.add(0, (-k / lam_v) * (g_phase * dist));
          for (int co = 0; co < 3; ++co) {
            const double g_a = g_dot * bv[co] + g_den * nb * av[co] * inv_na;
            const double g_b = g_dot * av[co] + g_den * na * bv[co] * inv_nb;
            const double g_r = g_phase * k * rv[co] * inv_d;
            dloc_ref.add(co, g_a - g_r);
            const size_t base =
                ((size_t(i) * num_tiles + j) * f3 + co * em + p) * ns4 + 4 * s;
            for (int q = 0; q < 4; ++q) {
              dsrc_ref.add(base + q, (g_r - 0.5 * g_a - g_b) * m[q]);
              ddst_ref.add(base + q, (g_b - 0.5 * g_a) * m[q]);
            }
          }
        }
      }

  const Shape shape{n, t_out, tile, em, num_tiles, ns4};
  Out o, o2;
  run(shape, e, src, dst, c, loc, lam, gre, gim, o);
  run(shape, e, src, dst, c, loc, lam, gre, gim, o2);

  int nan_blocks = 0;
  const size_t per = size_t(f3) * ns4;
  for (size_t b = 0; b < size_t(n) * num_tiles; ++b)
    for (size_t i = 0; i < per; ++i)
      if (std::isnan(o.dsrc[b * per + i])) {
        ++nan_blocks;
        break;
      }
  // with SHUFFLE, tile 0's blocks are NaN by design: compare the others
  Vec dsrc = o.dsrc, ddst = o.ddst;
  if (shuffle)
    for (int i = 0; i < n; ++i)
      for (size_t q = 0; q < per; ++q) {
        const size_t at = size_t(i) * num_tiles * per + q;
        dsrc[at] = float(dsrc_ref.sum[at]);
        ddst[at] = float(ddst_ref.sum[at]);
      }
  std::printf("re %.3e\nim %.3e\n", rel_err(o.re, re_ref),
              rel_err(o.im, im_ref));
  std::printf("dsrc %.3e\nddst %.3e\ndc %.3e\n", rel_err(dsrc, dsrc_ref),
              rel_err(ddst, ddst_ref), rel_err(o.dc, dc_ref));
  std::printf("dloc %.3e\ndlam %.3e\n", rel_err(o.dloc, dloc_ref),
              rel_err(o.dlam, dlam_ref));
  std::printf("dloc_ll %.3e\ndlam_ll %.3e\n", rel_err(o.dloc_ll, dloc_ref),
              rel_err(o.dlam_ll, dlam_ref));
  std::printf("loc_lam_same %d\n",
              int(same(o.dloc, o.dloc_ll) && same(o.dlam, o.dlam_ll)));
  const bool repeat = same(o.re, o2.re) && same(o.im, o2.im) &&
                      std::memcmp(o.dsrc.data(), o2.dsrc.data(),
                                  4 * o.dsrc.size()) == 0 &&
                      std::memcmp(o.ddst.data(), o2.ddst.data(),
                                  4 * o.ddst.size()) == 0 &&
                      same(o.dc, o2.dc) && same(o.dloc, o2.dloc) &&
                      same(o.dlam, o2.dlam) && same(o.dloc_ll, o2.dloc_ll) &&
                      same(o.dlam_ll, o2.dlam_ll);
  std::printf("repeat %d\nmax_slots %d\nnan_blocks %d\n", int(repeat),
              max_slots, nan_blocks);
  return 0;
}
