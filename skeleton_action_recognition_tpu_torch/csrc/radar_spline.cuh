// The spline radar kernels for Hopper (sm_90a): kernel #6's forward
// (radar_fwd.cu) and kernel #7's backward in its two instances
// (radar_bwd.cu), and the sums that finish the backward.
//
// Replaces the TPU kernels skeleton_action_recognition_tpu/ops/pallas/
// radar.py::_radar_spline_kernel (#6, called from _spline_fwd_impl) and
// _radar_spline_bwd_kernel (#7, called from _spline_vjp_bwd). For sample n
// and padded time row t = j * tile + r, every edge-body pair's endpoints
// are one cubic of the smoothed, upsampled spline,
//
//     s[f](t) = sum_q src[n, j, f, q] * e[j, q, r]       (f = coord * EM + em)
//
// and the return is re + i im = sum_em amp(s, d, c) exp(i phase(s)) with
// the math of radar_math.cuh. Inputs: monomials e (num_tiles, ns4, tile),
// the tiles' coefficients src/dst (N, num_tiles, 3 EM, ns4), c (N, EM),
// loc (3,) and lambda (a scalar) on the device; the backward also the
// output cotangent (gre, gim) (N, t_out). Rows past t_out (the grid
// padding, whose monomials are zero) are cut, as the JAX caller cuts them.
//
// The monomials are spline_tile_plan's: one-hot in (slot, k), row r of a
// tile evaluating only its slot's four terms u^(3 - k), and the slots of a
// tile's rows nondecreasing (a segment is a run of rows). The TPU
// contracted all 4 NS monomials on its matrix unit; here a row evaluates
// and contracts only its own slot (the other products are exact zeros).
//
// What bounds both on the H100: instruction issue on the CUDA cores. Each
// of the N * t_out * EM = 57.6 M (sample, row, pair) items at the
// trainer's shape (N = 16, t_out = 75,000, EM = 48) takes a precise sqrtf
// and sincosf (the phase 4 pi |s - l| / lambda is ~1e4-1e5 rad at lambda =
// 5e-4: both stay exact; sincosf's fast range reduction holds to |x| ~
// 1e5, larger phases take its slow path) and ~100 (forward) to ~200
// (backward) other instructions; the bytes are ~20 MB. So the design
// removes instructions:
//   * the amplitude's divisions, ct's norms and the cotangents' inverse
//     norms are approximate (MUFU reciprocal and square roots: a few ulp,
//     far inside the tolerance, where the exact phase is what f32 barely
//     holds);
//   * the forward (fwd_kernel) reads a pair's 24 coefficients of the row's
//     slot as six 16-byte shared loads and keeps two rows in flight a
//     thread;
//   * the backward (bwd_kernel) gives each thread one pair and a run of
//     contiguous rows. It keeps the 24 coefficients of the current slot
//     and, with kCoef, the 24 running sums g * m_k of the coefficient
//     cotangents and the sum of gc in registers, and flushes the sums to
//     shared memory only when the slot changes: no per-pair barrier, no
//     per-row shared traffic beyond the row's monomials and cotangent,
//     found once a row. Without kCoef (the trainer's case: only loc and
//     lambda train) it computes no gs, gd or gc at all; the chain both
//     instances share is rounded as written (fmul_rn, ffma_rn), so that
//     they give the same dloc and dlambda bits.
// Sums run in orders that depend on the shapes and the monomials alone:
// two launches on the same inputs agree bit for bit.
//
// At lambda = 5e-4 the raw dlambda (a 4 pi d / lambda^2 factor on every
// term) can overflow f32; the trainer's optimizer takes inf as a
// direction (train/optim.py).

#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "radar_math.cuh"

namespace radar_spline {

using radar::Point;

constexpr int kFwdThreads = 256;
constexpr int kFwdRows = 2;  // rows in flight a forward thread
constexpr int kBwdThreads = 192;
constexpr int kBwdPow2 = 128;  // the largest power of two <= kBwdThreads
constexpr int kReduceThreads = 256;
constexpr int kCoefs = 24;  // src and dst x 3 coordinates x 4 monomials

extern __shared__ float4 smem4[];

// The approximate f32 operations (MUFU) of the amplitude and of the
// cotangents' norms; the emulation on the CPU takes the exact ones. These
// two count subnormal inputs as zero (ftz), where that moves no result: a
// square root under the 1e-6 that ct's denominator adds, and reciprocals
// of that denominator (>= 1e-6) and of |u| (subnormal only where amp is
// 0 / 0 anyway).
__device__ __forceinline__ float sqrt_approx(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return sqrtf(x);
#endif
}

__device__ __forceinline__ float rcp_approx(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / x;
#endif
}

// 1 / sqrt(x) and 1 / x, subnormals kept, and 0 where x <= 0: the JAX
// kernel's zero inverses of zero norms
__device__ __forceinline__ float rsqrt_or_zero(float x) {
#ifdef __CUDA_ARCH__
  return x > 0.0f ? rsqrtf(x) : 0.0f;
#else
  return x > 0.0f ? 1.0f / sqrtf(x) : 0.0f;
#endif
}

__device__ __forceinline__ float rcp_or_zero(float x) {
#ifdef __CUDA_ARCH__
  return x > 0.0f ? __fdividef(1.0f, x) : 0.0f;
#else
  return x > 0.0f ? 1.0f / x : 0.0f;
#endif
}

// f32 operations rounded as written: ptxas never fuses an fmul_rn and an
// fadd_rn into an FMA, nor splits an ffma_rn. The backward's loc/lambda
// chain is written with them, so that the two instances, whose other uses
// of its values differ, compute the same bits (where ptxas may fuse, it
// fused other products in each).
__device__ __forceinline__ float fmul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float fadd_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__device__ __forceinline__ float ffma_rn(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

// The slot of padded row r of a tile's monomials e_tile (ns4 rows of `tile`
// floats), found from its constant terms e[4 slot + 3] = 1, and the slot's
// four monomials m = (u^3, u^2, u, 1); -1 and zeros for a row with none.
__device__ __forceinline__ int row_slot(const float* e_tile, int ns4,
                                        int tile, int r, float4& m) {
  int slot = -1;
  for (int s = 0; s < ns4 / 4; ++s) {
    if (e_tile[(4 * s + 3) * tile + r] != 0.0f) slot = s;
  }
  m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (slot >= 0) {
    const float* q = e_tile + (size_t)4 * slot * tile + r;
    m = make_float4(q[0], q[tile], q[2 * tile], q[3 * tile]);
  }
  return slot;
}

// A coordinate at a row: its slot's four coefficients q against the row's
// monomials m, in the order of the one-hot contraction.
__device__ __forceinline__ float cubic(float4 q, float4 m) {
  return ffma_rn(q.w, m.w, ffma_rn(q.z, m.z, ffma_rn(q.y, m.y,
                                                     fmul_rn(q.x, m.x))));
}

// The 24 coefficients of pair p at slot s from the staged (3 EM, ns4)
// tiles: q[3 sd + coord], sd = 0 for src, 1 for dst.
__device__ __forceinline__ void load_coefs(const float* s_src,
                                           const float* s_dst, int em,
                                           int ns4, int p, int s,
                                           float4 q[6]) {
#pragma unroll
  for (int co = 0; co < 3; ++co) {
    const int at = (co * em + p) * ns4 + 4 * s;
    q[co] = *reinterpret_cast<const float4*>(s_src + at);
    q[3 + co] = *reinterpret_cast<const float4*>(s_dst + at);
  }
}

// One pair's return at one row, added to (re, im): radar::scatter_fwd with
// the amplitude's norms and divisions approximate, the phase exact.
__device__ __forceinline__ void fwd_pair(Point l, Point s, Point d, float c,
                                         float amp0, float k, float& re,
                                         float& im) {
  const float rx = s.x - l.x, ry = s.y - l.y, rz = s.z - l.z;
  const float dist = sqrtf(rx * rx + ry * ry + rz * rz);
  const float ax = l.x - (s.x + d.x) * 0.5f;
  const float ay = l.y - (s.y + d.y) * 0.5f;
  const float az = l.z - (s.z + d.z) * 0.5f;
  const float bx = d.x - s.x, by = d.y - s.y, bz = d.z - s.z;
  const float dot = ax * bx + ay * by + az * bz;
  const float a2 = ax * ax + ay * ay + az * az;
  const float b2 = bx * bx + by * by + bz * bz;
  // |a| |b| as one root; a zero-length bone gives ct = 0
  const float ct = dot * rcp_approx(sqrt_approx(a2 * b2) + 1e-6f);
  const float ct2 = ct * ct;
  // |.|: u can go epsilon-negative when |ct| creeps past 1 in f32
  const float amp = amp0 * rcp_approx(fabsf((1.0f - ct2) + c * ct2));
  float sinp, cosp;
  sincosf(k * dist, &sinp, &cosp);
  re += amp * cosp;
  im += amp * sinp;
}

// The per-pair constants of the backward: c, c - 1, sqrt(pi c), and 1 /
// (2c) where c > 0 (the JAX kernel's amp / 2c guard), else 0.
struct PairConst {
  float c, c_minus_1, amp0, half_inv_c;
};

// One pair's cotangents at one row from the output cotangent (gre, gim):
// of the radar location (gl) and lambda (glam, with klam = -k / lambda)
// always; with kCoef also of the endpoints (gs, gd) and of c (gc).
// radar::scatter_bwd's chain and guards (sign(u), amp / 2c only where c >
// 0, zero inverses of zero norms) with approximate reciprocals; the phase
// and its sine and cosine exact.
template <bool kCoef>
__device__ __forceinline__ void bwd_pair(Point l, Point s, Point d,
                                         PairConst pc, float k, float klam,
                                         float gre, float gim, Point& gs,
                                         Point& gd, float& gc, Point& gl,
                                         float& glam) {
  // the loc/lambda chain, every operation rounded as written
  const float rx = fadd_rn(s.x, -l.x), ry = fadd_rn(s.y, -l.y),
              rz = fadd_rn(s.z, -l.z);
  const float dist =
      sqrtf(ffma_rn(rz, rz, ffma_rn(ry, ry, fmul_rn(rx, rx))));
  const float ax = ffma_rn(fadd_rn(s.x, d.x), -0.5f, l.x);
  const float ay = ffma_rn(fadd_rn(s.y, d.y), -0.5f, l.y);
  const float az = ffma_rn(fadd_rn(s.z, d.z), -0.5f, l.z);
  const float bx = fadd_rn(d.x, -s.x), by = fadd_rn(d.y, -s.y),
              bz = fadd_rn(d.z, -s.z);
  const float dot = ffma_rn(az, bz, ffma_rn(ay, by, fmul_rn(ax, bx)));
  const float a2 = ffma_rn(az, az, ffma_rn(ay, ay, fmul_rn(ax, ax)));
  const float b2 = ffma_rn(bz, bz, ffma_rn(by, by, fmul_rn(bx, bx)));
  const float inv_na = rsqrt_or_zero(a2), inv_nb = rsqrt_or_zero(b2);
  const float na = fmul_rn(a2, inv_na), nb = fmul_rn(b2, inv_nb);
  const float inv_den = rcp_approx(ffma_rn(na, nb, 1e-6f));
  const float ct = fmul_rn(dot, inv_den);
  const float ct2 = fmul_rn(ct, ct);
  const float u = ffma_rn(pc.c, ct2, fadd_rn(1.0f, -ct2));
  const float inv_au = rcp_approx(fabsf(u));
  const float amp = fmul_rn(pc.amp0, inv_au);
  float sinp, cosp;
  sincosf(fmul_rn(k, dist), &sinp, &cosp);

  const float g_amp = ffma_rn(gim, sinp, fmul_rn(gre, cosp));
  const float g_phase =
      fmul_rn(amp, ffma_rn(gim, cosp, fmul_rn(-gre, sinp)));
  const float g_au = fmul_rn(-fmul_rn(amp, inv_au), g_amp);
  const float sign_u = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
  const float g_u = fmul_rn(sign_u, g_au);
  const float g_ct = fmul_rn(g_u, fmul_rn(fmul_rn(2.0f, ct), pc.c_minus_1));
  const float g_dot = fmul_rn(g_ct, inv_den);
  const float g_den = fmul_rn(g_ct, fmul_rn(-ct, inv_den));
  const float ga = fmul_rn(fmul_rn(g_den, nb), inv_na);
  const float g_ax = ffma_rn(ga, ax, fmul_rn(g_dot, bx));
  const float g_ay = ffma_rn(ga, ay, fmul_rn(g_dot, by));
  const float g_az = ffma_rn(ga, az, fmul_rn(g_dot, bz));
  const float inv_d = rcp_or_zero(dist);
  const float gr = fmul_rn(fmul_rn(g_phase, k), inv_d);
  const float g_rx = fmul_rn(gr, rx), g_ry = fmul_rn(gr, ry),
              g_rz = fmul_rn(gr, rz);
  gl = {fadd_rn(g_ax, -g_rx), fadd_rn(g_ay, -g_ry), fadd_rn(g_az, -g_rz)};
  glam = fmul_rn(klam, fmul_rn(g_phase, dist));
  if constexpr (kCoef) {
    gc = g_u * ct2 + g_amp * (amp * pc.half_inv_c);
    const float gb = g_den * na * inv_nb;
    const float g_bx = g_dot * ax + gb * bx;
    const float g_by = g_dot * ay + gb * by;
    const float g_bz = g_dot * az + gb * bz;
    gs = {g_rx - 0.5f * g_ax - g_bx, g_ry - 0.5f * g_ay - g_by,
          g_rz - 0.5f * g_az - g_bz};
    gd = {g_bx - 0.5f * g_ax, g_by - 0.5f * g_ay, g_bz - 0.5f * g_az};
  }
}

// Kernel #6: one block per (tile, sample). The tile's coefficients (2 x
// 144 x 16 f32 = 18 KB at the trainer's shape) and (c, sqrt(pi c)) are
// staged in shared memory, where a warp reads them as broadcasts (its rows
// share a segment); each thread sums every pair's return at kFwdRows rows
// in registers and writes them once.
__global__ void __launch_bounds__(kFwdThreads, 2)
fwd_kernel(const float* __restrict__ e, const float* __restrict__ src,
           const float* __restrict__ dst, const float* __restrict__ cvec,
           const float* __restrict__ loc, const float* __restrict__ lam,
           float* __restrict__ re_out, float* __restrict__ im_out,
           int num_tiles, int ns4, int tile, int em, int t_out) {
  float* smem = reinterpret_cast<float*>(smem4);
  const int j = blockIdx.x;
  const int n = blockIdx.y;
  const int f3 = 3 * em;
  float* s_src = smem;              // (3 EM, ns4)
  float* s_dst = s_src + f3 * ns4;  // (3 EM, ns4)
  float2* s_pair = reinterpret_cast<float2*>(s_dst + f3 * ns4);  // (EM,)

  const size_t coef_base = ((size_t)n * num_tiles + j) * f3 * ns4;
  for (int i = threadIdx.x; i < f3 * ns4; i += kFwdThreads) {
    s_src[i] = src[coef_base + i];
    s_dst[i] = dst[coef_base + i];
  }
  for (int i = threadIdx.x; i < em; i += kFwdThreads) {
    const float c = cvec[(size_t)n * em + i];
    s_pair[i] = make_float2(c, sqrtf(radar::kPi * c));
  }
  __syncthreads();

  const float k = radar::kFourPi / lam[0];
  const Point l = {loc[0], loc[1], loc[2]};
  const float* e_tile = e + (size_t)j * ns4 * tile;

  for (int r0 = threadIdx.x; r0 < tile; r0 += kFwdRows * kFwdThreads) {
    float4 m[kFwdRows];
    int slot[kFwdRows];
    bool has[kFwdRows];
    float re[kFwdRows], im[kFwdRows];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const int r = r0 + i * kFwdThreads;
      slot[i] = -1;
      m[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < tile && j * tile + r < t_out) {
        slot[i] = row_slot(e_tile, ns4, tile, r, m[i]);
      }
      // a row with no slot is evaluated at zero monomials and written as 0
      has[i] = slot[i] >= 0;
      slot[i] = max(slot[i], 0);
      re[i] = im[i] = 0.0f;
    }
    for (int p = 0; p < em; ++p) {
      const float2 cp = s_pair[p];
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        float4 q[6];
        load_coefs(s_src, s_dst, em, ns4, p, slot[i], q);
        const Point s = {cubic(q[0], m[i]), cubic(q[1], m[i]),
                         cubic(q[2], m[i])};
        const Point d = {cubic(q[3], m[i]), cubic(q[4], m[i]),
                         cubic(q[5], m[i])};
        fwd_pair(l, s, d, cp.x, cp.y, k, re[i], im[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const int r = r0 + i * kFwdThreads;
      const int row = j * tile + r;
      if (r < tile && row < t_out) {
        re_out[(size_t)n * t_out + row] = has[i] ? re[i] : 0.0f;
        im_out[(size_t)n * t_out + row] = has[i] ? im[i] : 0.0f;
      }
    }
  }
}

inline size_t fwd_smem_bytes(int ns4, int em) {
  return sizeof(float) * ((size_t)2 * 3 * em * ns4 + 2 * em);
}

// The backward block's shared memory, in floats. The rows are split into
// `nruns` runs of contiguous rows, and a thread owns one (pair, run) item
// (EM = 48: 4 runs of 128 rows, one item a thread). With kCoef a run's
// sums at slot s go to entry run + s of `part`: with nondecreasing slots
// the runs' slot ranges overlap in at most an end, so no two (run, slot)
// meet in one entry, and nruns + NS - 1 entries hold them all.
struct BwdLayout {
  int f3, nruns, entries;
  size_t coef, m, g, slot, fin, part, gc, run, total;

  __host__ __device__ BwdLayout(int ns4, int tile, int em, bool coef_grads) {
    f3 = 3 * em;
    nruns = kBwdThreads / em > 0 ? kBwdThreads / em : 1;
    entries = nruns + ns4 / 4 - 1;
    coef = 0;                                  // src, dst (3 EM, ns4)
    m = coef + (size_t)2 * f3 * ns4;           // (tile,) float4 monomials
    g = m + (size_t)4 * tile;                  // (tile,) float2 (gre, gim)
    slot = g + (size_t)2 * tile;               // (tile,) int
    fin = slot + tile;                         // (4, kBwdThreads)
    part = fin + (size_t)4 * kBwdThreads;      // (entries, kCoefs, EM)
    gc = part + (coef_grads ? (size_t)entries * kCoefs * em : 0);
    run = gc + (coef_grads ? (size_t)nruns * em : 0);  // (nruns, 3) int
    total = run + (coef_grads ? (size_t)3 * nruns : 0);
  }
};

// Kernel #7: one block per (tile, sample), so that a block owns its (3 EM,
// ns4) output blocks of dsrc/ddst, as in JAX; dc, dloc and dlambda leave
// as per-block partials (ws_dc (N, num_tiles, EM), ws_s (N * num_tiles,
// 4)) that reduce_kernel sums in index order. kCoef = false computes only
// dloc and dlambda (dsrc, ddst and ws_dc untouched).
//   1. Each row's slot, monomials and cotangent are found once and staged,
//      with the tile's coefficients; `part` starts at zero.
//   2. Each thread walks its run of rows for its pair (the lanes of a warp
//      share rows, so they change slot together), the coefficient sums of
//      the current slot in registers, flushed to `part` at a slot change
//      and at the run's end.
//   3. One barrier; dloc and dlambda over the threads by a fixed tree; each
//      output of dsrc/ddst sums its slot's entries over the runs in order
//      (zero for a slot the tile does not touch), dc its runs' sums. A tile
//      whose slots decrease (no monomials of spline_tile_plan) would get
//      NaN in dsrc/ddst: the wrappers refuse such monomials
//      (ops/radar.py::check_monomials).
// Registers (ptxas, sm_90a): 117 with kCoef, two blocks an SM (capped for
// three it spills), 78 without, four blocks an SM.
template <bool kCoef>
__global__ void __launch_bounds__(kBwdThreads, kCoef ? 2 : 3)
bwd_kernel(const float* __restrict__ e, const float* __restrict__ src,
           const float* __restrict__ dst, const float* __restrict__ cvec,
           const float* __restrict__ loc, const float* __restrict__ lam,
           const float* __restrict__ gre_in, const float* __restrict__ gim_in,
           float* __restrict__ dsrc, float* __restrict__ ddst,
           float* __restrict__ ws_dc, float* __restrict__ ws_s,
           int num_tiles, int ns4, int tile, int em, int t_out) {
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdLayout lay(ns4, tile, em, kCoef);
  const int j = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int f3 = lay.f3;
  const int nruns = lay.nruns;
  float* s_src = smem + lay.coef;
  float* s_dst = s_src + f3 * ns4;
  float4* s_m = reinterpret_cast<float4*>(smem + lay.m);
  float2* s_g = reinterpret_cast<float2*>(smem + lay.g);
  int* s_slot = reinterpret_cast<int*>(smem + lay.slot);
  float* s_fin = smem + lay.fin;
  float* s_part = smem + lay.part;
  float* s_gc = smem + lay.gc;
  int* s_run = reinterpret_cast<int*>(smem + lay.run);

  const size_t block = (size_t)n * num_tiles + j;
  const size_t coef_base = block * f3 * ns4;
  for (int i = tid; i < f3 * ns4; i += kBwdThreads) {
    s_src[i] = src[coef_base + i];
    s_dst[i] = dst[coef_base + i];
  }
  const float* e_tile = e + (size_t)j * ns4 * tile;
  for (int r = tid; r < tile; r += kBwdThreads) {
    const int row = j * tile + r;
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 g = make_float2(0.0f, 0.0f);
    int slot = -1;
    if (row < t_out) {
      slot = row_slot(e_tile, ns4, tile, r, m);
      const size_t at = (size_t)n * t_out + row;
      g = make_float2(gre_in[at], gim_in[at]);
    }
    s_m[r] = m;
    s_g[r] = g;
    s_slot[r] = slot;
  }
  if constexpr (kCoef) {
    // a slot that a run skips keeps its entry's zeros
    for (size_t i = tid; i < (size_t)lay.entries * kCoefs * em;
         i += kBwdThreads) {
      s_part[i] = 0.0f;
    }
  }
  __syncthreads();

  const float lam_v = lam[0];
  const float k = radar::kFourPi / lam_v;
  const float klam = -k / lam_v;
  const Point l = {loc[0], loc[1], loc[2]};
  float acc_lx = 0.0f, acc_ly = 0.0f, acc_lz = 0.0f, acc_lam = 0.0f;

  for (int it = tid; it < em * nruns; it += kBwdThreads) {
    const int p = it % em;
    const int run = it / em;
    const int r1 = (int)((long long)(run + 1) * tile / nruns);
    const float c = cvec[(size_t)n * em + p];
    const PairConst pc = {c, c - 1.0f, sqrtf(radar::kPi * c),
                          c > 0.0f ? 0.5f / c : 0.0f};
    float4 q[6];
    float4 sum[6];
    float gc_sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) sum[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int cur = -1, lo = INT_MAX;
    bool ordered = true;
    // the run's sums at slot `cur` to its entry
    auto flush = [&]() {
      float* at = s_part + ((size_t)(run + cur) * kCoefs) * em + p;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        at[(4 * i + 0) * em] = sum[i].x;
        at[(4 * i + 1) * em] = sum[i].y;
        at[(4 * i + 2) * em] = sum[i].z;
        at[(4 * i + 3) * em] = sum[i].w;
        sum[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    };
    for (int r = (int)((long long)run * tile / nruns); r < r1; ++r) {
      const int s = s_slot[r];
      if (s < 0) continue;
      if (s != cur) {
        if constexpr (kCoef) {
          if (cur >= 0) {
            ordered = ordered && s > cur;
            flush();
          } else {
            lo = s;
          }
        }
        load_coefs(s_src, s_dst, em, ns4, p, s, q);
        cur = s;
      }
      const float4 m = s_m[r];
      const float2 g = s_g[r];
      const Point sp = {cubic(q[0], m), cubic(q[1], m), cubic(q[2], m)};
      const Point dp = {cubic(q[3], m), cubic(q[4], m), cubic(q[5], m)};
      Point gs, gd, gl;
      float gc, glam;
      bwd_pair<kCoef>(l, sp, dp, pc, k, klam, g.x, g.y, gs, gd, gc, gl,
                      glam);
      acc_lx = fadd_rn(acc_lx, gl.x);
      acc_ly = fadd_rn(acc_ly, gl.y);
      acc_lz = fadd_rn(acc_lz, gl.z);
      acc_lam = fadd_rn(acc_lam, glam);
      if constexpr (kCoef) {
        const float gv[6] = {gs.x, gs.y, gs.z, gd.x, gd.y, gd.z};
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          sum[i].x += gv[i] * m.x;
          sum[i].y += gv[i] * m.y;
          sum[i].z += gv[i] * m.z;
          sum[i].w += gv[i] * m.w;
        }
        gc_sum += gc;
      }
    }
    if constexpr (kCoef) {
      if (cur >= 0) flush();
      s_gc[run * em + p] = gc_sum;
      if (p == 0) {
        s_run[3 * run] = lo;
        s_run[3 * run + 1] = cur;
        s_run[3 * run + 2] = ordered;
      }
    }
  }

  // dloc and dlambda over the block: a fixed tree over the threads
  s_fin[0 * kBwdThreads + tid] = acc_lx;
  s_fin[1 * kBwdThreads + tid] = acc_ly;
  s_fin[2 * kBwdThreads + tid] = acc_lz;
  s_fin[3 * kBwdThreads + tid] = acc_lam;
  __syncthreads();
  if (tid < kBwdThreads - kBwdPow2) {
    for (int v = 0; v < 4; ++v) {
      s_fin[v * kBwdThreads + tid] += s_fin[v * kBwdThreads + tid + kBwdPow2];
    }
  }
  __syncthreads();
  for (int half = kBwdPow2 / 2; half > 0; half /= 2) {
    if (tid < half) {
      for (int v = 0; v < 4; ++v) {
        s_fin[v * kBwdThreads + tid] += s_fin[v * kBwdThreads + tid + half];
      }
    }
    __syncthreads();
  }
  if (tid < 4) ws_s[block * 4 + tid] = s_fin[tid * kBwdThreads];

  if constexpr (kCoef) {
    // the runs' slot ranges must follow one another
    bool ordered = true;
    int prev_hi = -1;
    for (int run = 0; run < nruns; ++run) {
      const int lo = s_run[3 * run], hi = s_run[3 * run + 1];
      if (hi < 0) continue;  // a run of pad rows only
      ordered = ordered && s_run[3 * run + 2] && lo >= prev_hi;
      prev_hi = hi;
    }
    const int per = f3 * ns4;
    for (int o = tid; o < 2 * per; o += kBwdThreads) {
      const int sd = o / per, rem = o % per;
      const int f = rem / ns4, qq = rem % ns4;
      const int slot = qq / 4;
      const int v = 4 * (3 * sd + f / em) + qq % 4;
      const float* at = s_part + (size_t)v * em + f % em;
      float acc = 0.0f;
      for (int run = 0; run < nruns; ++run) {
        if (s_run[3 * run] <= slot && slot <= s_run[3 * run + 1]) {
          acc += at[(size_t)(run + slot) * kCoefs * em];
        }
      }
      (sd ? ddst : dsrc)[coef_base + rem] = ordered ? acc : nanf("");
    }
    for (int p = tid; p < em; p += kBwdThreads) {
      float acc = 0.0f;
      for (int run = 0; run < nruns; ++run) acc += s_gc[run * em + p];
      ws_dc[block * em + p] = acc;
    }
  }
}

inline size_t bwd_smem_bytes(int ns4, int tile, int em, bool coef_grads) {
  return sizeof(float) * BwdLayout(ns4, tile, em, coef_grads).total;
}

// dc[n, em] = sum_j ws_dc[n, j, em] (kCoef only); dloc, dlambda = sum_b
// ws_s[b, :], in index order.
template <bool kCoef>
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ ws_dc, const float* __restrict__ ws_s,
              float* __restrict__ dc, float* __restrict__ dloc,
              float* __restrict__ dlam, int n, int num_tiles, int em) {
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  const int n_dc = kCoef ? n * em : 0;
  if (idx < n_dc) {
    const int i = idx / em, p = idx % em;
    float acc = 0.0f;
    for (int j = 0; j < num_tiles; ++j) {
      acc += ws_dc[((size_t)i * num_tiles + j) * em + p];
    }
    dc[idx] = acc;
  } else if (idx < n_dc + 4) {
    const int v = idx - n_dc;
    float acc = 0.0f;
    for (size_t b = 0; b < (size_t)n * num_tiles; ++b) acc += ws_s[b * 4 + v];
    if (v < 3) {
      dloc[v] = acc;
    } else {
      dlam[0] = acc;
    }
  }
}

inline int reduce_blocks(int n, int em, bool coef_grads) {
  const int outputs = (coef_grads ? n * em : 0) + 4;
  return (outputs + kReduceThreads - 1) / kReduceThreads;
}

}  // namespace radar_spline
