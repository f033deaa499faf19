// The STFT log-magnitude kernels as in-block FFTs: the forward (stft_fwd.cu,
// kernel #10), the backward and its reflect fold (stft_bwd.cu, kernel #11).
//
// The op's contract (skeleton_action_recognition_tpu/ops/pallas/stft.py::
// stft_logmag) takes windowed Fourier bases cos[k, m] = cos(2 pi k m / N)
// w[m], sin[k, m] = sin(2 pi k m / N) w[m] (k < F <= N), so each frame's
// spectrum is S[k] = sum_m x[m] w[m] e^{-2 pi i k m / N} of the complex
// frame x = re + i im: an N-point FFT of the windowed frame. The wrapper
// (ops/stft_logmag.py) holds the bases to that contract and hands over the
// window w = cos[0, :] and a table of e^{-2 pi i e / N}, e < N, computed in
// double and rounded once.
//
// What bounds them on the H100: bytes. An FFT is ~5 N log2 N operations a
// frame, 1/50 of the DFT product the TPU kernel ran on its matrix unit; at
// the trainer's shape (16 signals of 75,000 samples, N = 256, hop 16: 4,688
// frames) that is ~0.9 GFLOP against 86 MB of signal in and log-magnitude
// out (the backward: 96 MB), 0.026-0.029 ms at 3.35 TB/s.
//
// The FFT. Each frame is one N-point transform by P = N / 16 threads (16
// complex values each, in registers): Stockham passes of radix 16 (the last
// one of radix N / 16^s where 16 does not divide what is left), each a
// radix-16 (or 2, 4, 8) DFT in registers (radix-2 butterflies of constant
// twiddles), the inter-pass twiddles from the table in shared memory, and
// an exchange through a shared buffer between passes (N = 256: 16 x 16,
// one exchange). The buffer pads one float every 16 so that a pass's
// strided writes are free of bank conflicts. A block of 256 threads takes
// FG = 4,096 / N frames at once (16 at N = 256). The passes leave thread
// `lane` of a frame with bins lane + P b + r NS (out_bin).
//
//   forward (fwd_kernel<N>): one block per run of FG frames of a signal.
//     The block stages the signal span of its frames ((FG - 1) hop + N
//     samples of re and im), reflect-padded on the fly when centered (no
//     padded copy exists), transforms, takes log(sqrt(re^2 + im^2) + eps)
//     (precise logf/sqrtf) into a (row, frame) tile over the buffer, with
//     the fftshift roll and the first F bins folded into the row index,
//     and writes the (N, F, frames) rows with consecutive threads on
//     consecutive frames.
//   backward (bwd_kernel<N>): one block per run of `len` padded samples
//     (bwd_plan). It recomputes, in rounds of FG, the frames that cover its
//     samples (~25-30% more frames than it owns at N = 256, hop 16), forms
//     G = g inv (Re, Im) with inv = 1 / (mag (mag + eps) + 1e-30) (0 where
//     mag^2 = 0; g read at the rolled row through a shared tile), takes
//     the frame cotangent dfr[m] = w[m] sum_k G[k] e^{+2 pi i k m / N} (the
//     plain version's (g_re C - g_im S, g_re S + g_im C)) as the same FFT
//     of conj(G), conjugated, and overlap-adds each round's frames into
//     per-sample sums in shared memory, frames in order. No workspace of
//     frames or spectra exists. Samples of the reflect padding go to a
//     small edge buffer (N, 2, 2, pad), which fold_kernel adds to their
//     mirrors as JAX's unpad does (the main sum, then the left mirror, then
//     the right).
// Every sum runs in an order fixed by the shapes, so two launches agree bit
// for bit. No fast-math intrinsics: the log and square root are the
// precise ones, as in the plain version.

#pragma once

#include <cuda_runtime.h>

namespace stft_fft {

constexpr int kThreads = 256;
constexpr int kMaxLen = 4096;  // padded samples a backward block owns

extern __shared__ float smem[];

// Frames a block transforms at once, and the floats of one frame's buffer
// (one pad float every 16).
__host__ __device__ constexpr int frames_per_round(int n_fft) {
  return 16 * kThreads / n_fft;
}
__host__ __device__ constexpr int buffer_stride(int n_fft) {
  return n_fft + n_fft / 16;
}
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// The radix of the Stockham pass that follows sub-transforms of size NS.
template <int N, int NS>
constexpr int kRadix = N / NS >= 16 ? 16 : N / NS;

// NS of the last pass.
template <int N, int NS = 1>
__host__ __device__ constexpr int last_ns() {
  if constexpr (NS * kRadix<N, NS> == N) {
    return NS;
  } else {
    return last_ns<N, NS * kRadix<N, NS>>();
  }
}

// The bin (or, in the inverse, the sample) of element e of thread `lane`
// after the last pass.
template <int N>
__device__ __forceinline__ int out_bin(int lane, int e) {
  constexpr int NS = last_ns<N>(), R = N / NS, P = N / 16;
  return lane + P * (e / R) + (e % R) * NS;
}

// cos(2 pi e / 16) and sin(2 pi e / 16), e < 16.
__host__ __device__ constexpr float cos16(int e) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi / 8)
  constexpr float c2 = 0.70710678118654752f;  // cos(pi / 4)
  constexpr float c3 = 0.38268343236508977f;  // cos(3 pi / 8)
  switch (e & 15) {
    case 0: return 1.0f;
    case 1: return c1;
    case 2: return c2;
    case 3: return c3;
    case 4: return 0.0f;
    case 5: return -c3;
    case 6: return -c2;
    case 7: return -c1;
    case 8: return -1.0f;
    case 9: return -c1;
    case 10: return -c2;
    case 11: return -c3;
    case 12: return 0.0f;
    case 13: return c3;
    case 14: return c2;
    default: return c1;
  }
}
__host__ __device__ constexpr float sin16(int e) { return cos16(e + 12); }

// (x, y) *= e^{-2 pi i e / 16}, e < 8; e = 0 and 4 exactly.
__device__ __forceinline__ void rotate16(float& x, float& y, int e) {
  if (e == 0) return;
  if (e == 4) {
    const float t = x;
    x = y;
    y = -t;
    return;
  }
  const float c = cos16(e), s = sin16(e);
  const float t = x * c + y * s;
  y = y * c - x * s;
  x = t;
}

template <int R>
__host__ __device__ constexpr int bit_reverse(int i) {
  int r = 0;
  for (int b = 1; b < R; b *= 2) {
    r = r * 2 + (i & 1);
    i >>= 1;
  }
  return r;
}

// The butterflies of half-size H of an R-point radix-2 DIT, and the later
// stages: u-th butterfly of block s, member q. Each stage is its own
// instance, so that every index is a constant once its loop is unrolled
// and the values stay in registers.
template <int R, int H>
__device__ __forceinline__ void dft_stage(float (&vr)[16], float (&vi)[16],
                                          int o) {
  if constexpr (H < R) {
#pragma unroll
    for (int u = 0; u < R / 2; ++u) {
      const int s = u / H * 2 * H, q = u % H;
      float xr = vr[o + s + q + H], xi = vi[o + s + q + H];
      rotate16(xr, xi, q * (8 / H));  // W_{2H}^q
      vr[o + s + q + H] = vr[o + s + q] - xr;
      vi[o + s + q + H] = vi[o + s + q] - xi;
      vr[o + s + q] += xr;
      vi[o + s + q] += xi;
    }
    dft_stage<R, 2 * H>(vr, vi, o);
  }
}

// In-place DFT of v[o .. o + R), natural order in and out: radix-2
// decimation in time over the bit-reversed input.
template <int R>
__device__ __forceinline__ void dft(float (&vr)[16], float (&vi)[16], int o) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = bit_reverse<R>(i);
    if (j > i) {
      float t = vr[o + i];
      vr[o + i] = vr[o + j];
      vr[o + j] = t;
      t = vi[o + i];
      vi[o + i] = vi[o + j];
      vi[o + j] = t;
    }
  }
  dft_stage<R, 1>(vr, vi, o);
}

// The Stockham pass after sub-transforms of size NS, on the thread's 16
// values, and the passes after it. On entry element e holds x[j + r N / R]
// of butterfly j = lane + P (e / R), r = e % R; the frame's buffer (br, bi)
// is free. tw: (cos, sin) of 2 pi e / N, e < N.
template <int N, int NS>
__device__ __forceinline__ void fft_pass(float (&vr)[16], float (&vi)[16],
                                         int lane, float* br, float* bi,
                                         const float* tw) {
  constexpr int R = kRadix<N, NS>, B = 16 / R, P = N / 16;
  if constexpr (NS > 1) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = (lane + P * b) & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int e = k * r * (N / (NS * R));  // < N
        const float c = tw[2 * e], s = tw[2 * e + 1];
        const float x = vr[b * R + r], y = vi[b * R + r];
        vr[b * R + r] = x * c + y * s;
        vi[b * R + r] = y * c - x * s;
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) dft<R>(vr, vi, b * R);
  if constexpr (NS * R < N) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int j = lane + P * (e / R), r = e % R;
      const int at = padded((j / NS) * NS * R + (j & (NS - 1)) + r * NS);
      br[at] = vr[e];
      bi[at] = vi[e];
    }
    __syncthreads();
    constexpr int R2 = kRadix<N, NS * R>;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int at = padded(lane + P * (e / R2) + (e % R2) * (N / R2));
      vr[e] = br[at];
      vi[e] = bi[at];
    }
    if constexpr (NS * R * R2 < N) __syncthreads();  // written again next
    fft_pass<N, NS * R>(vr, vi, lane, br, bi, tw);
  }
}

// The N-point FFT of a frame whose thread `lane` holds x[lane + e P] in
// element e; leaves bin out_bin(lane, e) there. Every thread of the block
// calls it (it synchronises), with the frame's buffer free.
template <int N>
__device__ __forceinline__ void fft(float (&vr)[16], float (&vi)[16],
                                    int lane, float* br, float* bi,
                                    const float* tw) {
  fft_pass<N, 1>(vr, vi, lane, br, bi, tw);
}

// Padded sample p of a signal of t samples reflect-padded by `pad` (one
// reflection: t > pad), 0 past the padded end tp.
__device__ __forceinline__ float padded_sample(const float* __restrict__ x,
                                               int p, int t, int pad,
                                               int tp) {
  if (p >= tp) return 0.0f;
  int s = p - pad;
  if (s < 0) {
    s = -s;
  } else if (s >= t) {
    s = 2 * (t - 1) - s;
  }
  return x[s];
}

// The table and window, and `len` padded samples of signal n from padded
// position `start`, into shared memory.
template <int N>
__device__ __forceinline__ void stage(const float* __restrict__ re,
                                      const float* __restrict__ im,
                                      const float* __restrict__ window,
                                      const float* __restrict__ twiddles,
                                      float* s_tw, float* s_w, float* s_re,
                                      float* s_im, int n, int t, int pad,
                                      int start, int len) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * N; i += kThreads) s_tw[i] = twiddles[i];
  for (int i = tid; i < N; i += kThreads) s_w[i] = window[i];
  const float* x_re = re + (size_t)n * t;
  const float* x_im = im + (size_t)n * t;
  const int tp = t + 2 * pad;
  for (int i = tid; i < len; i += kThreads) {
    s_re[i] = padded_sample(x_re, start + i, t, pad, tp);
    s_im[i] = padded_sample(x_im, start + i, t, pad, tp);
  }
}

// Row of bin k in the output: the fftshift roll by F / 2 over the first F
// bins.
__device__ __forceinline__ int out_row(int k, int f, int fftshift) {
  if (!fftshift) return k;
  const int r = k + f / 2;
  return r >= f ? r - f : r;
}

// Shared floats of the forward: table, window, signal span, buffer (the
// (row, frame) tile of the output reuses it).
__host__ __device__ inline size_t fwd_smem_floats(int n_fft, int hop) {
  const int fg = frames_per_round(n_fft);
  const size_t span = (size_t)(fg - 1) * hop + n_fft;
  return 3 * (size_t)n_fft + 2 * span + 2 * (size_t)fg * buffer_stride(n_fft);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ re, const float* __restrict__ im,
           const float* __restrict__ window,
           const float* __restrict__ twiddles, float* __restrict__ out,
           int t, int hop, int f, int frames, int pad, int fftshift,
           float eps) {
  constexpr int FG = frames_per_round(N), P = N / 16;
  constexpr int S = buffer_stride(N), LD = FG + 2;
  const int span = (FG - 1) * hop + N;
  float* s_tw = smem;
  float* s_w = s_tw + 2 * N;
  float* s_re = s_w + N;
  float* s_im = s_re + span;
  float* b_re = s_im + span;
  float* b_im = b_re + FG * S;
  const int n = blockIdx.y, i0 = blockIdx.x * FG;
  const int tid = threadIdx.x, a = tid / P, lane = tid % P;
  stage<N>(re, im, window, twiddles, s_tw, s_w, s_re, s_im, n, t, pad,
           i0 * hop, span);
  __syncthreads();

  const bool valid = i0 + a < frames;
  float vr[16], vi[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int m = lane + e * P;
    vr[e] = valid ? s_re[a * hop + m] * s_w[m] : 0.0f;
    vi[e] = valid ? s_im[a * hop + m] * s_w[m] : 0.0f;
  }
  fft<N>(vr, vi, lane, b_re + a * S, b_im + a * S, s_tw);
  __syncthreads();  // the buffer is read: the output tile takes it

  float* s_out = b_re;  // (F, LD)
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int k = out_bin<N>(lane, e);
    if (k < f) {
      s_out[out_row(k, f, fftshift) * LD + a] =
          logf(sqrtf(vr[e] * vr[e] + vi[e] * vi[e]) + eps);
    }
  }
  __syncthreads();
  for (int i = tid; i < f * FG; i += kThreads) {
    const int row = i / FG, c = i % FG;
    if (i0 + c < frames) {
      out[((size_t)n * f + row) * frames + i0 + c] = s_out[row * LD + c];
    }
  }
}

// The backward's blocks: each owns `len` = fo * hop padded samples and
// transforms the frames that cover them (at most fo + ceil(N / hop) - 1)
// in `rounds` rounds of FG, from a signal span of at most `span` samples.
// fo is about twice the frames' overhang, at most kMaxLen / hop, and fills
// the last round.
struct BwdPlan {
  int len, rounds, span;
};
__host__ __device__ inline BwdPlan bwd_plan(int n_fft, int hop) {
  const int fg = frames_per_round(n_fft);
  const int ext = (n_fft + hop - 1) / hop - 1;
  const int cap = kMaxLen / hop;
  int fo = 2 * ext + fg < cap ? 2 * ext + fg : cap;
  const int rounds = (fo + ext + fg - 1) / fg;
  fo = rounds * fg - ext < cap ? rounds * fg - ext : cap;
  return {fo * hop, rounds, (rounds * fg - 1) * hop + n_fft};
}

// Shared floats of the backward: table, window, signal span, buffer, the
// g tile (F, FG + 2) and the per-sample sums of re and im.
__host__ __device__ inline size_t bwd_smem_floats(int n_fft, int hop,
                                                  int f) {
  const int fg = frames_per_round(n_fft);
  const BwdPlan plan = bwd_plan(n_fft, hop);
  return 3 * (size_t)n_fft + 2 * (size_t)plan.span +
         2 * (size_t)fg * buffer_stride(n_fft) + (size_t)f * (fg + 2) +
         2 * (size_t)plan.len;
}

// Blocks an SM the backward's registers are capped for: at N = 256 (hop
// 16: 73 KB of shared memory a block) three, at 80 registers a thread (no
// spill; 14% faster on an H100 than at the compiler's own 127). At the
// other N shared memory allows two at most at hop 16, and the compiler's
// own choice (128) spills nothing, where a cap for two does.
template <int N>
constexpr int kBwdBlocks = N == 256 ? 3 : 1;

template <int N>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<N>)
bwd_kernel(const float* __restrict__ re, const float* __restrict__ im,
           const float* __restrict__ window,
           const float* __restrict__ twiddles, const float* __restrict__ g,
           float* __restrict__ dre, float* __restrict__ dim,
           float* __restrict__ edges, int t, int hop, int f, int frames,
           int pad, int fftshift, float eps) {
  constexpr int FG = frames_per_round(N), P = N / 16;
  constexpr int S = buffer_stride(N), LD = FG + 2;
  const BwdPlan plan = bwd_plan(N, hop);
  const int n = blockIdx.y, tid = threadIdx.x;
  const int tp = t + 2 * pad;
  const int p0 = blockIdx.x * plan.len;
  const int len = min(plan.len, tp - p0);
  // the frames that cover [p0, p0 + len)
  const int lo = p0 >= N ? (p0 - N) / hop + 1 : 0;
  const int hi = min(frames - 1, (p0 + len - 1) / hop);

  float* s_tw = smem;
  float* s_w = s_tw + 2 * N;
  float* s_re = s_w + N;
  float* s_im = s_re + plan.span;
  float* b_re = s_im + plan.span;
  float* b_im = b_re + FG * S;
  float* s_g = b_im + FG * S;          // (F, LD)
  float* acc_re = s_g + f * LD;        // (len,)
  float* acc_im = acc_re + plan.len;
  stage<N>(re, im, window, twiddles, s_tw, s_w, s_re, s_im, n, t, pad,
           lo * hop, hi >= lo ? (hi - lo) * hop + N : 0);
  for (int q = tid; q < len; q += kThreads) {
    acc_re[q] = 0.0f;
    acc_im[q] = 0.0f;
  }

  const int a = tid / P, lane = tid % P;
  for (int r0 = lo; r0 <= hi; r0 += FG) {
    // g of the round's frames, (row, frame), rows coalesced over frames
    for (int i = tid; i < f * FG; i += kThreads) {
      const int row = i / FG, c = i % FG;
      s_g[row * LD + c] =
          r0 + c <= hi ? g[((size_t)n * f + row) * frames + r0 + c] : 0.0f;
    }
    __syncthreads();  // staged; the last round's sums have read the buffer
    const int i = r0 + a;
    const bool valid = i <= hi;
    float* fr = b_re + a * S;
    float* fi = b_im + a * S;
    float vr[16], vi[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int m = lane + e * P;
      vr[e] = valid ? s_re[(i - lo) * hop + m] * s_w[m] : 0.0f;
      vi[e] = valid ? s_im[(i - lo) * hop + m] * s_w[m] : 0.0f;
    }
    fft<N>(vr, vi, lane, fr, fi, s_tw);
    __syncthreads();  // the buffer is read
    // conj(G) at the natural bins
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int k = out_bin<N>(lane, e);
      float gr = 0.0f, gi = 0.0f;
      if (valid && k < f) {
        const float mag2 = vr[e] * vr[e] + vi[e] * vi[e];
        const float mag = sqrtf(mag2);
        // d log(mag + eps) / d re = re / (mag (mag + eps)); a zero bin
        // gets a zero cotangent, not NaN
        const float inv =
            mag2 > 0.0f ? 1.0f / (mag * (mag + eps) + 1e-30f) : 0.0f;
        const float gg = s_g[out_row(k, f, fftshift) * LD + a] * inv;
        gr = gg * vr[e];
        gi = -(gg * vi[e]);
      }
      fr[padded(k)] = gr;
      fi[padded(k)] = gi;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      vr[e] = fr[padded(lane + e * P)];
      vi[e] = fi[padded(lane + e * P)];
    }
    __syncthreads();  // read before the transform writes
    fft<N>(vr, vi, lane, fr, fi, s_tw);
    __syncthreads();
    // dfr = w conj(FFT(conj G)) at the natural samples
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int m = out_bin<N>(lane, e);
      fr[padded(m)] = s_w[m] * vr[e];
      fi[padded(m)] = -(s_w[m] * vi[e]);
    }
    __syncthreads();
    // overlap-add of the round's frames, in frame order
    const int r1 = min(hi, r0 + FG - 1);
    for (int q = tid; q < len; q += kThreads) {
      const int p = p0 + q;
      const int first = max(r0, p >= N ? (p - N) / hop + 1 : 0);
      const int last = min(r1, p / hop);
      float sr = acc_re[q], si = acc_im[q];
      for (int j = first; j <= last; ++j) {
        const int at = (j - r0) * S + padded(p - j * hop);
        sr += b_re[at];
        si += b_im[at];
      }
      acc_re[q] = sr;
      acc_im[q] = si;
    }
  }

  // the signal's samples, and the padding's to the edge buffer
  float* e_re = edges + (size_t)n * 4 * pad;  // (2 parts, 2 sides, pad)
  float* e_im = e_re + 2 * pad;
  for (int q = tid; q < len; q += kThreads) {
    const int p = p0 + q;
    if (p < pad) {
      e_re[p] = acc_re[q];
      e_im[p] = acc_im[q];
    } else if (p >= pad + t) {
      e_re[pad + p - pad - t] = acc_re[q];
      e_im[pad + p - pad - t] = acc_im[q];
    } else {
      dre[(size_t)n * t + p - pad] = acc_re[q];
      dim[(size_t)n * t + p - pad] = acc_im[q];
    }
  }
}

// Samples the reflect fold touches: s in [1, pad] and [t - 1 - pad, t - 2]
// (the two may meet on a short signal; each sample is one thread's).
__host__ __device__ inline int fold_right0(int t, int pad) {
  return pad + 1 > t - 1 - pad ? pad + 1 : t - 1 - pad;
}
__host__ __device__ inline int fold_count(int t, int pad) {
  const int right = t - 1 - fold_right0(t, pad);
  return pad + (right > 0 ? right : 0);
}

// d[s] += the padding's sum at its mirror: padded sample pad - s (s in
// [1, pad]), then 2 (t - 1) + pad - s (s in [t - 1 - pad, t - 2]), as
// JAX's unpad adds them.
__global__ void __launch_bounds__(kThreads)
fold_kernel(float* __restrict__ dre, float* __restrict__ dim,
            const float* __restrict__ edges, int t, int pad) {
  const int n = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= fold_count(t, pad)) return;
  const int s = idx < pad ? 1 + idx : fold_right0(t, pad) + idx - pad;
  for (int part = 0; part < 2; ++part) {
    float* d = (part == 0 ? dre : dim) + (size_t)n * t;
    const float* e = edges + ((size_t)n * 2 + part) * 2 * pad;
    float v = d[s];
    if (s <= pad) v += e[pad - s];
    if (s >= t - 1 - pad && s <= t - 2) v += e[pad + t - 2 - s];
    d[s] = v;
  }
}

}  // namespace stft_fft
