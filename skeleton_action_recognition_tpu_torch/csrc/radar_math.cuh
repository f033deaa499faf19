// The per-(sample, edge) radar math shared by radar_fwd.cu and radar_bwd.cu.
//
// A transcription of skeleton_action_recognition_tpu/ops/pallas/radar.py::
// _scatter_fwd_core and _scatter_bwd_core for one time sample and one
// edge-body pair: the bone runs from s to d, the radar sits at l,
//
//     r = s - l,  dist = |r|,  a = l - (s + d) / 2,  b = d - s,
//     ct = (a . b) / (|a| |b| + 1e-6),
//     u = (1 - ct^2) + c ct^2,  amp = sqrt(pi c) / |u|,
//     phase = (4 pi / lambda) dist,
//
// and the return is amp * (cos phase, sin phase). All f32; sqrtf, the
// divisions and sincosf are the precise ones (the sources are never built
// with --use_fast_math): the phase is ~1e5 rad at lambda = 5e-4, where
// __sinf/__cosf are wrong in every digit.

#pragma once

#include <cuda_runtime.h>

namespace radar {

constexpr float kFourPi = 12.566370614359172f;  // f32(4 pi), as JAX rounds it
constexpr float kPi = 3.14159265358979f;

struct Point {
  float x, y, z;
};

// amp and phase of one (sample, edge-body) pair; sqrt_pi_c = sqrt(pi c) and
// k = 4 pi / lambda are per launch or per edge.
__device__ __forceinline__ void scatter_fwd(Point l, Point s, Point d,
                                            float c, float sqrt_pi_c,
                                            float k, float& amp,
                                            float& phase) {
  const float rx = s.x - l.x, ry = s.y - l.y, rz = s.z - l.z;
  const float dist = sqrtf(rx * rx + ry * ry + rz * rz);
  const float ax = l.x - (s.x + d.x) * 0.5f;
  const float ay = l.y - (s.y + d.y) * 0.5f;
  const float az = l.z - (s.z + d.z) * 0.5f;
  const float bx = d.x - s.x, by = d.y - s.y, bz = d.z - s.z;
  const float dot = ax * bx + ay * by + az * bz;
  const float na = sqrtf(ax * ax + ay * ay + az * az);
  const float nb = sqrtf(bx * bx + by * by + bz * bz);
  const float ct = dot / (na * nb + 1e-6f);
  const float ct2 = ct * ct;
  // |.|: u can go epsilon-negative when |ct| creeps past 1 in f32
  const float denom = fabsf((1.0f - ct2) + c * ct2);
  amp = sqrt_pi_c / denom;
  phase = k * dist;
}

// Cotangents of one pair from the output cotangent (gre, gim): of the two
// endpoints (gs, gd), of c, of the radar location (gl) and of lambda.
// The guards are the JAX kernel's: sign(u) (0 at u = 0), amp / (2c) only
// where c > 0, and zero inverses of zero norms (an all-zero body has
// zero-length bones and is routine in NTU clips).
__device__ __forceinline__ void scatter_bwd(Point l, Point s, Point d,
                                            float c, float sqrt_pi_c,
                                            float k, float lam, float gre,
                                            float gim, Point& gs, Point& gd,
                                            float& gc, Point& gl,
                                            float& glam) {
  const float rx = s.x - l.x, ry = s.y - l.y, rz = s.z - l.z;
  const float dist = sqrtf(rx * rx + ry * ry + rz * rz);
  const float ax = l.x - (s.x + d.x) * 0.5f;
  const float ay = l.y - (s.y + d.y) * 0.5f;
  const float az = l.z - (s.z + d.z) * 0.5f;
  const float bx = d.x - s.x, by = d.y - s.y, bz = d.z - s.z;
  const float dot = ax * bx + ay * by + az * bz;
  const float na = sqrtf(ax * ax + ay * ay + az * az);
  const float nb = sqrtf(bx * bx + by * by + bz * bz);
  const float den = na * nb + 1e-6f;
  const float ct = dot / den;
  const float ct2 = ct * ct;
  const float u = (1.0f - ct2) + c * ct2;
  const float au = fabsf(u);
  const float amp = sqrt_pi_c / au;
  const float phase = k * dist;
  float sinp, cosp;
  sincosf(phase, &sinp, &cosp);

  const float g_amp = gre * cosp + gim * sinp;
  const float g_phase = amp * (gim * cosp - gre * sinp);
  const float g_dist = g_phase * k;
  const float g_au = -(amp / au) * g_amp;
  const float sign_u = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
  const float g_u = sign_u * g_au;
  const float g_ct = g_u * (2.0f * ct * (c - 1.0f));
  gc = g_u * ct2 + g_amp * (c > 0.0f ? amp / (2.0f * c) : 0.0f);
  const float g_dot = g_ct / den;
  const float g_den = g_ct * (-ct / den);
  const float inv_na = na > 0.0f ? 1.0f / na : 0.0f;
  const float inv_nb = nb > 0.0f ? 1.0f / nb : 0.0f;
  const float inv_d = dist > 0.0f ? 1.0f / dist : 0.0f;
  const float g_ax = g_dot * bx + g_den * nb * ax * inv_na;
  const float g_ay = g_dot * by + g_den * nb * ay * inv_na;
  const float g_az = g_dot * bz + g_den * nb * az * inv_na;
  const float g_bx = g_dot * ax + g_den * na * bx * inv_nb;
  const float g_by = g_dot * ay + g_den * na * by * inv_nb;
  const float g_bz = g_dot * az + g_den * na * bz * inv_nb;
  const float g_rx = g_dist * rx * inv_d;
  const float g_ry = g_dist * ry * inv_d;
  const float g_rz = g_dist * rz * inv_d;

  gs = {g_rx - 0.5f * g_ax - g_bx, g_ry - 0.5f * g_ay - g_by,
        g_rz - 0.5f * g_az - g_bz};
  gd = {-0.5f * g_ax + g_bx, -0.5f * g_ay + g_by, -0.5f * g_az + g_bz};
  gl = {-g_rx + g_ax, -g_ry + g_ay, -g_rz + g_az};
  glam = (-k / lam) * (g_phase * dist);
}

// The spline slot of padded row r of a tile: the tile's monomials
// e_tile (ns4 rows of `stride` floats, one column per padded row) are
// one-hot in (slot, k), with the constant term e[4 slot + 3] equal to 1 on
// every row before t_out. Returns the slot (-1 if none) and the slot's four
// monomials m[k] = u^(3 - k).
__device__ __forceinline__ int row_slot(const float* e_tile, int ns4,
                                        int stride, int r, float m[4]) {
  int slot = -1;
  for (int s = 0; s < ns4 / 4; ++s) {
    if (e_tile[(4 * s + 3) * stride + r] != 0.0f) slot = s;
  }
  for (int kk = 0; kk < 4; ++kk) {
    m[kk] = slot >= 0 ? e_tile[(4 * slot + kk) * stride + r] : 0.0f;
  }
  return slot;
}

// Position coordinate f (row f of a (3 EM, ns4) coefficient tile in shared
// memory) at a row of the given slot: the cubic sum_k coef[4 slot + k] m[k].
// The other slots' monomials are exact zeros, so this is the one-hot
// contraction of the JAX kernel, summed in another order.
__device__ __forceinline__ float eval_cubic(const float* coef, int ns4,
                                            int f, int slot,
                                            const float m[4]) {
  const float* q = coef + f * ns4 + 4 * slot;
  return q[0] * m[0] + q[1] * m[1] + q[2] * m[2] + q[3] * m[3];
}

}  // namespace radar
