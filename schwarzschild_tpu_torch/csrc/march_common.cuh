// Per-ray geodesic march shared by both kernels of march.cu.
//
// One thread owns one ray and keeps its whole state in registers.  The
// arithmetic is the f32 form of the JAX package's kernels, operation for
// operation (schwarzschild_tpu/kernel.py:45-241,
// schwarzschild_tpu/kernel_scene.py:273-608), because near the photon
// sphere one ulp grows into a visible pixel:
//   * build with -fmad=false, so a*b+c is never contracted into an FMA;
//   * normalizations divide by sqrtf or multiply by 1.0f/sqrtf, never by
//     the approximate rsqrtf;
//   * sinf/cosf, never __sinf/__cosf or --use_fast_math;
//   * cross products keep jnp.cross's component order (_tangent_of);
//   * constants that JAX takes from Python floats (u_f, 1/u_f, max_angle,
//     1 - 1e-7) are rounded from double once, on the host or here.
#pragma once

#include <math.h>

namespace march {

constexpr float kMarching = 0.0f;
constexpr float kCaptured = 1.0f;
constexpr float kEscaped = 2.0f;
constexpr float kFlatFinish = 3.0f;
constexpr float kHitOpaque = 4.0f;

constexpr float kEps = 1e-7f;                        // black_hole.frag:30
constexpr float kRadialLimit = (float)(1.0 - 1e-7);  // |n.d| >= 1 - eps

// Scalars every march needs; built by the launch functions.
struct Params {
  int n;            // rays
  int max_steps;
  float r_s;        // horizon radius
  float max_angle;  // f32(2 pi max_revolutions)
  float u_f;        // far-field threshold on u = 1/r
  float far_r2;     // f32((1/u_f)^2), the re-entry sphere
};

// max() that keeps a NaN operand, as jnp.maximum and torch.clamp_min do.
__device__ __forceinline__ float vmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ float rnorm3(float x, float y, float z) {
  return 1.0f / sqrtf(vmax(x * x + y * y + z * z, 1e-20f));
}

__device__ __forceinline__ float len3(float x, float y, float z) {
  return sqrtf(vmax(x * x + y * y + z * z, 1e-20f));
}

__device__ __forceinline__ float guard(float x) {
  return fabsf(x) < 1e-12f ? 1e-12f : x;
}

__device__ __forceinline__ float min_positive(float a, float b) {
  if (a > 0.0f && b > 0.0f) return fminf(a, b);
  if (a > 0.0f) return a;
  if (b > 0.0f) return b;
  return -1.0f;
}

// normalize(cross(cross(n, d), n)) in jnp.cross's component order.
__device__ __forceinline__ void tangent_of(float nx, float ny, float nz,
                                           float dx, float dy, float dz,
                                           float& tx, float& ty, float& tz) {
  const float cx = ny * dz - nz * dy;
  const float cy = nz * dx - nx * dz;
  const float cz = nx * dy - ny * dx;
  const float x = cy * nz - cz * ny;
  const float y = cz * nx - cx * nz;
  const float z = cx * ny - cy * nx;
  const float inv = rnorm3(x, y, z);
  tx = x * inv;
  ty = y * inv;
  tz = z * inv;
}

// First positive lambda of the sphere |p + lam d - c| = sqrt(r2)
// (frag:457-470).  Returns whether the ray enters it ahead.
__device__ __forceinline__ bool sphere_entry(float px, float py, float pz,
                                             float dx, float dy, float dz,
                                             float cx, float cy, float cz,
                                             float r2, float& lam) {
  const float ocx = px - cx, ocy = py - cy, ocz = pz - cz;
  const float d_oc = dot3(dx, dy, dz, ocx, ocy, ocz);
  const float oc2 = dot3(ocx, ocy, ocz, ocx, ocy, ocz);
  const float disc = d_oc * d_oc - oc2 + r2;
  const float sq = sqrtf(vmax(disc, 1e-20f));
  lam = min_positive(-d_oc - sq, -d_oc + sq);
  return disc >= 0.0f && lam >= 0.0f;
}

__device__ __forceinline__ float ddu(float u, float r_s) {
  return -u * (1.0f - 1.5f * r_s * u);
}

struct Geodesic {
  float px, py, pz;  // current segment start
  float dx, dy, dz;  // current direction
  float nx, ny, nz;  // orbital-plane basis
  float tx, ty, tz;
  float u, du, phi;  // Binet state
  float status;
  bool live;
};

// Orbital-plane init (frag:865, 883-887).
__device__ __forceinline__ void geodesic_init(Geodesic& g, const float* o,
                                              const float* d, bool marching) {
  g.px = o[0];
  g.py = o[1];
  g.pz = o[2];
  g.dx = d[0];
  g.dy = d[1];
  g.dz = d[2];
  const float inv = rnorm3(g.px, g.py, g.pz);
  g.nx = g.px * inv;
  g.ny = g.py * inv;
  g.nz = g.pz * inv;
  tangent_of(g.nx, g.ny, g.nz, g.dx, g.dy, g.dz, g.tx, g.ty, g.tz);
  const float nd0 = dot3(g.nx, g.ny, g.nz, g.dx, g.dy, g.dz);
  g.u = inv;
  const float dt0 = dot3(g.tx, g.ty, g.tz, g.dx, g.dy, g.dz);
  g.du = -g.u * nd0 / guard(dt0);
  g.phi = 0.0f;
  g.status = marching ? kMarching : kEscaped;
  g.live = marching;
}

// Far-field rule (frag:891-912).  A live ray with u < u_f either re-enters
// at the r = 1/u_f sphere with a new basis (done here, in place) or must
// finish flat: the return value, for the caller to resolve.
__device__ __forceinline__ bool far_field(Geodesic& g, const Params& p) {
  if (!(g.u < p.u_f)) return false;
  float big_lam;
  const bool big_ok = sphere_entry(g.px, g.py, g.pz, g.dx, g.dy, g.dz, 0.0f,
                                   0.0f, 0.0f, p.far_r2, big_lam);
  const float hx = g.px + big_lam * g.dx;
  const float hy = g.py + big_lam * g.dy;
  const float hz = g.pz + big_lam * g.dz;
  const float inv_h = rnorm3(hx, hy, hz);
  const float nnx = hx * inv_h, nny = hy * inv_h, nnz = hz * inv_h;
  const float nd = dot3(nnx, nny, nnz, g.dx, g.dy, g.dz);
  if (!big_ok || fabsf(nd) >= kRadialLimit) return true;
  float ntx, nty, ntz;
  tangent_of(nnx, nny, nnz, g.dx, g.dy, g.dz, ntx, nty, ntz);
  const float dt = dot3(ntx, nty, ntz, g.dx, g.dy, g.dz);
  g.nx = nnx;
  g.ny = nny;
  g.nz = nnz;
  g.tx = ntx;
  g.ty = nty;
  g.tz = ntz;
  g.u = inv_h;
  g.du = -inv_h * nd / guard(dt);
  return false;
}

// One RK4 step (frag:914-919, physics.rk4_step's operation order) and the
// Cartesian segment it spans (frag:924-928).
struct Step {
  float u1, du1, phi1;
  float npx, npy, npz;  // segment end
  float sdx, sdy, sdz;  // unit segment direction
  float seg_len;
};

__device__ __forceinline__ Step rk4_segment(const Geodesic& g, int i,
                                            const Params& p) {
  Step s;
  const float h = (p.max_angle - g.phi) / (float)(p.max_steps - i);
  s.phi1 = g.phi + h;
  const float u = g.u, du = g.du, r_s = p.r_s;
  const float k1 = du;
  const float l1 = ddu(u, r_s);
  const float k2 = du + 0.5f * l1 * h;
  const float l2 = ddu(u + 0.5f * k1 * h, r_s);
  const float k3 = du + 0.5f * l2 * h;
  const float l3 = ddu(u + 0.5f * k2 * h, r_s);
  const float k4 = du + l3 * h;
  const float l4 = ddu(u + k3 * h, r_s);
  const float h6 = h / 6.0f;
  s.u1 = u + h6 * (k1 + 2.0f * k2 + 2.0f * k3 + k4);
  s.du1 = du + h6 * (l1 + 2.0f * l2 + 2.0f * l3 + l4);

  // r clamped to 1e6: an overflow guard far past the far field.
  const float inv_u = 1.0f / vmax(s.u1, 1e-6f);
  const float c = cosf(s.phi1), sn = sinf(s.phi1);
  s.npx = (c * g.nx + sn * g.tx) * inv_u;
  s.npy = (c * g.ny + sn * g.ty) * inv_u;
  s.npz = (c * g.nz + sn * g.tz) * inv_u;
  const float ddx = s.npx - g.px, ddy = s.npy - g.py, ddz = s.npz - g.pz;
  s.seg_len = len3(ddx, ddy, ddz);
  const float inv_seg = rnorm3(ddx, ddy, ddz);
  s.sdx = ddx * inv_seg;
  s.sdy = ddy * inv_seg;
  s.sdz = ddz * inv_seg;
  return s;
}

// The ray moves to the end of its segment.
__device__ __forceinline__ void advance(Geodesic& g, const Step& s) {
  g.px = s.npx;
  g.py = s.npy;
  g.pz = s.npz;
  g.dx = s.sdx;
  g.dy = s.sdy;
  g.dz = s.sdz;
  g.u = s.u1;
  g.du = s.du1;
  g.phi = s.phi1;
}

}  // namespace march
