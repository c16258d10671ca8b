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

// ---------------------------------------------------------------------------
// The differentiable core and its adjoint (the backward kernel).
//
// The core is the 15 values of a Geodesic that carry gradients (position,
// direction, basis, u, du, phi); _CORE of schwarzschild_tpu/kernel_scene.py
// orders them the same way.  diff_step replays one march step at decisions
// fixed by the forward run (live_in, moved) through the forward's own
// far_field and rk4_segment, so the replayed core is bit-identical to the
// forward's (the re-init test is recomputed from the replayed values, as
// kernel_scene.py:739-743 does).  The *_vjp functions are reverse-mode
// derivatives written by hand, one per piece of the forward, with the JAX
// package's conventions at the guards:
//   * max(x, c) passes 1 above c, 1/2 at a tie, 0 below (jnp.maximum);
//   * min(a, b) passes to the smaller, 1/2 each at a tie (jnp.minimum);
//   * guard(x) passes nothing where it replaced x;
//   * a select passes only to the branch it took.
// Each *_vjp ADDS its contributions to the cotangents it is given.
// ---------------------------------------------------------------------------

constexpr int kCoreFields = 15;

// Cotangents of the core's 15 values.
struct CoreCt {
  float px, py, pz, dx, dy, dz, nx, ny, nz, tx, ty, tz, u, du, phi;
};

// A store of cores is laid out [step][field][ray] (n rays): a warp's
// stores and loads of one field at one step touch consecutive addresses.
// The adjoint keeps its checkpoints so in device memory and the steps of
// one checkpoint interval so in shared memory (n = the block's threads,
// idx = the thread: conflict-free banks).
__device__ __forceinline__ void core_store(const Geodesic& g, float* save,
                                           int i, int n, int idx) {
  float* s = save + (size_t)i * kCoreFields * n + idx;
  const float v[kCoreFields] = {g.px, g.py, g.pz, g.dx, g.dy, g.dz, g.nx,
                                g.ny, g.nz, g.tx, g.ty, g.tz, g.u,  g.du,
                                g.phi};
#pragma unroll
  for (int f = 0; f < kCoreFields; ++f) s[(size_t)f * n] = v[f];
}

__device__ __forceinline__ void core_load(Geodesic& g, const float* save,
                                          int i, int n, int idx) {
  const float* s = save + (size_t)i * kCoreFields * n + idx;
  g.px = s[0];
  g.py = s[(size_t)1 * n];
  g.pz = s[(size_t)2 * n];
  g.dx = s[(size_t)3 * n];
  g.dy = s[(size_t)4 * n];
  g.dz = s[(size_t)5 * n];
  g.nx = s[(size_t)6 * n];
  g.ny = s[(size_t)7 * n];
  g.nz = s[(size_t)8 * n];
  g.tx = s[(size_t)9 * n];
  g.ty = s[(size_t)10 * n];
  g.tz = s[(size_t)11 * n];
  g.u = s[(size_t)12 * n];
  g.du = s[(size_t)13 * n];
  g.phi = s[(size_t)14 * n];
  g.status = kMarching;
  g.live = true;
}

// One march step at fixed decisions (_make_diff_step of the JAX package):
// a live ray takes the far-field re-init if its values call for it, and a
// ray that moved takes its segment's end.
__device__ __forceinline__ void diff_step(Geodesic& g, int i, bool live_in,
                                          bool moved, const Params& p) {
  if (live_in) far_field(g, p);  // a flat finish leaves g as it is
  const Step s = rk4_segment(g, i, p);
  if (moved) advance(g, s);
}

// d max(x, c) / dx (jnp.maximum's convention).
__device__ __forceinline__ float vmax_grad(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

// a += g * b for 3-vectors.
__device__ __forceinline__ void axpy3(float g, float bx, float by, float bz,
                                      float& ax, float& ay, float& az) {
  ax += g * bx;
  ay += g * by;
  az += g * bz;
}

// inv = rnorm3(x, y, z): adds the cotangent g_inv to (gx, gy, gz).
__device__ __forceinline__ void rnorm3_vjp(float x, float y, float z,
                                           float inv, float g_inv, float& gx,
                                           float& gy, float& gz) {
  const float m = x * x + y * y + z * z;
  const float g_m =
      g_inv * (-0.5f * inv / vmax(m, 1e-20f)) * vmax_grad(m, 1e-20f);
  axpy3(2.0f * g_m, x, y, z, gx, gy, gz);
}

// len = len3(x, y, z): adds the cotangent g_len to (gx, gy, gz).
__device__ __forceinline__ void len3_vjp(float x, float y, float z, float len,
                                         float g_len, float& gx, float& gy,
                                         float& gz) {
  const float m = x * x + y * y + z * z;
  const float g_m = g_len * (0.5f / len) * vmax_grad(m, 1e-20f);
  axpy3(2.0f * g_m, x, y, z, gx, gy, gz);
}

// t = tangent_of(n, d): adds the cotangent (gtx, gty, gtz) to g_n and g_d.
// With c = n x d and x = c x n: g_c = n x g_x, g_n += g_x x c + d x g_c,
// g_d += g_c x n.
__device__ __forceinline__ void tangent_of_vjp(
    float nx, float ny, float nz, float dx, float dy, float dz, float gtx,
    float gty, float gtz, float& gnx, float& gny, float& gnz, float& gdx,
    float& gdy, float& gdz) {
  const float cx = ny * dz - nz * dy;
  const float cy = nz * dx - nx * dz;
  const float cz = nx * dy - ny * dx;
  const float x = cy * nz - cz * ny;
  const float y = cz * nx - cx * nz;
  const float z = cx * ny - cy * nx;
  const float inv = rnorm3(x, y, z);
  float gx = gtx * inv, gy = gty * inv, gz = gtz * inv;
  rnorm3_vjp(x, y, z, inv, dot3(gtx, gty, gtz, x, y, z), gx, gy, gz);
  const float gcx = ny * gz - nz * gy;
  const float gcy = nz * gx - nx * gz;
  const float gcz = nx * gy - ny * gx;
  gnx += (gy * cz - gz * cy) + (dy * gcz - dz * gcy);
  gny += (gz * cx - gx * cz) + (dz * gcx - dx * gcz);
  gnz += (gx * cy - gy * cx) + (dx * gcy - dy * gcx);
  gdx += gcy * nz - gcz * ny;
  gdy += gcz * nx - gcx * nz;
  gdz += gcx * ny - gcy * nx;
}

// du = -u * nd / guard(dt): the cotangents of u, nd and dt.
__device__ __forceinline__ void binet_du_vjp(float u, float nd, float dt,
                                             float du, float g_du, float& g_u,
                                             float& g_nd, float& g_dt) {
  const float den = guard(dt);
  const float g_num = g_du / den;
  g_u += -g_num * nd;
  g_nd += g_num * -u;
  if (!(fabsf(dt) < 1e-12f)) g_dt += -g_du * du / den;
}

// min_positive(a, b): the cotangents of a and b.
__device__ __forceinline__ void min_positive_vjp(float a, float b, float g,
                                                 float& ga, float& gb) {
  if (a > 0.0f && b > 0.0f) {
    if (a < b) {
      ga += g;
    } else if (b < a) {
      gb += g;
    } else {
      ga += 0.5f * g;
      gb += 0.5f * g;
    }
  } else if (a > 0.0f) {
    ga += g;
  } else if (b > 0.0f) {
    gb += g;
  }
}

// The far-field re-init values (nn, nt, new_u, new_du) of far_field as
// functions of the core's (p, d): adds their cotangents to ct.p and ct.d.
__device__ __forceinline__ void far_field_vjp(
    const Geodesic& c, const Params& p, float g_nnx, float g_nny, float g_nnz,
    float g_ntx, float g_nty, float g_ntz, float g_new_u, float g_new_du,
    CoreCt& ct) {
  // Forward values, as far_field and sphere_entry compute them.
  const float d_oc = dot3(c.dx, c.dy, c.dz, c.px, c.py, c.pz);
  const float oc2 = dot3(c.px, c.py, c.pz, c.px, c.py, c.pz);
  const float disc = d_oc * d_oc - oc2 + p.far_r2;
  const float sq = sqrtf(vmax(disc, 1e-20f));
  const float lam1 = -d_oc - sq, lam2 = -d_oc + sq;
  const float big_lam = min_positive(lam1, lam2);
  const float hx = c.px + big_lam * c.dx;
  const float hy = c.py + big_lam * c.dy;
  const float hz = c.pz + big_lam * c.dz;
  const float inv_h = rnorm3(hx, hy, hz);
  const float nnx = hx * inv_h, nny = hy * inv_h, nnz = hz * inv_h;
  const float nd = dot3(nnx, nny, nnz, c.dx, c.dy, c.dz);
  float ntx, nty, ntz;
  tangent_of(nnx, nny, nnz, c.dx, c.dy, c.dz, ntx, nty, ntz);
  const float dt = dot3(ntx, nty, ntz, c.dx, c.dy, c.dz);
  const float new_du = -inv_h * nd / guard(dt);

  // Reverse.
  float g_inv_h = g_new_u, g_nd = 0.0f, g_dt = 0.0f;
  binet_du_vjp(inv_h, nd, dt, new_du, g_new_du, g_inv_h, g_nd, g_dt);
  axpy3(g_dt, c.dx, c.dy, c.dz, g_ntx, g_nty, g_ntz);
  axpy3(g_dt, ntx, nty, ntz, ct.dx, ct.dy, ct.dz);
  tangent_of_vjp(nnx, nny, nnz, c.dx, c.dy, c.dz, g_ntx, g_nty, g_ntz, g_nnx,
                 g_nny, g_nnz, ct.dx, ct.dy, ct.dz);
  axpy3(g_nd, c.dx, c.dy, c.dz, g_nnx, g_nny, g_nnz);
  axpy3(g_nd, nnx, nny, nnz, ct.dx, ct.dy, ct.dz);
  float g_hx = g_nnx * inv_h, g_hy = g_nny * inv_h, g_hz = g_nnz * inv_h;
  g_inv_h += dot3(g_nnx, g_nny, g_nnz, hx, hy, hz);
  rnorm3_vjp(hx, hy, hz, inv_h, g_inv_h, g_hx, g_hy, g_hz);
  ct.px += g_hx;
  ct.py += g_hy;
  ct.pz += g_hz;
  const float g_lam = dot3(g_hx, g_hy, g_hz, c.dx, c.dy, c.dz);
  axpy3(big_lam, g_hx, g_hy, g_hz, ct.dx, ct.dy, ct.dz);
  float g_lam1 = 0.0f, g_lam2 = 0.0f;
  min_positive_vjp(lam1, lam2, g_lam, g_lam1, g_lam2);
  float g_doc = -(g_lam1 + g_lam2);
  const float g_sq = g_lam2 - g_lam1;
  const float g_disc = g_sq * (0.5f / sq) * vmax_grad(disc, 1e-20f);
  g_doc += 2.0f * d_oc * g_disc;
  axpy3(-2.0f * g_disc, c.px, c.py, c.pz, ct.px, ct.py, ct.pz);
  axpy3(g_doc, c.px, c.py, c.pz, ct.dx, ct.dy, ct.dz);
  axpy3(g_doc, c.dx, c.dy, c.dz, ct.px, ct.py, ct.pz);
}

// ddu(u, r_s) = -u (1 - 1.5 r_s u): its derivatives in u and in r_s.
__device__ __forceinline__ float ddu_du(float u, float r_s) {
  return -(1.0f - 1.5f * r_s * u) + 1.5f * r_s * u;
}

__device__ __forceinline__ float ddu_drs(float u) { return 1.5f * u * u; }

// The VJP of diff_step at step i from its input core c (as phase 1 saved
// it).  On entry ct is the cotangent of the step's output core and gs[7]
// that of its slot values (start p, segment direction, segment length); on
// return ct is the cotangent of the input core.  g_rs accumulates the r_s
// cotangent.
__device__ __forceinline__ void diff_step_vjp(const Geodesic& c, int i,
                                              bool live_in, bool moved,
                                              const Params& p, CoreCt& ct,
                                              const float* gs, float& g_rs) {
  // Forward, through the forward's own functions: g holds the basis and
  // (u0, du0) the RK4 step starts from.
  Geodesic g = c;
  bool reinit = false;
  if (live_in && c.u < p.u_f) reinit = !far_field(g, p);
  const Step s = rk4_segment(g, i, p);
  const float u0 = g.u, du0 = g.du, r_s = p.r_s;
  const float h = (p.max_angle - c.phi) / (float)(p.max_steps - i);
  const float k1 = du0;
  const float l1 = ddu(u0, r_s);
  const float k2 = du0 + 0.5f * l1 * h;
  const float a2 = u0 + 0.5f * k1 * h;
  const float l2 = ddu(a2, r_s);
  const float k3 = du0 + 0.5f * l2 * h;
  const float a3 = u0 + 0.5f * k2 * h;
  const float l3 = ddu(a3, r_s);
  const float k4 = du0 + l3 * h;
  const float a4 = u0 + k3 * h;
  const float l4 = ddu(a4, r_s);
  const float h6 = h / 6.0f;
  const float su = k1 + 2.0f * k2 + 2.0f * k3 + k4;
  const float sl = l1 + 2.0f * l2 + 2.0f * l3 + l4;
  const float inv_u = 1.0f / vmax(s.u1, 1e-6f);
  const float cphi = cosf(s.phi1), sphi = sinf(s.phi1);
  const float qx = cphi * g.nx + sphi * g.tx;
  const float qy = cphi * g.ny + sphi * g.ty;
  const float qz = cphi * g.nz + sphi * g.tz;
  const float ddx = s.npx - c.px, ddy = s.npy - c.py, ddz = s.npz - c.pz;
  const float inv_seg = rnorm3(ddx, ddy, ddz);

  // The output selects.
  CoreCt in{};
  float g_npx = 0.0f, g_npy = 0.0f, g_npz = 0.0f;
  float g_sdx = gs[3], g_sdy = gs[4], g_sdz = gs[5];
  float g_u1 = 0.0f, g_du1 = 0.0f, g_phi1 = 0.0f;
  float g_u0 = 0.0f, g_du0 = 0.0f;
  if (moved) {
    g_npx = ct.px;
    g_npy = ct.py;
    g_npz = ct.pz;
    g_sdx += ct.dx;
    g_sdy += ct.dy;
    g_sdz += ct.dz;
    g_u1 = ct.u;
    g_du1 = ct.du;
    g_phi1 = ct.phi;
  } else {
    in.px = ct.px;
    in.py = ct.py;
    in.pz = ct.pz;
    in.dx = ct.dx;
    in.dy = ct.dy;
    in.dz = ct.dz;
    g_u0 = ct.u;
    g_du0 = ct.du;
    in.phi = ct.phi;
  }
  float g_nx = ct.nx, g_ny = ct.ny, g_nz = ct.nz;
  float g_tx = ct.tx, g_ty = ct.ty, g_tz = ct.tz;
  in.px += gs[0];  // the slot's start is the input position
  in.py += gs[1];
  in.pz += gs[2];

  // Segment: sd = dd * inv_seg, seg_len = len3(dd), dd = np - p.
  float g_ddx = g_sdx * inv_seg, g_ddy = g_sdy * inv_seg,
        g_ddz = g_sdz * inv_seg;
  rnorm3_vjp(ddx, ddy, ddz, inv_seg, dot3(g_sdx, g_sdy, g_sdz, ddx, ddy, ddz),
             g_ddx, g_ddy, g_ddz);
  len3_vjp(ddx, ddy, ddz, s.seg_len, gs[6], g_ddx, g_ddy, g_ddz);
  g_npx += g_ddx;
  g_npy += g_ddy;
  g_npz += g_ddz;
  in.px -= g_ddx;
  in.py -= g_ddy;
  in.pz -= g_ddz;

  // Polar -> Cartesian: np = q * inv_u, q = cos(phi1) n + sin(phi1) t.
  const float g_inv_u = dot3(g_npx, g_npy, g_npz, qx, qy, qz);
  const float g_qx = g_npx * inv_u, g_qy = g_npy * inv_u,
              g_qz = g_npz * inv_u;
  g_u1 += -g_inv_u * inv_u * inv_u * vmax_grad(s.u1, 1e-6f);
  axpy3(cphi, g_qx, g_qy, g_qz, g_nx, g_ny, g_nz);
  axpy3(sphi, g_qx, g_qy, g_qz, g_tx, g_ty, g_tz);
  const float g_c = dot3(g_qx, g_qy, g_qz, g.nx, g.ny, g.nz);
  const float g_s = dot3(g_qx, g_qy, g_qz, g.tx, g.ty, g.tz);
  g_phi1 += -sphi * g_c + cphi * g_s;

  // RK4 (physics.rk4_step), in reverse.
  g_u0 += g_u1;
  g_du0 += g_du1;
  float g_h = (g_u1 * su + g_du1 * sl) / 6.0f;
  const float g_su = g_u1 * h6, g_sl = g_du1 * h6;
  float g_k1 = g_su, g_k2 = 2.0f * g_su, g_k3 = 2.0f * g_su;
  const float g_k4 = g_su;
  float g_l1 = g_sl, g_l2 = 2.0f * g_sl, g_l3 = 2.0f * g_sl;
  const float g_l4 = g_sl;
  const float g_a4 = g_l4 * ddu_du(a4, r_s);
  g_rs += g_l4 * ddu_drs(a4);
  g_du0 += g_k4;
  g_l3 += g_k4 * h;
  g_h += g_k4 * l3;
  g_u0 += g_a4;
  g_k3 += g_a4 * h;
  g_h += g_a4 * k3;
  const float g_a3 = g_l3 * ddu_du(a3, r_s);
  g_rs += g_l3 * ddu_drs(a3);
  g_du0 += g_k3;
  g_l2 += g_k3 * 0.5f * h;
  g_h += g_k3 * 0.5f * l2;
  g_u0 += g_a3;
  g_k2 += g_a3 * 0.5f * h;
  g_h += g_a3 * 0.5f * k2;
  const float g_a2 = g_l2 * ddu_du(a2, r_s);
  g_rs += g_l2 * ddu_drs(a2);
  g_du0 += g_k2;
  g_l1 += g_k2 * 0.5f * h;
  g_h += g_k2 * 0.5f * l1;
  g_u0 += g_a2;
  g_k1 += g_a2 * 0.5f * h;
  g_h += g_a2 * 0.5f * k1;
  g_u0 += g_l1 * ddu_du(u0, r_s);
  g_rs += g_l1 * ddu_drs(u0);
  g_du0 += g_k1;
  // phi1 = phi + h, h = (max_angle - phi) / (max_steps - i).
  g_h += g_phi1;
  in.phi += g_phi1 - g_h / (float)(p.max_steps - i);

  // The re-init select.
  if (reinit) {
    far_field_vjp(c, p, g_nx, g_ny, g_nz, g_tx, g_ty, g_tz, g_u0, g_du0, in);
  } else {
    in.nx += g_nx;
    in.ny += g_ny;
    in.nz += g_nz;
    in.tx += g_tx;
    in.ty += g_ty;
    in.tz += g_tz;
    in.u += g_u0;
    in.du += g_du0;
  }
  ct = in;
}

// The VJP of the init (geodesic_init's core, _init_core of the JAX
// package) from the cotangent ct of the initial core: g_o and g_d.
__device__ __forceinline__ void init_core_vjp(const float* o, const float* d,
                                              const CoreCt& ct, float* g_o,
                                              float* g_d) {
  Geodesic g;
  geodesic_init(g, o, d, true);
  const float inv = g.u;
  const float nd0 = dot3(g.nx, g.ny, g.nz, g.dx, g.dy, g.dz);
  const float dt0 = dot3(g.tx, g.ty, g.tz, g.dx, g.dy, g.dz);
  float gox = ct.px, goy = ct.py, goz = ct.pz;
  float gdx = ct.dx, gdy = ct.dy, gdz = ct.dz;
  float gnx = ct.nx, gny = ct.ny, gnz = ct.nz;
  float gtx = ct.tx, gty = ct.ty, gtz = ct.tz;
  float g_inv = ct.u, g_nd = 0.0f, g_dt = 0.0f;
  binet_du_vjp(inv, nd0, dt0, g.du, ct.du, g_inv, g_nd, g_dt);
  axpy3(g_dt, g.dx, g.dy, g.dz, gtx, gty, gtz);
  axpy3(g_dt, g.tx, g.ty, g.tz, gdx, gdy, gdz);
  axpy3(g_nd, g.dx, g.dy, g.dz, gnx, gny, gnz);
  axpy3(g_nd, g.nx, g.ny, g.nz, gdx, gdy, gdz);
  tangent_of_vjp(g.nx, g.ny, g.nz, g.dx, g.dy, g.dz, gtx, gty, gtz, gnx, gny,
                 gnz, gdx, gdy, gdz);
  axpy3(inv, gnx, gny, gnz, gox, goy, goz);
  g_inv += dot3(gnx, gny, gnz, g.px, g.py, g.pz);
  rnorm3_vjp(g.px, g.py, g.pz, inv, g_inv, gox, goy, goz);
  g_o[0] = gox;
  g_o[1] = goy;
  g_o[2] = goz;
  g_d[0] = gdx;
  g_d[1] = gdy;
  g_d[2] = gdz;
}

}  // namespace march
