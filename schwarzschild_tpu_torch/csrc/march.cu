// Geodesic march kernels for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by schwarzschild_tpu_torch/_ext.py).
//
// march_bh_kernel replaces the Pallas kernel _march_kernel
// (schwarzschild_tpu/kernel.py:252, launched at kernel.py:406): the
// horizon + sky march.
//
// march_scene_kernel replaces _scene_march_kernel
// (schwarzschild_tpu/kernel_scene.py:961, launched at kernel_scene.py:1093):
// the same march plus, per segment, validity-only tests against the horizon
// and every scene-table row, recording each hit segment into K slots.
//
// What bounds them on an H100: arithmetic and its latency.  Each ray reads
// 25 bytes and writes 16 (bh) or 40 + 28 K bytes (scene), then runs up to
// 100 RK4 steps of about 150 dependent f32 operations plus sinf/cosf, and
// the scene kernel about 60 more per table row per step.  The TPU kernel
// marched an (8, 128) tile until its last lane finished; here every thread
// stops at its own ray's end (exact: a finished ray's step is the
// identity), so the cost is the per-warp maximum of the march lengths.
// State lives in registers, the tables are a few hundred bytes read through
// the cache by every thread at the same address, and slots are written to
// their output planes at the step that records them.  The launch uses 128
// threads per block over the flattened rays with the tail masked, so an
// image of any size needs no padding copy.
#include <cuda_runtime.h>

#include "march_common.cuh"

namespace {

using march::Geodesic;
using march::Params;
using march::Step;

constexpr int kThreads = 128;

// Table row widths, in the order the tables sit in the buffer (the same
// columns as kernel_scene._pack_scene_smem of the JAX package).
constexpr int kSphereCols = 5;     // pos, radius, opaque
constexpr int kPlaneCols = 7;      // pos, normal, opaque
constexpr int kDiskCols = 8;       // pos, normal, radius^2, opaque
constexpr int kHollowCols = 9;     // pos, normal, inner^2, outer^2, opaque
constexpr int kCylinderCols = 15;  // pos, axes (3 columns), height, radius, opaque
constexpr int kRectCols = 15;      // pos, axes (3 columns), width, height, opaque

struct Tables {
  const float* data;
  int n_sphere, n_plane, n_disk, n_hollow, n_cylinder, n_rect;
};

__device__ __forceinline__ bool within(float lam, float seg_len) {
  return lam >= 0.0f && lam <= seg_len;
}

// Plane lambda of one table row whose point is t[0..2] and normal t[3..5]
// (kernel_scene.py:405-411: this guard is not sign-preserving).
__device__ __forceinline__ bool plane_lam(const float* t, float nxs, float nys,
                                          float nzs, float px, float py,
                                          float pz, float sdx, float sdy,
                                          float sdz, float seg_len,
                                          float& lam) {
  const float denom = march::dot3(nxs, nys, nzs, sdx, sdy, sdz);
  const float num = nxs * (t[0] - px) + nys * (t[1] - py) + nzs * (t[2] - pz);
  lam = num / march::guard(denom);
  return fabsf(denom) >= march::kEps && within(lam, seg_len);
}

// Closest hit lambda of the segment over every table row (INF if none),
// and the closest over the rows flagged provably opaque
// (segment_min_dist, kernel_scene.py:376-492).
__device__ __forceinline__ void segment_min_dist(
    const Tables& tab, float px, float py, float pz, float sdx, float sdy,
    float sdz, float seg_len, float& best, float& best_opq) {
  best = INFINITY;
  best_opq = INFINITY;
  const float* t = tab.data;
  auto fold = [&](bool ok, float lam, float opq) {
    const float cand = ok ? lam : INFINITY;
    best = fminf(best, cand);
    best_opq = fminf(best_opq, opq > 0.5f ? cand : INFINITY);
  };

  for (int i = 0; i < tab.n_sphere; ++i, t += kSphereCols) {
    float lam;
    const bool ok = march::sphere_entry(px, py, pz, sdx, sdy, sdz, t[0], t[1],
                                        t[2], t[3] * t[3], lam);
    fold(ok && within(lam, seg_len), lam, t[4]);
  }
  for (int i = 0; i < tab.n_plane; ++i, t += kPlaneCols) {
    float lam;
    const bool ok =
        plane_lam(t, t[3], t[4], t[5], px, py, pz, sdx, sdy, sdz, seg_len, lam);
    fold(ok, lam, t[6]);
  }
  for (int i = 0; i < tab.n_disk; ++i, t += kDiskCols) {
    float lam;
    bool ok =
        plane_lam(t, t[3], t[4], t[5], px, py, pz, sdx, sdy, sdz, seg_len, lam);
    const float hx = px + lam * sdx - t[0];
    const float hy = py + lam * sdy - t[1];
    const float hz = pz + lam * sdz - t[2];
    ok = ok && march::dot3(hx, hy, hz, hx, hy, hz) <= t[6];
    fold(ok, lam, t[7]);
  }
  for (int i = 0; i < tab.n_hollow; ++i, t += kHollowCols) {
    float lam;
    bool ok =
        plane_lam(t, t[3], t[4], t[5], px, py, pz, sdx, sdy, sdz, seg_len, lam);
    const float hx = px + lam * sdx - t[0];
    const float hy = py + lam * sdy - t[1];
    const float hz = pz + lam * sdz - t[2];
    const float sq = march::dot3(hx, hy, hz, hx, hy, hz);
    ok = ok && sq >= t[6] && sq <= t[7];
    fold(ok, lam, t[8]);
  }
  for (int i = 0; i < tab.n_cylinder; ++i, t += kCylinderCols) {
    const float rx = px - t[0], ry = py - t[1], rz = pz - t[2];
    const float lox = march::dot3(t[3], t[4], t[5], rx, ry, rz);
    const float loy = march::dot3(t[6], t[7], t[8], rx, ry, rz);
    const float loz = march::dot3(t[9], t[10], t[11], rx, ry, rz);
    const float ldx = march::dot3(t[3], t[4], t[5], sdx, sdy, sdz);
    const float ldy = march::dot3(t[6], t[7], t[8], sdx, sdy, sdz);
    const float ldz = march::dot3(t[9], t[10], t[11], sdx, sdy, sdz);
    const float height = t[12], radius = t[13];
    const float a = lox * ldx + loz * ldz;
    const float dps = ldx * ldx + ldz * ldz;
    const float disc = a * a + dps * (radius * radius - (lox * lox + loz * loz));
    const float sq = sqrtf(march::vmax(disc, 1e-20f));
    const float dps_s = march::guard(dps);
    const float lam1 = -(a + sq) / dps_s;
    const float lam2 = -(a - sq) / dps_s;
    const float y1 = loy + lam1 * ldy;
    const float y2 = loy + lam2 * ldy;
    const bool in1 = y1 >= 0.0f && y1 <= height;
    const bool in2 = y2 >= 0.0f && y2 <= height;
    const float lam = (in1 && in2) ? march::min_positive(lam1, lam2)
                                   : (in1 ? lam1 : (in2 ? lam2 : -1.0f));
    fold(disc >= 0.0f && (in1 || in2) && within(lam, seg_len), lam, t[14]);
  }
  for (int i = 0; i < tab.n_rect; ++i, t += kRectCols) {
    float lam;
    bool ok =
        plane_lam(t, t[6], t[7], t[8], px, py, pz, sdx, sdy, sdz, seg_len, lam);
    const float hx = px + lam * sdx - t[0];
    const float hy = py + lam * sdy - t[1];
    const float hz = pz + lam * sdz - t[2];
    const float alpha = march::dot3(t[3], t[4], t[5], hx, hy, hz);
    const float beta = march::dot3(t[9], t[10], t[11], hx, hy, hz);
    ok = ok && alpha >= 0.0f && alpha <= t[12] && beta >= 0.0f &&
         beta <= t[13];
    fold(ok, lam, t[14]);
  }
}

__global__ void __launch_bounds__(kThreads)
    march_bh_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const unsigned char* __restrict__ active,
                    float* __restrict__ fdir, float* __restrict__ status,
                    Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const float rs2 = p.r_s * p.r_s;
  Geodesic g;
  march::geodesic_init(g, origin + 3 * idx, direction + 3 * idx,
                       active[idx] != 0);
  for (int i = 0; i < p.max_steps && g.live; ++i) {
    float lam;
    if (march::far_field(g, p)) {
      // Flat finish: one unbounded horizon test (horizon + sky scene).
      const bool bh = march::sphere_entry(g.px, g.py, g.pz, g.dx, g.dy, g.dz,
                                          0.0f, 0.0f, 0.0f, rs2, lam);
      g.status = bh ? march::kCaptured : march::kEscaped;
      g.live = false;
      break;
    }
    const Step s = march::rk4_segment(g, i, p);
    if (s.u1 < 0.0f) {
      g.status = march::kEscaped;
      g.live = false;
      break;
    }
    const bool cap = march::sphere_entry(g.px, g.py, g.pz, s.sdx, s.sdy, s.sdz,
                                         0.0f, 0.0f, 0.0f, rs2, lam);
    march::advance(g, s);
    if (cap && lam <= s.seg_len) {
      g.status = march::kCaptured;
      g.live = false;
    }
  }
  // Rays still marching after max_steps escape to the sky (frag:935).
  status[idx] = g.live ? march::kEscaped : g.status;
  fdir[3 * idx + 0] = g.dx;
  fdir[3 * idx + 1] = g.dy;
  fdir[3 * idx + 2] = g.dz;
}

__global__ void __launch_bounds__(kThreads)
    march_scene_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const unsigned char* __restrict__ active, Tables tab,
                       float* __restrict__ fdir, float* __restrict__ fpos,
                       float* __restrict__ status, float* __restrict__ nhits,
                       float* __restrict__ slot_start,
                       float* __restrict__ slot_dir,
                       float* __restrict__ slot_len, int n_slots, Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const float rs2 = p.r_s * p.r_s;
  Geodesic g;
  march::geodesic_init(g, origin + 3 * idx, direction + 3 * idx,
                       active[idx] != 0);
  int nh = 0;
  for (int i = 0; i < p.max_steps && g.live; ++i) {
    if (march::far_field(g, p)) {
      // The flat continuation is composed outside from (fpos, fdir).
      g.status = march::kFlatFinish;
      g.live = false;
      break;
    }
    const Step s = march::rk4_segment(g, i, p);
    if (s.u1 < 0.0f) {
      g.status = march::kEscaped;
      g.live = false;
      break;
    }
    float bh_lam;
    const bool bh_ok = march::sphere_entry(g.px, g.py, g.pz, s.sdx, s.sdy,
                                           s.sdz, 0.0f, 0.0f, 0.0f, rs2,
                                           bh_lam);
    const float bh = (bh_ok && within(bh_lam, s.seg_len)) ? bh_lam : INFINITY;
    float best, best_opq;
    segment_min_dist(tab, g.px, g.py, g.pz, s.sdx, s.sdy, s.sdz, s.seg_len,
                     best, best_opq);
    bool captured = false, opaque = false;
    if (fminf(best, bh) < INFINITY) {
      captured = bh <= best;                      // the horizon wins ties
      opaque = !captured && best_opq <= best;     // provably opaque closest
      if (nh < n_slots) {  // later hits are only counted
        const size_t o = (size_t)nh * p.n + idx;
        slot_start[3 * o + 0] = g.px;
        slot_start[3 * o + 1] = g.py;
        slot_start[3 * o + 2] = g.pz;
        slot_dir[3 * o + 0] = s.sdx;
        slot_dir[3 * o + 1] = s.sdy;
        slot_dir[3 * o + 2] = s.sdz;
        slot_len[o] = s.seg_len;
      }
      ++nh;
    }
    march::advance(g, s);
    if (captured || opaque) {
      g.status = captured ? march::kCaptured : march::kHitOpaque;
      g.live = false;
    }
  }
  status[idx] = g.live ? march::kEscaped : g.status;
  nhits[idx] = (float)nh;
  fdir[3 * idx + 0] = g.dx;
  fdir[3 * idx + 1] = g.dy;
  fdir[3 * idx + 2] = g.dz;
  fpos[3 * idx + 0] = g.px;
  fpos[3 * idx + 1] = g.py;
  fpos[3 * idx + 2] = g.pz;
}

Params make_params(int n, float r_s, int max_steps, float max_angle, float u_f,
                   float far_r2) {
  Params p;
  p.n = n;
  p.max_steps = max_steps;
  p.r_s = r_s;
  p.max_angle = max_angle;
  p.u_f = u_f;
  p.far_r2 = far_r2;
  return p;
}

}  // namespace

extern "C" {

// Each launch function enqueues one kernel on ``stream`` and returns
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// check reports it.
int march_bh_launch(const float* origin, const float* direction,
                    const unsigned char* active, float* fdir, float* status,
                    int n, float r_s, int max_steps, float max_angle,
                    float u_f, float far_r2, void* stream) {
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const int blocks = (n + kThreads - 1) / kThreads;
  march_bh_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, fdir, status, p);
  return (int)cudaGetLastError();
}

int march_scene_launch(const float* origin, const float* direction,
                       const unsigned char* active, const float* tables,
                       int n_sphere, int n_plane, int n_disk, int n_hollow,
                       int n_cylinder, int n_rect, float* fdir, float* fpos,
                       float* status, float* nhits, float* slot_start,
                       float* slot_dir, float* slot_len, int n_slots, int n,
                       float r_s, int max_steps, float max_angle, float u_f,
                       float far_r2, void* stream) {
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const Tables tab{tables, n_sphere, n_plane, n_disk, n_hollow, n_cylinder,
                   n_rect};
  const int blocks = (n + kThreads - 1) / kThreads;
  march_scene_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, tab, fdir, fpos, status, nhits, slot_start,
      slot_dir, slot_len, n_slots, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
