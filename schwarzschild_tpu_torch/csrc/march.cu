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
// Both forward kernels can also record each ray's events (a template
// parameter, set when the caller passes their planes, so a plain frame's
// instantiation has no event code): t_end, the step of its terminal
// event (max_steps if it used up its steps, -1 if it never marched), and
// for the scene march sstep_k, the step at which slot k recorded (-1 if
// never); for the horizon march, whether the ray moved at its end step.  A
// ray's executed steps are min(t_end + 1, max_steps), so the same plane
// counts the work (count_steps in the wrappers).
//
// march_scene_bwd_kernel replaces _scene_march_bwd_kernel
// (schwarzschild_tpu/kernel_scene.py:787, launched at kernel_scene.py:940):
// the adjoint of either march with respect to origin, direction and r_s at
// the decisions the forward run took, read from its event planes, so it
// needs no scene table.  One thread per ray replays its own steps
// 0..min(t_end, max_steps - 1) through diff_step (march_common.cuh),
// saving the 15-value core of every step to a global scratch laid out
// [step][field][ray], then sweeps back through diff_step_vjp, adding each
// slot's cotangent at the step that recorded it, and ends with the VJP of
// the init.  Bound: its saves, 60 bytes a step written and read back once
// (6 KB a ray at 100 steps; 5.5 GB at 1280x720), beside about 2.5 times a
// forward step's arithmetic.  Checkpoint-and-recompute would trade the
// scratch for a second replay; this first version keeps the saves.
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

// kEvents: also write t_end and died_moving (as march_scene_kernel).
template <bool kEvents>
__global__ void __launch_bounds__(kThreads)
    march_bh_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const unsigned char* __restrict__ active,
                    float* __restrict__ fdir, float* __restrict__ status,
                    float* __restrict__ t_end,
                    unsigned char* __restrict__ died_moving, Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const float rs2 = p.r_s * p.r_s;
  Geodesic g;
  march::geodesic_init(g, origin + 3 * idx, direction + 3 * idx,
                       active[idx] != 0);
  const bool marched = g.live;
  bool moved_at_end = false;
  // A terminal event breaks out with i at its step; a ray that uses up its
  // steps leaves with i == max_steps.
  int i = 0;
  for (; i < p.max_steps && g.live; ++i) {
    float lam;
    if (march::far_field(g, p)) {
      // Flat finish: one unbounded horizon test (horizon + sky scene).  A
      // ray captured here did not move at this step.
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
      moved_at_end = true;
      break;
    }
  }
  if constexpr (kEvents) {
    t_end[idx] = marched ? (float)i : -1.0f;
    died_moving[idx] = moved_at_end;
  }
  // Rays still marching after max_steps escape to the sky (frag:935).
  status[idx] = g.live ? march::kEscaped : g.status;
  fdir[3 * idx + 0] = g.dx;
  fdir[3 * idx + 1] = g.dy;
  fdir[3 * idx + 2] = g.dz;
}

// kEvents: also write t_end and sstep_k.  A template parameter, so the
// frame's instantiation (false) compiles to the march without the event
// bookkeeping.
template <bool kEvents>
__global__ void __launch_bounds__(kThreads)
    march_scene_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const unsigned char* __restrict__ active, Tables tab,
                       float* __restrict__ fdir, float* __restrict__ fpos,
                       float* __restrict__ status, float* __restrict__ nhits,
                       float* __restrict__ slot_start,
                       float* __restrict__ slot_dir,
                       float* __restrict__ slot_len,
                       float* __restrict__ t_end, float* __restrict__ sstep,
                       int n_slots, Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const float rs2 = p.r_s * p.r_s;
  Geodesic g;
  march::geodesic_init(g, origin + 3 * idx, direction + 3 * idx,
                       active[idx] != 0);
  int nh = 0;
  int te = g.live ? p.max_steps : -1;  // kEvents: the terminal step
  for (int i = 0; i < p.max_steps && g.live; ++i) {
    if (march::far_field(g, p)) {
      // The flat continuation is composed outside from (fpos, fdir).
      g.status = march::kFlatFinish;
      g.live = false;
      if constexpr (kEvents) te = i;
      break;
    }
    const Step s = march::rk4_segment(g, i, p);
    if (s.u1 < 0.0f) {
      g.status = march::kEscaped;
      g.live = false;
      if constexpr (kEvents) te = i;
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
        if constexpr (kEvents) sstep[o] = (float)i;
      }
      ++nh;
    }
    march::advance(g, s);
    if (captured || opaque) {
      g.status = captured ? march::kCaptured : march::kHitOpaque;
      g.live = false;
      if constexpr (kEvents) te = i;
    }
  }
  if constexpr (kEvents) t_end[idx] = (float)te;
  status[idx] = g.live ? march::kEscaped : g.status;
  nhits[idx] = (float)nh;
  fdir[3 * idx + 0] = g.dx;
  fdir[3 * idx + 1] = g.dy;
  fdir[3 * idx + 2] = g.dz;
  fpos[3 * idx + 0] = g.px;
  fpos[3 * idx + 1] = g.py;
  fpos[3 * idx + 2] = g.pz;
}

__global__ void __launch_bounds__(kThreads)
    march_scene_bwd_kernel(const float* __restrict__ origin,
                           const float* __restrict__ direction,
                           const float* __restrict__ t_end,
                           const unsigned char* __restrict__ died_moving,
                           const float* __restrict__ sstep,
                           const float* __restrict__ ct_fdir,
                           const float* __restrict__ ct_fpos,
                           const float* __restrict__ ct_start,
                           const float* __restrict__ ct_sdir,
                           const float* __restrict__ ct_slen, int n_slots,
                           float* __restrict__ g_origin,
                           float* __restrict__ g_dir, float* __restrict__ g_rs,
                           float* __restrict__ save, Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const float te = t_end[idx];
  const bool dm = died_moving[idx] != 0;
  // Steps this ray ran forward; later steps are the identity.
  const int last = te < 0.0f ? 0 : min((int)te + 1, p.max_steps);
  const float* o = origin + 3 * idx;
  const float* d = direction + 3 * idx;

  // Phase 1: replay and save the core at the start of every step.
  Geodesic g;
  march::geodesic_init(g, o, d, true);
  for (int i = 0; i < last; ++i) {
    march::core_store(g, save, i, p.n, idx);
    const bool moved = (float)i < te || ((float)i == te && dm);
    march::diff_step(g, i, true, moved, p);
  }

  // Phase 2: sweep back from the final outputs' cotangents.
  march::CoreCt ct{};
  ct.px = ct_fpos[3 * idx + 0];
  ct.py = ct_fpos[3 * idx + 1];
  ct.pz = ct_fpos[3 * idx + 2];
  ct.dx = ct_fdir[3 * idx + 0];
  ct.dy = ct_fdir[3 * idx + 1];
  ct.dz = ct_fdir[3 * idx + 2];
  float grs = 0.0f;
  for (int i = last - 1; i >= 0; --i) {
    march::core_load(g, save, i, p.n, idx);
    float gs[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < n_slots; ++k) {
      const size_t s = (size_t)k * p.n + idx;
      if (sstep[s] == (float)i) {
        gs[0] += ct_start[3 * s + 0];
        gs[1] += ct_start[3 * s + 1];
        gs[2] += ct_start[3 * s + 2];
        gs[3] += ct_sdir[3 * s + 0];
        gs[4] += ct_sdir[3 * s + 1];
        gs[5] += ct_sdir[3 * s + 2];
        gs[6] += ct_slen[s];
      }
    }
    const bool moved = (float)i < te || ((float)i == te && dm);
    march::diff_step_vjp(g, i, true, moved, p, ct, gs, grs);
  }
  march::init_core_vjp(o, d, ct, g_origin + 3 * idx, g_dir + 3 * idx);
  g_rs[idx] = grs;
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
// Optional outputs (t_end, died_moving, sstep) may be null.
int march_bh_launch(const float* origin, const float* direction,
                    const unsigned char* active, float* fdir, float* status,
                    float* t_end, unsigned char* died_moving, int n, float r_s,
                    int max_steps, float max_angle, float u_f, float far_r2,
                    void* stream) {
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const int blocks = (n + kThreads - 1) / kThreads;
  auto kernel =
      t_end != nullptr ? march_bh_kernel<true> : march_bh_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, fdir, status, t_end, died_moving, p);
  return (int)cudaGetLastError();
}

int march_scene_launch(const float* origin, const float* direction,
                       const unsigned char* active, const float* tables,
                       int n_sphere, int n_plane, int n_disk, int n_hollow,
                       int n_cylinder, int n_rect, float* fdir, float* fpos,
                       float* status, float* nhits, float* slot_start,
                       float* slot_dir, float* slot_len, float* t_end,
                       float* sstep, int n_slots, int n, float r_s,
                       int max_steps, float max_angle, float u_f, float far_r2,
                       void* stream) {
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const Tables tab{tables, n_sphere, n_plane, n_disk, n_hollow, n_cylinder,
                   n_rect};
  const int blocks = (n + kThreads - 1) / kThreads;
  auto kernel = t_end != nullptr ? march_scene_kernel<true>
                                 : march_scene_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, tab, fdir, fpos, status, nhits, slot_start,
      slot_dir, slot_len, t_end, sstep, n_slots, p);
  return (int)cudaGetLastError();
}

// save: max_steps * 15 * n floats of scratch.
int march_scene_bwd_launch(const float* origin, const float* direction,
                           const float* t_end,
                           const unsigned char* died_moving,
                           const float* sstep, const float* ct_fdir,
                           const float* ct_fpos, const float* ct_start,
                           const float* ct_sdir, const float* ct_slen,
                           int n_slots, float* g_origin, float* g_dir,
                           float* g_rs, float* save, int n, float r_s,
                           int max_steps, float max_angle, float u_f,
                           float far_r2, void* stream) {
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const int blocks = (n + kThreads - 1) / kThreads;
  march_scene_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_end, died_moving, sstep, ct_fdir, ct_fpos,
      ct_start, ct_sdir, ct_slen, n_slots, g_origin, g_dir, g_rs, save, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
