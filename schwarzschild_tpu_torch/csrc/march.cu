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
// 0..min(t_end, max_steps - 1) through diff_step (march_common.cuh), then
// sweeps back through diff_step_vjp, adding each slot's cotangent at the
// step that recorded it, and ends with the VJP of the init.
//
// What bounds them on an H100: arithmetic and its latency.  Each ray reads
// 25 bytes and writes 16 (bh) or 40 + 28 K bytes (scene), then runs up to
// 100 RK4 steps of about 120 dependent f32 operations plus sinf/cosf.  The
// TPU kernel marched an (8, 128) tile until its last lane finished; here
// every thread stops at its own ray's end (exact: a finished ray's step is
// the identity), so the cost is the per-warp maximum of the march lengths.
// State lives in registers and slots are written to their output planes at
// the step that records them.  The bit-for-bit contract fixes the
// arithmetic (march_common.cuh), so the design works on which operations
// run and which rays share a warp:
//
// * The scene march's table tests were most of its work: every row's exact
//   test (35-81 operations) on every step, although almost every one is a
//   miss known in advance.  A TPU lane runs every row; a warp skips a
//   branch that none of its lanes takes.  So each row but a plane's has a
//   bounding sphere, a box's six faces one more, the scene one more, and a
//   step tests its segment against the scene's, then a group's, then a
//   row's, before a row's exact test (segment_min_dist below; the margins
//   that keep the cull exact under rounding: kernel_scene._row_bounds).
//   The tables are a few hundred bytes that every lane of a warp reads at
//   the same address: each block copies them into shared memory once (a
//   scene too large for that reads them from device memory, kSharedTables).
//   Each warp marches a 4 x 8 tile of pixels rather than 32 of one row, so
//   its lanes share cull decisions and march lengths (tile_ray).
//
// * The adjoint's traffic was its save scratch: the 60-byte core of every
//   step written and read back (2.4 GB at 1280x720, 5.5 GB allocated).  It
//   now saves the core at every kCkpt-th step only, and sweeps back one
//   checkpoint interval at a time: it replays the interval's steps from
//   its checkpoint into the thread's slice of shared memory, then runs
//   their VJPs from there.  One more forward replay a step buys a kCkpt
//   times smaller scratch and its traffic.
//
// * The horizon march has no tables: its work is the step's arithmetic,
//   which the contract fixes, and the lanes a warp idles while its longest
//   ray marches.  Its warps take 4 x 8 tiles too (BH_TILE_ROWS), so that
//   neighbouring rays, of similar lengths, share a warp; a 1-D batch of
//   rays keeps 32 consecutive rays a warp.
//
// Every kernel masks the image's ragged edge itself, so an image of any
// size needs no padding copy.
#include <cuda_runtime.h>

#include "march_common.cuh"

// The launch shapes and the checkpoint interval come from the build
// (_ext.DESIGN, passed as -D macros), so Python and CUDA share one value.
#if !defined(SCENE_THREADS) || !defined(TILE_ROWS) || !defined(BWD_THREADS) || \
    !defined(BWD_CKPT) || !defined(BH_THREADS) || !defined(BH_TILE_ROWS)
#error "build through schwarzschild_tpu_torch/_ext.py: it defines the design"
#endif

namespace {

using march::Geodesic;
using march::Params;
using march::Step;

// ---------------------------------------------------------------------------
// Table buffer (kernel_scene._kernel_tables builds it; 32-bit words,
// integer fields as int32 bit patterns):
//   [0, 4)            the scene's bound: cx, cy, cz, R;
//   [4, 4 + 8 G)      G groups: cx, cy, cz, R, type, first, rows, stride,
//                     the cylinders' groups first;
//   [4 + 8 G, planes) each group's rows, `stride` words apart: a row's
//                     bound (4 words), then its columns;
//   [planes, end)     the plane rows, kPlaneCols each, unbounded.
// A group is one row, or a box's six faces.  type is kSphere ... kRect,
// first the word offset of its first row.  A bound is a centre and a radius
// with margins (kernel_scene._row_bounds): a segment that does not reach it
// has no exact hit in what it bounds.
// ---------------------------------------------------------------------------

// Table row widths (the same columns as kernel_scene._pack_scene_smem of
// the JAX package).
constexpr int kSphereCols = 5;     // pos, radius, opaque
constexpr int kPlaneCols = 7;      // pos, normal, opaque
constexpr int kDiskCols = 8;       // pos, normal, radius^2, opaque
constexpr int kHollowCols = 9;     // pos, normal, inner^2, outer^2, opaque
constexpr int kCylinderCols = 15;  // pos, axes (3 columns), height, radius, opaque
constexpr int kRectCols = 15;      // pos, axes (3 columns), width, height, opaque

enum RowType { kSphere = 0, kDisk = 1, kHollow = 2, kCylinder = 3, kRect = 4 };

// Measured on an H100 at 1280x720 (tools/ab_march.py, kernel device time):
// tables in shared memory ran 2% faster than in constant memory and 10%
// faster than read from device memory; 4 x 8 tiles 5% faster than rows;
// 64- or 256-thread blocks no differently from 128.
constexpr int kSceneThreads = SCENE_THREADS;
constexpr int kTileRows = TILE_ROWS;  // a warp's pixel tile: 4 rows x 8 columns

struct Tables {
  const float* data;  // the buffer above in device memory
  int n_words, n_groups, n_cylinder_groups, planes_at, n_planes;
  // Half a segment's length, grown by the cull's relative margin
  // (kernel_scene.CULL_HALF).
  float cull_half;
};

__device__ __forceinline__ int word_int(const float* t, int i) {
  return __float_as_int(t[i]);
}

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

// One segment: its start, unit direction and length.
struct Seg {
  float px, py, pz, sdx, sdy, sdz, len;
};

// The exact row tests (segment_min_dist, kernel_scene.py:376-492 of the JAX
// package): the hit lambda within [0, len], or INFINITY.
__device__ __forceinline__ float hit_sphere(const float* t, const Seg& s) {
  float lam;
  const bool ok = march::sphere_entry(s.px, s.py, s.pz, s.sdx, s.sdy, s.sdz,
                                      t[0], t[1], t[2], t[3] * t[3], lam);
  return ok && within(lam, s.len) ? lam : INFINITY;
}

__device__ __forceinline__ float hit_plane(const float* t, const Seg& s) {
  float lam;
  const bool ok = plane_lam(t, t[3], t[4], t[5], s.px, s.py, s.pz, s.sdx,
                            s.sdy, s.sdz, s.len, lam);
  return ok ? lam : INFINITY;
}

__device__ __forceinline__ float hit_disk(const float* t, const Seg& s) {
  float lam;
  const bool ok = plane_lam(t, t[3], t[4], t[5], s.px, s.py, s.pz, s.sdx,
                            s.sdy, s.sdz, s.len, lam);
  const float hx = s.px + lam * s.sdx - t[0];
  const float hy = s.py + lam * s.sdy - t[1];
  const float hz = s.pz + lam * s.sdz - t[2];
  return ok && march::dot3(hx, hy, hz, hx, hy, hz) <= t[6] ? lam : INFINITY;
}

__device__ __forceinline__ float hit_hollow(const float* t, const Seg& s) {
  float lam;
  const bool ok = plane_lam(t, t[3], t[4], t[5], s.px, s.py, s.pz, s.sdx,
                            s.sdy, s.sdz, s.len, lam);
  const float hx = s.px + lam * s.sdx - t[0];
  const float hy = s.py + lam * s.sdy - t[1];
  const float hz = s.pz + lam * s.sdz - t[2];
  const float sq = march::dot3(hx, hy, hz, hx, hy, hz);
  return ok && sq >= t[6] && sq <= t[7] ? lam : INFINITY;
}

__device__ __forceinline__ float hit_cylinder(const float* t, const Seg& s) {
  const float rx = s.px - t[0], ry = s.py - t[1], rz = s.pz - t[2];
  const float lox = march::dot3(t[3], t[4], t[5], rx, ry, rz);
  const float loy = march::dot3(t[6], t[7], t[8], rx, ry, rz);
  const float loz = march::dot3(t[9], t[10], t[11], rx, ry, rz);
  const float ldx = march::dot3(t[3], t[4], t[5], s.sdx, s.sdy, s.sdz);
  const float ldy = march::dot3(t[6], t[7], t[8], s.sdx, s.sdy, s.sdz);
  const float ldz = march::dot3(t[9], t[10], t[11], s.sdx, s.sdy, s.sdz);
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
  return disc >= 0.0f && (in1 || in2) && within(lam, s.len) ? lam : INFINITY;
}

__device__ __forceinline__ float hit_rect(const float* t, const Seg& s) {
  float lam;
  const bool ok = plane_lam(t, t[6], t[7], t[8], s.px, s.py, s.pz, s.sdx,
                            s.sdy, s.sdz, s.len, lam);
  const float hx = s.px + lam * s.sdx - t[0];
  const float hy = s.py + lam * s.sdy - t[1];
  const float hz = s.pz + lam * s.sdz - t[2];
  const float alpha = march::dot3(t[3], t[4], t[5], hx, hy, hz);
  const float beta = march::dot3(t[9], t[10], t[11], hx, hy, hz);
  return ok && alpha >= 0.0f && alpha <= t[12] && beta >= 0.0f &&
                 beta <= t[13]
             ? lam
             : INFINITY;
}

// The cull test of one bound b: |m - c|^2 <= (R + hl)^2, with m the
// segment's grown midpoint (kernel_scene._reaches, same operation order).
__device__ __forceinline__ bool reaches(const float* b, float mx, float my,
                                        float mz, float hl) {
  const float ex = mx - b[0], ey = my - b[1], ez = mz - b[2];
  const float reach = b[3] + hl;
  return ex * ex + ey * ey + ez * ez <= reach * reach;
}

// A segment along a cylinder's axis: where hit_cylinder's dps = ldx^2 +
// ldz^2 is below 1e-12, its guard replaces dps and its lambda is no point
// of the cylinder (an axis-parallel segment "hits" at lambda = 100 at any
// distance), so no bound holds it.  The cull lets such segments through to
// the exact test: dps < 1e-12 needs |ldx| and |ldz| below 2e-6 (either at
// 2e-6 or more makes dps at least 3.9e-12 in f32), so testing those, with
// hit_cylinder's own ldx and ldz, passes every one (kernel_scene._parallel).
__device__ __forceinline__ bool axis_parallel(const float* t, const Seg& s) {
  const float ldx = march::dot3(t[3], t[4], t[5], s.sdx, s.sdy, s.sdz);
  if (!(fabsf(ldx) < 2e-6f)) return false;
  const float ldz = march::dot3(t[9], t[10], t[11], s.sdx, s.sdy, s.sdz);
  return fabsf(ldz) < 2e-6f;
}

// Closest hit lambda of the segment over every table row (INF if none),
// and the closest over the rows flagged provably opaque.  The exact test of
// a bounded row runs only where the segment reaches the scene's bound, its
// group's and (in a group of several rows) its own, or for a cylinder where
// the segment runs along its axis (axis_parallel); a skipped row folds
// INF, as its exact test would, and min() does not care about the order,
// so the result is the unculled fold's bit for bit.  The cylinders' groups
// (the first ones) are walked on every step, the others only inside the
// scene's bound.  The loops are uniform across a warp (every lane walks the
// same groups); a test that no lane of the warp passes skips its body for
// the whole warp.  (Measured on an H100 at 1280x720: one loop over every
// group with a cylinder branch ran 17% slower than these two loops.)
__device__ __forceinline__ void segment_min_dist(const float* tab,
                                                 const Tables& tb,
                                                 const Seg& s, float& best,
                                                 float& best_opq) {
  best = INFINITY;
  best_opq = INFINITY;
  auto fold = [&](float cand, float opq) {
    best = fminf(best, cand);
    best_opq = fminf(best_opq, opq > 0.5f ? cand : INFINITY);
  };
  const float hl = s.len * tb.cull_half;
  const float mx = s.px + hl * s.sdx;
  const float my = s.py + hl * s.sdy;
  const float mz = s.pz + hl * s.sdz;
  const bool in_scene = tb.n_groups > 0 && reaches(tab, mx, my, mz, hl);
  // The cylinders (the first groups, one row each): inside their bound, or
  // along their axis.
  for (int gi = 0; gi < tb.n_cylinder_groups; ++gi) {
    const float* g = tab + 4 + 8 * gi;
    const float* t = tab + word_int(g, 5) + 4;
    if ((in_scene && reaches(g, mx, my, mz, hl)) || axis_parallel(t, s)) {
      fold(hit_cylinder(t, s), t[kCylinderCols - 1]);
    }
  }
  if (in_scene) {
    for (int gi = tb.n_cylinder_groups; gi < tb.n_groups; ++gi) {
      const float* g = tab + 4 + 8 * gi;
      if (!reaches(g, mx, my, mz, hl)) continue;
      const int type = word_int(g, 4), rows = word_int(g, 6);
      const int stride = word_int(g, 7);
      const float* row = tab + word_int(g, 5);
      for (int j = 0; j < rows; ++j, row += stride) {
        if (rows > 1 && !reaches(row, mx, my, mz, hl)) continue;
        const float* t = row + 4;
        switch (type) {
          case kSphere: fold(hit_sphere(t, s), t[kSphereCols - 1]); break;
          case kDisk: fold(hit_disk(t, s), t[kDiskCols - 1]); break;
          case kHollow: fold(hit_hollow(t, s), t[kHollowCols - 1]); break;
          default: fold(hit_rect(t, s), t[kRectCols - 1]); break;
        }
      }
    }
  }
  const float* t = tab + tb.planes_at;
  for (int i = 0; i < tb.n_planes; ++i, t += kPlaneCols) {
    fold(hit_plane(t, s), t[kPlaneCols - 1]);
  }
}

// Warp tiles.  A warp marches a tile of `rows` x (32 / rows) pixels of the
// H x W image (rays are row-major, W the last axis), a block's warps side
// by side along a row, so the lanes of a warp march neighbouring rays:
// similar lengths and, in the scene kernel, the same cull decisions.  An
// image of fewer rows than a tile (max_rows) takes one row per warp.
__host__ __device__ __forceinline__ int tile_rows(int H, int max_rows) {
  return H >= max_rows ? max_rows : 1;
}

// The blocks of kThreads threads that cover the image.
template <int kThreads>
long long tile_blocks(int H, int W, int max_rows) {
  const int rows = tile_rows(H, max_rows);
  const int span = (kThreads / 32) * (32 / rows);  // columns of a block
  return (long long)((W + span - 1) / span) * ((H + rows - 1) / rows);
}

// The ray this thread marches, or -1 past the image's edge.
template <int kThreads>
__device__ __forceinline__ int tile_ray(int H, int W, int max_rows) {
  const int rows = tile_rows(H, max_rows);
  const int cols = 32 / rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = (kThreads / 32) * cols;  // columns of a block
  const int bx = (W + span - 1) / span;
  const int block = blockIdx.x;
  const int x = (block % bx) * span + warp * cols + lane % cols;
  const int y = (block / bx) * rows + lane / cols;
  return (x < W && y < H) ? y * W + x : -1;
}

// The horizon march's launch design (_ext.DESIGN): threads a block and the
// warp tile's rows (1: 32 pixels of one row).  Measured on an H100 at
// 512x512 (tools/ab_march.py, kernel device time): 4 x 8 tiles 6% faster
// than rows; 256-thread blocks 1% faster than 128 and 3% faster than 64;
// launch bounds that hold ptxas to 40 or 32 registers (12 or 16 blocks an
// SM) spilled and ran 2-8% slower; a persistent grid of resident blocks
// taking tiles from an atomic counter ran 11-17% slower.
constexpr int kBhThreads = BH_THREADS;
constexpr int kBhTileRows = BH_TILE_ROWS;

// The rays are an H x W image (a 1-D batch: H = 1).  kEvents: also write
// t_end and died_moving (as march_scene_kernel).
template <bool kEvents>
__global__ void __launch_bounds__(kBhThreads)
    march_bh_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const unsigned char* __restrict__ active, int H, int W,
                    float* __restrict__ fdir, float* __restrict__ status,
                    float* __restrict__ t_end,
                    unsigned char* __restrict__ died_moving, Params p) {
  const int idx = tile_ray<kBhThreads>(H, W, kBhTileRows);
  if (idx < 0) return;
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
// bookkeeping.  kSharedTables: the block copies the tables into its dynamic
// shared memory first (the wrapper's choice: tables that fit in
// kernel_scene.SHARED_TABLE_WORDS); otherwise every lane reads them from
// device memory through the L1 cache.
template <bool kEvents, bool kSharedTables>
__global__ void __launch_bounds__(kSceneThreads)
    march_scene_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const unsigned char* __restrict__ active, Tables tb,
                       int H, int W, float* __restrict__ fdir,
                       float* __restrict__ fpos, float* __restrict__ status,
                       float* __restrict__ nhits,
                       float* __restrict__ slot_start,
                       float* __restrict__ slot_dir,
                       float* __restrict__ slot_len,
                       float* __restrict__ t_end, float* __restrict__ sstep,
                       int n_slots, Params p) {
  // The block's copy of the tables: every lane of a warp reads a row at
  // one address (a broadcast).
  extern __shared__ float s_tables[];
  const float* tab = tb.data;
  if constexpr (kSharedTables) {
    for (int w = threadIdx.x; w < tb.n_words; w += blockDim.x) {
      s_tables[w] = tb.data[w];
    }
    __syncthreads();
    tab = s_tables;
  }
  const int idx = tile_ray<kSceneThreads>(H, W, kTileRows);
  if (idx < 0) return;
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
    segment_min_dist(tab, tb, Seg{g.px, g.py, g.pz, s.sdx, s.sdy, s.sdz,
                                  s.seg_len},
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

// The adjoint saves the core only at every kCkpt-th step and recomputes the
// steps between.  Measured on an H100 at 1280x720: k = 4 and 8 take the
// same time, k = 16 takes 1.7 times as long; 64-thread blocks run about 9%
// faster than 128-thread ones.
constexpr int kCkpt = BWD_CKPT;
constexpr int kBwdThreads = BWD_THREADS;
// Each thread's kCkpt cores of the interval it is sweeping, laid out
// [step][field][thread]: a warp's accesses to one value fall on 32 banks.
// 30 KB a block: 7 blocks (14 warps) an SM.
constexpr int kBwdSharedBytes =
    kCkpt * march::kCoreFields * kBwdThreads * (int)sizeof(float);
static_assert(kBwdSharedBytes <= 48 * 1024,
              "above 48 KB a block needs cudaFuncSetAttribute");

__global__ void __launch_bounds__(kBwdThreads)
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
                           float* __restrict__ ckpt, Params p) {
  extern __shared__ float s_core[];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const float te = t_end[idx];
  const bool dm = died_moving[idx] != 0;
  // Steps this ray ran forward; later steps are the identity.
  const int last = te < 0.0f ? 0 : min((int)te + 1, p.max_steps);
  const float* o = origin + 3 * idx;
  const float* d = direction + 3 * idx;
  auto moved = [&](int i) { return (float)i < te || ((float)i == te && dm); };

  // Phase 1: replay, saving the core at the start of every kCkpt-th step.
  Geodesic g;
  march::geodesic_init(g, o, d, true);
  for (int i = 0; i < last; ++i) {
    if (i % kCkpt == 0) march::core_store(g, ckpt, i / kCkpt, p.n, idx);
    if (i + 1 < last) march::diff_step(g, i, true, moved(i), p);
  }

  // Phase 2: sweep back from the final outputs' cotangents, one checkpoint
  // segment at a time: replay its steps from the checkpoint into shared
  // memory (diff_step is deterministic, so each replayed core is the one
  // phase 1 computed, bit for bit), then run their VJPs last to first.
  march::CoreCt ct{};
  ct.px = ct_fpos[3 * idx + 0];
  ct.py = ct_fpos[3 * idx + 1];
  ct.pz = ct_fpos[3 * idx + 2];
  ct.dx = ct_fdir[3 * idx + 0];
  ct.dy = ct_fdir[3 * idx + 1];
  ct.dz = ct_fdir[3 * idx + 2];
  float grs = 0.0f;
  for (int s0 = (last - 1) / kCkpt * kCkpt; last > 0 && s0 >= 0;
       s0 -= kCkpt) {
    const int count = min(kCkpt, last - s0);
    march::core_load(g, ckpt, s0 / kCkpt, p.n, idx);
    for (int j = 0; j < count; ++j) {
      march::core_store(g, s_core, j, kBwdThreads, threadIdx.x);
      if (j + 1 < count) march::diff_step(g, s0 + j, true, moved(s0 + j), p);
    }
    for (int j = count - 1; j >= 0; --j) {
      const int i = s0 + j;
      march::core_load(g, s_core, j, kBwdThreads, threadIdx.x);
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
      march::diff_step_vjp(g, i, true, moved(i), p, ct, gs, grs);
    }
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
                    const unsigned char* active, int H, int W, float* fdir,
                    float* status, float* t_end, unsigned char* died_moving,
                    int n, float r_s, int max_steps, float max_angle,
                    float u_f, float far_r2, void* stream) {
  if (H * W != n) return (int)cudaErrorInvalidValue;
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const long long blocks = tile_blocks<kBhThreads>(H, W, kBhTileRows);
  auto kernel =
      t_end != nullptr ? march_bh_kernel<true> : march_bh_kernel<false>;
  kernel<<<(unsigned)blocks, kBhThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, H, W, fdir, status, t_end, died_moving, p);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the current device holds of march_bh_kernel
// (events: its events instantiation), or -1 if CUDA cannot say.
int march_bh_blocks_per_sm(int events) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, events ? march_bh_kernel<true> : march_bh_kernel<false>,
      kBhThreads, 0);
  return err == cudaSuccess ? per_sm : -1;
}

// tables: the table buffer above in device memory, n_words long, copied
// into each block's shared memory where shared_tables is not 0; the rays
// are an H x W image (n = H * W).
int march_scene_launch(const float* origin, const float* direction,
                       const unsigned char* active, const float* tables,
                       int n_words, int shared_tables, int n_groups,
                       int n_cylinder_groups, int planes_at, int n_planes,
                       float cull_half, int H, int W, float* fdir, float* fpos,
                       float* status, float* nhits, float* slot_start,
                       float* slot_dir, float* slot_len, float* t_end,
                       float* sstep, int n_slots, int n, float r_s,
                       int max_steps, float max_angle, float u_f,
                       float far_r2, void* stream) {
  if (H * W != n) return (int)cudaErrorInvalidValue;
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const Tables tb{tables,    n_words,  n_groups, n_cylinder_groups,
                  planes_at, n_planes, cull_half};
  // Above 48 KB of dynamic shared memory the launch fails and says so.
  const size_t shared = shared_tables ? (size_t)n_words * sizeof(float) : 0;
  const long long blocks = tile_blocks<kSceneThreads>(H, W, kTileRows);
  const bool ev = t_end != nullptr;
  auto kernel = shared_tables ? (ev ? march_scene_kernel<true, true>
                                    : march_scene_kernel<false, true>)
                              : (ev ? march_scene_kernel<true, false>
                                    : march_scene_kernel<false, false>);
  kernel<<<(unsigned)blocks, kSceneThreads, shared, (cudaStream_t)stream>>>(
      origin, direction, active, tb, H, W, fdir, fpos, status, nhits,
      slot_start, slot_dir, slot_len, t_end, sstep, n_slots, p);
  return (int)cudaGetLastError();
}

// ckpt: ceil(max_steps / BWD_CKPT) * 15 * n floats of scratch.
int march_scene_bwd_launch(const float* origin, const float* direction,
                           const float* t_end,
                           const unsigned char* died_moving,
                           const float* sstep, const float* ct_fdir,
                           const float* ct_fpos, const float* ct_start,
                           const float* ct_sdir, const float* ct_slen,
                           int n_slots, float* g_origin, float* g_dir,
                           float* g_rs, float* ckpt, int n, float r_s,
                           int max_steps, float max_angle, float u_f,
                           float far_r2, void* stream) {
  const Params p = make_params(n, r_s, max_steps, max_angle, u_f, far_r2);
  const int blocks = (n + kBwdThreads - 1) / kBwdThreads;
  march_scene_bwd_kernel<<<blocks, kBwdThreads, kBwdSharedBytes,
                           (cudaStream_t)stream>>>(
      origin, direction, t_end, died_moving, sstep, ct_fdir, ct_fpos,
      ct_start, ct_sdir, ct_slen, n_slots, g_origin, g_dir, g_rs, ckpt, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
