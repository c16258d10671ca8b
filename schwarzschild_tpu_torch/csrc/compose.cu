// Every composition level of a frame in one launch for Hopper (sm_90a),
// bound through the plain C interface of march.cu (loaded with ctypes by
// _ext.py).
//
// compose_levels_kernel replaces no Pallas kernel: the JAX package composes
// in jnp (schwarzschild_tpu/compose.py, compose_atlas's level_body and its
// level schedule), and the port ran that body as a few hundred PyTorch
// operations a level, each over every lane of the frame (compose.
// _compose_atlas_torch, the kernel's plain version).  The kernel takes one
// lane a thread through every level: level_body(P, k) for level 0 and for
// each later level whose pending() test the lane passes.  A level is the
// re-intersection of the lane's slot k (or its folded far ray, its residual
// far ray, or at the last level the owed sky) against the horizon, the test
// ray's tubes and every table of the scene; the texel request; the merged
// fetch of the texel or the sky from the fetch atlas and the normal map's
// fetch; the lit colour; and the update of colour, open, captured and
// bg_done, which stay in registers until the lane's last level.  A level
// reads and writes only its own lane, so the plain version's schedule
// (later levels on the tiles that hold a pending lane, one read of the
// host after each level that runs) is the same lanes in another order: the
// kernel needs no schedule, no read of the host and no limit on the number
// of slots.
//
// What bounds it on an H100: bytes.  Level 0 reads about 75 bytes of
// planes a lane (slot 0, use_pos/use_dir, the sky's uv, the flags), one or
// two 64-byte atlas quads, and writes 19 bytes; a later level that finds
// nothing pending reads a slot's length on the lanes still open.  Its
// arithmetic, a handful of candidates with a few transcendental functions
// each, is of the same order.  The design keeps every intermediate in
// registers (the plain version writes and reads (H, W, N, 3) candidate
// planes), tests a candidate's validity and distance first and builds the
// fields (point, frame, uv) of the winner alone, and fetches only what a
// lane uses.
//
// Every value is computed as the plain version's PyTorch operations
// compute it on the card, operation for operation (see march_common.cuh):
// -fmad=false, three-term sums left to right, IEEE division and sqrtf,
// atan2f/asinf/sinf/cosf/powf, torch's clamp, remainder and floor, and
// the guards of intersect.py; so a lane equals the plain version's bit for
// bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(COMPOSE_THREADS)
#error "build through schwarzschild_tpu_torch/_ext.py: it defines the design"
#endif

namespace {

// One lane a thread, kThreads consecutive lanes of the frame a block.
constexpr int kThreads = COMPOSE_THREADS;

// Object type codes (scene.py).
constexpr int kTypeCurved = -99, kTypeFlat = -98, kTypeSpecial = -42;
constexpr int kSphere = 0, kPlane = 1, kDisk = 2, kHollow = 3, kCylinder = 4,
              kRect = 5, kBox = 6;

// Row widths of the word buffer (compose._TABLE_WIDTHS): a row's position,
// then its axes row-major (axes[i][j] at 3 i + j), then its sizes, then its
// material index as an int32 bit pattern.
constexpr int kSphereW = 14;  // pos, axes, radius, mat
constexpr int kPlaneW = 18;   // pos, axes, tex offset, tex size, repeat, mat
constexpr int kDiskW = 14;    // pos, axes, radius, mat
constexpr int kHollowW = 15;  // pos, axes, inner, outer, mat
constexpr int kCylW = 15;     // pos, axes, height, radius, mat
constexpr int kRectW = 15;    // pos, axes, width, height, mat
constexpr int kBoxW = 85;     // 6 face pos, 6 face axes, widths, heights, mat
constexpr int kTubeW = 15;    // pos, axes, height, radius, active
constexpr int kMatW = 15;     // color, ambient, diffuse, specular, shininess,
                              // texture, normal map, invert x/y, swap,
                              // double-sided, flip
constexpr int kLightW = 10;   // pos, color, intensity, attenuation c, l, q
constexpr int kLayerW = 4;    // wrap w, wrap h, base, gpr

constexpr float kInf = INFINITY;
constexpr float kEps = 1e-7f;       // geometry.EPSILON
constexpr float kTiny = 1e-20f;     // intersect._TINY
constexpr float kLenEps = 1e-24f;   // geometry.safe_length's eps
constexpr float kDivGuard = 1e-12f; // intersect._DIV_GUARD
// Python floats as torch rounds them to float32.
constexpr float kPi = (float)3.14159265358979323846;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kPoleSq = (float)(1e-12 * 1e-12);
constexpr float kAsinLo = (float)(-1.0 + 1e-7);
constexpr float kAsinHi = (float)(1.0 - 1e-7);

// The tables: offsets (in words) into one device word buffer and row
// counts, in the order compose._pack_tables lists them.
struct Tables {
  const float* w;
  int spheres, n_spheres, planes, n_planes, disks, n_disks, hollow, n_hollow,
      cyl, n_cyl, rects, n_rects, boxes, n_boxes, box_uv;
  int mats, n_mats, lights, n_lights, tex_sizes, n_tex, max_size, layers,
      n_layers;
  const float* tubes;  // the test ray's rows, kTubeW words each
  int n_tubes;
  const float* r_s;    // the horizon radius, on the device
};
constexpr int kTableInts = 24;

// The lanes' planes; flags are bytes (torch.bool), n_rec int32.
struct Lanes {
  float* color;                // (n, 4)
  unsigned char* open;
  unsigned char* captured;
  unsigned char* bg_done;
  const unsigned char* open_init;  // read at level 0 in place of open
  const unsigned char* needs_far;
  const unsigned char* bg_hard;
  const unsigned char* cap_drop;   // soft horizon only
  const int* n_rec;
  const float* bg_scale;
  const float* use_pos;            // (n, 3)
  const float* use_dir;
  const float* bgu;
  const float* bgv;
  // A device array of the slots' planes: n_slots starts ((n, 3) each),
  // then their directions, then their lengths ((n,) each).
  const float* const* slots;
  int n_slots;
  __device__ const float* start(int k) const { return slots[k]; }
  __device__ const float* dir(int k) const { return slots[n_slots + k]; }
  __device__ const float* len(int k) const { return slots[2 * n_slots + k]; }
};
constexpr int kLanePtrs = 14;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}
// Column j of a row-major 3 x 3 frame.
__device__ __forceinline__ V3 col(const float* m, int j) {
  return {m[j], m[3 + j], m[6 + j]};
}
// geometry.mat_tvec: axes^T v (column j dotted with v, rows in order).
__device__ __forceinline__ V3 mat_tvec(const float* m, V3 v) {
  return {m[0] * v.x + m[3] * v.y + m[6] * v.z,
          m[1] * v.x + m[4] * v.y + m[7] * v.z,
          m[2] * v.x + m[5] * v.y + m[8] * v.z};
}
// geometry.mat_vec: axes v.
__device__ __forceinline__ V3 mat_vec(const float* m, V3 v) {
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
          m[3] * v.x + m[4] * v.y + m[5] * v.z,
          m[6] * v.x + m[7] * v.y + m[8] * v.z};
}

// torch.clamp_min: NaN stays NaN.
__device__ __forceinline__ float cmin(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float safe_len(V3 v) {  // geometry.safe_length
  return sqrtf(cmin(dot(v, v), kLenEps));
}
// geometry.safe_normalize: v * (1 / sqrt(max(v.v, eps))).
__device__ __forceinline__ V3 safe_normalize(V3 v, float eps) {
  return mul(v, 1.0f / sqrtf(cmin(dot(v, v), eps)));
}
// intersect._safe_div: b guarded away from 0, sign-preserving.
__device__ __forceinline__ float safe_div(float a, float b) {
  const float g = fabsf(b) < kDivGuard ? (b < 0.0f ? -kDivGuard : kDivGuard)
                                       : b;
  return a / g;
}
__device__ __forceinline__ float safe_asin(float x) {  // torch.clamp, asin
  return asinf(x != x ? x : fminf(fmaxf(x, kAsinLo), kAsinHi));
}
__device__ __forceinline__ float min_positive(float a, float b) {
  if (a > 0.0f && b > 0.0f) return fminf(a, b);
  if (a > 0.0f) return a;
  if (b > 0.0f) return b;
  return -1.0f;
}
__device__ __forceinline__ bool within(float lam, float ml) {
  return lam >= 0.0f && (ml < 0.0f || lam <= ml);
}
// intersect._phi_of: atan2(x, z) wrapped to [0, 2 pi).
__device__ __forceinline__ float phi_of(float x, float z) {
  const bool degenerate = x * x + z * z < kPoleSq;
  const float phi = atan2f(degenerate ? 0.0f : x, degenerate ? 1.0f : z);
  return phi < 0.0f ? phi + kTwoPi : phi;
}
__device__ __forceinline__ int word_int(const float* t, int i) {
  return __float_as_int(t[i]);
}
// torch.remainder of floats (fmod, moved to the divisor's sign).
__device__ __forceinline__ float fremainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}
// torch.remainder of int64.
__device__ __forceinline__ long long iremainder(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// The ray a level re-intersects: origin, direction, window (< 0 unbounded).
struct Ray {
  V3 o, d;
  float ml;
};

// Each candidate's test: whether it is hit within the window, its lambda
// and its point, with the plain version's operations.
__device__ __forceinline__ bool sphere_test(const Ray& r, V3 pos, float rad,
                                            float& lam, V3& point) {
  const V3 oc = sub(r.o, pos);
  const float d_oc = dot(r.d, oc);
  const float disc = d_oc * d_oc - dot(oc, oc) + rad * rad;
  const float sq = sqrtf(cmin(disc, kTiny));
  lam = min_positive(-d_oc - sq, -d_oc + sq);
  point = add(r.o, mul(r.d, lam));
  return disc >= 0.0f && within(lam, r.ml);
}

__device__ __forceinline__ bool plane_test(const Ray& r, V3 pos,
                                           const float* ax, float& lam,
                                           V3& point) {
  const V3 n = col(ax, 1);
  const float denom = dot(n, r.d);
  lam = safe_div(dot(n, sub(pos, r.o)), denom);
  point = add(r.o, mul(r.d, lam));
  return fabsf(denom) >= kEps && within(lam, r.ml);
}

__device__ __forceinline__ bool in_height(V3 p, V3 pos, V3 axis, float h) {
  const float t = dot(sub(p, pos), axis);
  return t >= 0.0f && t <= h;
}

__device__ __forceinline__ bool cylinder_test(const Ray& r, V3 pos,
                                              const float* ax, float height,
                                              float rad, float& lam,
                                              V3& point) {
  const V3 axis = col(ax, 1);
  const V3 lo = mat_tvec(ax, sub(r.o, pos));
  const V3 ld = mat_tvec(ax, r.d);
  const float a = lo.x * ld.x + lo.z * ld.z;
  const float dps = ld.x * ld.x + ld.z * ld.z;
  const float ops = lo.x * lo.x + lo.z * lo.z;
  const float disc = a * a + dps * (rad * rad - ops);
  const float sq = sqrtf(cmin(disc, kTiny));
  const float lam1 = safe_div(-(a + sq), dps);
  const float lam2 = safe_div(-(a - sq), dps);
  const bool in1 = in_height(add(r.o, mul(r.d, lam1)), pos, axis, height);
  const bool in2 = in_height(add(r.o, mul(r.d, lam2)), pos, axis, height);
  lam = (in1 && in2) ? min_positive(lam1, lam2)
                     : (in1 ? lam1 : (in2 ? lam2 : -1.0f));
  point = add(r.o, mul(r.d, lam));
  return disc >= 0.0f && (in1 || in2) && within(lam, r.ml);
}

__device__ __forceinline__ bool rect_test(const Ray& r, V3 pos,
                                          const float* ax, float width,
                                          float height, float& lam,
                                          V3& point) {
  bool ok = plane_test(r, pos, ax, lam, point);
  const V3 disp = sub(point, pos);
  const float alpha = dot(disp, col(ax, 0));
  const float beta = dot(disp, col(ax, 2));
  return ok && alpha >= 0.0f && alpha <= width && beta >= 0.0f &&
         beta <= height;
}

// The closest candidate: its type, row and (box) face; ties keep the
// earlier candidate (intersect._merge_hits).
struct Best {
  float dist;
  bool valid;
  int type, row, face;
};

__device__ __forceinline__ void consider(Best& b, bool valid, V3 point,
                                         const Ray& r, int type, int row,
                                         int face) {
  const float dist = valid ? safe_len(sub(point, r.o)) : kInf;
  if (dist < b.dist) b = {dist, valid, type, row, face};
}

// A box's closest face (intersect.box_candidates): face f's valid, lambda
// and point.
__device__ __forceinline__ int box_face(const Ray& r, const float* t,
                                        bool& valid, float& lam, V3& point) {
  int face = 0;
  float best = kInf;
  valid = false;
  for (int f = 0; f < 6; ++f) {
    float l;
    V3 p;
    const bool ok = rect_test(r, load3(t + 3 * f), t + 18 + 9 * f, t[72 + f],
                              t[78 + f], l, p);
    const float dist = ok ? safe_len(sub(p, r.o)) : kInf;
    if (f == 0 || dist < best) {
      best = dist;
      face = f;
      valid = ok;
      lam = l;
      point = p;
    }
  }
  return face;
}

// The closest hit over the horizon, the test ray's tubes and the scene,
// in intersect_scene's candidate order.
__device__ Best closest(const Ray& r, const Tables& tb) {
  const float* w = tb.w;
  float lam;
  V3 p;
  const V3 zero = {0.0f, 0.0f, 0.0f};
  Best b;
  {
    const bool ok = sphere_test(r, zero, *tb.r_s, lam, p);
    b = {ok ? safe_len(sub(p, r.o)) : kInf, ok, kTypeSpecial, 0, 0};
  }
  for (int i = 0; i < tb.n_tubes; ++i) {
    const float* t = tb.tubes + i * kTubeW;
    const bool ok = cylinder_test(r, load3(t), t + 3, t[12], t[13], lam, p);
    consider(b, ok && t[14] > 0.5f, p, r, i == 0 ? kTypeFlat : kTypeCurved, i,
             0);
  }
  for (int i = 0; i < tb.n_spheres; ++i) {
    const float* t = w + tb.spheres + i * kSphereW;
    consider(b, sphere_test(r, load3(t), t[12], lam, p), p, r, kSphere, i, 0);
  }
  for (int i = 0; i < tb.n_planes; ++i) {
    const float* t = w + tb.planes + i * kPlaneW;
    consider(b, plane_test(r, load3(t), t + 3, lam, p), p, r, kPlane, i, 0);
  }
  for (int i = 0; i < tb.n_disks; ++i) {
    const float* t = w + tb.disks + i * kDiskW;
    const V3 pos = load3(t);
    bool ok = plane_test(r, pos, t + 3, lam, p);
    const V3 e = sub(p, pos);
    ok = ok && dot(e, e) <= t[12] * t[12];
    consider(b, ok, p, r, kDisk, i, 0);
  }
  for (int i = 0; i < tb.n_hollow; ++i) {
    const float* t = w + tb.hollow + i * kHollowW;
    const V3 pos = load3(t);
    bool ok = plane_test(r, pos, t + 3, lam, p);
    const V3 e = sub(p, pos);
    const float sq = dot(e, e);
    ok = ok && sq >= t[12] * t[12] && sq <= t[13] * t[13];
    consider(b, ok, p, r, kHollow, i, 0);
  }
  for (int i = 0; i < tb.n_cyl; ++i) {
    const float* t = w + tb.cyl + i * kCylW;
    consider(b, cylinder_test(r, load3(t), t + 3, t[12], t[13], lam, p), p, r,
             kCylinder, i, 0);
  }
  for (int i = 0; i < tb.n_rects; ++i) {
    const float* t = w + tb.rects + i * kRectW;
    consider(b, rect_test(r, load3(t), t + 3, t[12], t[13], lam, p), p, r,
             kRect, i, 0);
  }
  for (int i = 0; i < tb.n_boxes; ++i) {
    bool ok;
    const int f = box_face(r, w + tb.boxes + i * kBoxW, ok, lam, p);
    consider(b, ok, p, r, kBox, i, f);
  }
  return b;
}

// The winner's fields that shading reads (intersect's candidate fields).
struct Hit {
  V3 point, tangent, bitangent, normal;
  float u, v;
  float off_u, off_v, size_u, size_v;  // a plane's texture window
  bool repeat;
};

// The winner's material index (the last word of its row).
__device__ __forceinline__ int mat_of(const Tables& tb, const Best& b) {
  switch (b.type) {
    case kSphere: return word_int(tb.w + tb.spheres + b.row * kSphereW, 13);
    case kPlane: return word_int(tb.w + tb.planes + b.row * kPlaneW, 17);
    case kDisk: return word_int(tb.w + tb.disks + b.row * kDiskW, 13);
    case kHollow: return word_int(tb.w + tb.hollow + b.row * kHollowW, 14);
    case kCylinder: return word_int(tb.w + tb.cyl + b.row * kCylW, 14);
    case kRect: return word_int(tb.w + tb.rects + b.row * kRectW, 14);
    default: return word_int(tb.w + tb.boxes + b.row * kBoxW, 84);
  }
}

// The local tangent (cos phi, 0, -sin phi) of intersect._local_tangent.
__device__ __forceinline__ V3 local_tangent(float cp, float sp) {
  return {cp, 0.0f, -sp};
}

// The fields of a regular (type >= 0) winner; ``frame``: also tangent and
// bitangent (read only by a normal map).
__device__ Hit hit_fields(const Ray& r, const Tables& tb, const Best& b,
                          bool frame) {
  const float* w = tb.w;
  Hit h;
  h.off_u = 0.0f;
  h.off_v = 0.0f;
  h.size_u = 1.0f;
  h.size_v = 1.0f;
  h.repeat = true;
  h.tangent = h.bitangent = {0.0f, 0.0f, 0.0f};
  float lam;
  switch (b.type) {
    case kSphere: {
      const float* t = w + tb.spheres + b.row * kSphereW;
      const V3 pos = load3(t);
      const float* ax = t + 3;
      const float rad = t[12];
      sphere_test(r, pos, rad, lam, h.point);
      const V3 disp = sub(h.point, pos);
      h.normal = safe_normalize(disp, kTiny);
      const V3 local = mat_tvec(ax, disp);
      const float phi = phi_of(local.x, local.z);
      const float theta = safe_asin(safe_div(local.y, rad));
      h.u = phi / kTwoPi;
      h.v = theta / kPi + 0.5f;
      if (frame) {
        const float cp = cosf(phi), sp = sinf(phi);
        const float ct = cosf(theta), st = sinf(theta);
        h.tangent = mat_vec(ax, local_tangent(cp, sp));
        h.bitangent = mat_vec(ax, {sp * ct, st, cp * ct});
      }
      break;
    }
    case kPlane: {
      const float* t = w + tb.planes + b.row * kPlaneW;
      const V3 pos = load3(t);
      const float* ax = t + 3;
      plane_test(r, pos, ax, lam, h.point);
      const V3 local = mat_tvec(ax, sub(h.point, pos));
      h.u = local.x;
      h.v = 1.0f - local.z;
      h.tangent = col(ax, 0);
      h.bitangent = neg(col(ax, 2));
      h.normal = col(ax, 1);
      h.off_u = t[12];
      h.off_v = t[13];
      h.size_u = t[14];
      h.size_v = t[15];
      h.repeat = t[16] > 0.5f;
      break;
    }
    case kDisk:
    case kHollow: {
      const bool disk = b.type == kDisk;
      const float* t = disk ? w + tb.disks + b.row * kDiskW
                            : w + tb.hollow + b.row * kHollowW;
      const V3 pos = load3(t);
      const float* ax = t + 3;
      plane_test(r, pos, ax, lam, h.point);
      const V3 disp = sub(h.point, pos);
      const V3 local = mat_tvec(ax, disp);
      const float phi = phi_of(local.x, local.z);
      const float r_local = safe_len(local);
      h.tangent = safe_normalize(disp, kTiny);
      if (frame) h.bitangent = mat_vec(ax, local_tangent(cosf(phi), sinf(phi)));
      h.normal = col(ax, 1);
      h.u = disk ? safe_div(r_local, t[12])
                 : safe_div(r_local - t[12], t[13] - t[12]);
      h.v = phi / kTwoPi;
      break;
    }
    case kCylinder: {
      const float* t = w + tb.cyl + b.row * kCylW;
      const V3 pos = load3(t);
      const float* ax = t + 3;
      cylinder_test(r, pos, ax, t[12], t[13], lam, h.point);
      const V3 disp = sub(h.point, pos);
      h.normal = safe_normalize(disp, kTiny);
      h.bitangent = col(ax, 1);
      const V3 local = mat_tvec(ax, disp);
      const float phi = phi_of(local.x, local.z);
      h.u = phi / kTwoPi;
      h.v = safe_div(local.y, t[12]);
      if (frame) h.tangent = mat_vec(ax, local_tangent(cosf(phi), sinf(phi)));
      break;
    }
    default: {  // kRect, kBox: a rectangle (a box's winning face)
      const bool box = b.type == kBox;
      const float* t = box ? w + tb.boxes + b.row * kBoxW
                           : w + tb.rects + b.row * kRectW;
      const int f = b.face;
      const V3 pos = box ? load3(t + 3 * f) : load3(t);
      const float* ax = box ? t + 18 + 9 * f : t + 3;
      const float width = box ? t[72 + f] : t[12];
      const float height = box ? t[78 + f] : t[13];
      rect_test(r, pos, ax, width, height, lam, h.point);
      const V3 local = mat_tvec(ax, sub(h.point, pos));
      h.u = safe_div(local.x, width);
      h.v = 1.0f - safe_div(local.z, height);
      if (box) {
        const float* off = w + tb.box_uv + 2 * f;
        h.u = (h.u + off[0]) / 4.0f;
        h.v = (h.v + off[1]) / 3.0f;
      }
      h.tangent = col(ax, 0);
      h.bitangent = neg(col(ax, 2));
      h.normal = col(ax, 1);
      break;
    }
  }
  return h;
}

// textures._fetch_parts and the bilinear lerps: one 64-byte quad (32 with
// bfloat16 texels, widened to float32) of atlas layer ``layer`` at (u, v).
template <bool kBf16>
__device__ float4 atlas_fetch(const Tables& tb, const void* atlas, int layer,
                              float u, float v) {
  layer = min(max(layer, 0), tb.n_layers - 1);
  const float* lt = tb.w + tb.layers + layer * kLayerW;
  const float w = lt[0], h = lt[1];
  const long long base = word_int(lt, 2), gpr = word_int(lt, 3);
  const float x = u * w - 0.5f;
  const float y = v * h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long x0i = iremainder((long long)x0, (long long)w);
  const long long y0i = iremainder((long long)y0, (long long)h);
  const long long quad = (base + y0i * gpr + (x0i >> 3)) * 8 + (x0i & 7);
  float c[16];
  if constexpr (kBf16) {
    const uint4* q = reinterpret_cast<const uint4*>(
        static_cast<const unsigned short*>(atlas) + quad * 16);
    const uint4 a = q[0], b = q[1];
    const unsigned words[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[2 * i] = __uint_as_float(words[i] << 16);
      c[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else {
    const float4* q =
        reinterpret_cast<const float4*>(static_cast<const float*>(atlas)) +
        quad * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = q[i];
      c[4 * i] = f.x;
      c[4 * i + 1] = f.y;
      c[4 * i + 2] = f.z;
      c[4 * i + 3] = f.w;
    }
  }
  float out[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const float c00 = c[ch], c10 = c[4 + ch], c01 = c[8 + ch],
                c11 = c[12 + ch];
    const float top = c00 + fx * (c10 - c00);
    const float bot = c01 + fx * (c11 - c01);
    out[ch] = top + fy * (bot - top);
  }
  return make_float4(out[0], out[1], out[2], out[3]);
}


// Material rows (kMatW words): color 0-3, ambient 4, diffuse 5, specular 6,
// shininess 7, texture index 8, normal-map index 9 (int32 bit patterns),
// invert_uv_x 10, invert_uv_y 11, swap_uvs 12, double-sided 13, flip 14.
__device__ __forceinline__ bool flag(const float* m, int i) {
  return m[i] > 0.5f;
}

// shading.texel_request for a regular hit: the sample uv, the stack
// index, whether the texel is used, and the post-swap/invert uv (the
// normal map's input).
struct Req {
  float u, v, uvx, uvy;
  int index;
  bool use_tex;
};

__device__ Req texel_request(const Hit& h, bool is_plane, const float* m,
                             const Tables& tb) {
  Req q;
  q.index = word_int(m, 8);
  float ux = h.u, uy = h.v;
  if (flag(m, 12)) {  // swap_uvs
    ux = h.v;
    uy = h.u;
  }
  const float ext_u = is_plane ? h.size_u : 1.0f;
  const float ext_v = is_plane ? h.size_v : 1.0f;
  q.uvx = flag(m, 10) ? ext_u - ux : ux;
  q.uvy = flag(m, 11) ? ext_v - uy : uy;
  const float* ts =
      tb.w + tb.tex_sizes + 2 * min(max(q.index, 0), tb.n_tex - 1);
  const float* mx = tb.w + tb.max_size;
  const float rx = q.uvx * ts[0] / mx[0];
  const float ry = q.uvy * ts[1] / mx[1];
  bool render = true;
  if (is_plane) {  // the plane's tiling window (frag:387-400)
    const float sx = rx - h.off_u, sy = ry - h.off_v;
    const float zx = cmin(h.size_u, 1e-12f), zy = cmin(h.size_v, 1e-12f);
    const float wx = sx / zx, wy = sy / zy;
    render = h.repeat || (wx >= 0.0f && wx <= 1.0f && wy >= 0.0f &&
                          wy <= 1.0f);
    q.u = fremainder(sx, h.size_u) / zx;
    q.v = fremainder(sy, h.size_v) / zy;
  } else {
    q.u = rx;
    q.v = ry;
  }
  q.use_tex = q.index >= 0 && render;
  return q;
}

// shading._shade_lit for a regular hit: flip and cull, the normal map
// where ``nm_on`` (``nm`` its raw rgb), ambient and per-light Phong.
__device__ float4 shade_lit(const Hit& h, V3 view, const float* m,
                            const Tables& tb, float4 base, bool nm_on,
                            float4 nm) {
  const float ambient = m[4], dk = m[5], sk = m[6], shin = m[7];
  V3 normal = flag(m, 14) ? neg(h.normal) : h.normal;
  const bool culled = !flag(m, 13) && dot(normal, view) < 0.0f;
  if (nm_on) {
    normal = safe_normalize(add(add(mul(h.tangent, nm.x),
                                    mul(h.bitangent, nm.y)),
                                mul(normal, nm.z)),
                            kLenEps);
  }
  float rgb[3] = {ambient * base.x, ambient * base.y, ambient * base.z};
  const float bc[3] = {base.x, base.y, base.z};
  for (int i = 0; i < tb.n_lights; ++i) {
    const float* lt = tb.w + tb.lights + i * kLightW;
    const V3 to_light = sub(load3(lt), h.point);
    const float distance = safe_len(to_light);
    const V3 ld = {to_light.x / distance, to_light.y / distance,
                   to_light.z / distance};
    const float att =
        1.0f / (lt[7] + lt[8] * distance + lt[9] * distance * distance);
    const float diff = cmin(dot(normal, ld), 0.0f);
    const V3 inc = neg(ld);
    const V3 refl = sub(inc, mul(normal, 2.0f * dot(normal, inc)));
    const float sdot = cmin(dot(view, refl), 0.0f);
    const float spec = sdot > 0.0f ? powf(cmin(sdot, 1e-30f), shin) : 0.0f;
    const float ai = att * lt[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diffuse = dk * diff * lt[3 + c] * bc[c];
      const float specular = sk * spec * lt[3 + c];
      rgb[c] = rgb[c] + (diffuse + specular) * ai;
    }
  }
  if (culled) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(rgb[0], rgb[1], rgb[2], base.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// A lane's state between levels, kept in registers.
struct State {
  float4 c;
  bool open, captured, bg_done;
};

// What a lane's levels read of it besides its state.
struct Lane {
  size_t i;
  bool bg_hard, needs_far, cap_drop;
  int n_rec, last;
};

// compose pending(): whether level k changes the lane (a level leaves every
// other lane as it is).
__device__ __forceinline__ bool pending(const Lanes& p, const Lane& l,
                                        const State& s, int k, int n_slots,
                                        bool soft) {
  bool pend = s.open && l.bg_hard && !s.bg_done && l.last <= k;
  if (k > n_slots) {
    if (soft)
      pend = pend || ((s.captured || (l.cap_drop && s.open)) && !s.bg_done);
  } else if (s.open && !pend) {
    pend = k < n_slots ? (p.len(k)[l.i] > 0.0f ||
                          (l.needs_far && l.n_rec == k))
                       : (l.needs_far && l.n_rec >= n_slots);
  }
  return pend;
}

// Level k of one lane (compose level_body) on its state.
template <bool kBf16>
__device__ void level_lane(const Lanes& p, const Tables& tb,
                           const void* atlas, const Lane& l, State& s, int k,
                           int n_slots, bool soft) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const size_t i = l.i;
  const float scale = p.bg_scale[i];
  if (k > n_slots) {
    // Cleanup: the sky for every lane still owed one.
    bool want = s.open && l.bg_hard && !s.bg_done;
    if (soft)
      want = want || ((s.captured || (l.cap_drop && s.open)) && !s.bg_done);
    const float4 bg =
        want ? atlas_fetch<kBf16>(tb, atlas, 0, p.bgu[i], p.bgv[i]) : zero;
    s.c = add4(s.c, want ? scale4(bg, scale) : zero);
    s.bg_done = s.bg_done || want;
    return;
  }
  const bool rec = k < n_slots && p.len(k)[i] > 0.0f;
  const bool fold =
      l.needs_far && (k < n_slots ? l.n_rec == k : l.n_rec >= n_slots);
  bool texel_want = false, opaque_take = false, captured_new = false;
  float4 rgba = zero;  // zero unless the lane takes a hit
  if ((rec || fold) && s.open) {
    // Folded lanes shoot the unbounded far ray; a recorded window is
    // inflated as the plain version inflates it.
    Ray r;
    if (fold) {
      r = {load3(p.use_pos + 3 * i), load3(p.use_dir + 3 * i), -1.0f};
    } else {
      r = {load3(p.start(k) + 3 * i), load3(p.dir(k) + 3 * i),
           p.len(k)[i] * 1.0001f + 1e-5f};
    }
    const Best b = closest(r, tb);
    if (b.valid && b.type == kTypeSpecial) {
      rgba = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    } else if (b.valid && b.type == kTypeCurved) {
      rgba = make_float4(1.0f, 0.0f, 0.0f, 1.0f);
    } else if (b.valid && b.type == kTypeFlat) {
      rgba = make_float4(0.0f, 1.0f, 0.0f, 1.0f);
    } else if (b.valid) {
      const int mi = min(max(mat_of(tb, b), 0), tb.n_mats - 1);
      const float* m = tb.w + tb.mats + mi * kMatW;
      const bool have_stack = tb.n_tex > 0;
      const int nmi = word_int(m, 9);
      const bool nm_on = have_stack && nmi >= 0;
      const Hit h = hit_fields(r, tb, b, nm_on);
      float4 base = make_float4(m[0], m[1], m[2], m[3]);
      float4 nm = zero;
      if (have_stack) {
        const Req q = texel_request(h, b.type == kPlane, m, tb);
        texel_want = q.use_tex;
        if (texel_want)
          base = atlas_fetch<kBf16>(tb, atlas, q.index + 1, q.u, q.v);
        if (nm_on) {
          const float* ns = tb.w + tb.tex_sizes + 2 * min(nmi, tb.n_tex - 1);
          const float* mx = tb.w + tb.max_size;
          nm = atlas_fetch<kBf16>(tb, atlas, nmi + 1, q.uvx * ns[0] / mx[0],
                                  q.uvy * ns[1] / mx[1]);
        }
      }
      rgba = shade_lit(h, neg(r.d), m, tb, base, nm_on, nm);
    }
    opaque_take = b.valid && rgba.w == 1.0f;
    captured_new = opaque_take && b.type == kTypeSpecial;
  }
  s.c = add4(s.c, rgba);
  s.open = s.open && !opaque_take;
  // Lanes whose contributions end here and whose fetch was the sky consume
  // it now; a fresh capture with a soft horizon is black plus scaled sky.
  bool bg_now = s.open && l.last <= k && l.bg_hard && !s.bg_done &&
                !texel_want;
  if (soft) bg_now = bg_now || (captured_new && !texel_want && !s.bg_done);
  const float4 bg =
      bg_now ? atlas_fetch<kBf16>(tb, atlas, 0, p.bgu[i], p.bgv[i]) : zero;
  s.c = add4(s.c, bg_now ? scale4(bg, scale) : zero);
  s.captured = s.captured || captured_new;
  s.bg_done = s.bg_done || bg_now;
}

// Every level of a lane a thread: level 0, then each later level that
// finds the lane pending, in order.  A level reads and writes only its
// lane, so this is the plain version's schedule (level 0 on the whole
// frame, each later level on the tiles or the frame that hold a pending
// lane, where it leaves the lanes that are not pending as they are) lane
// by lane.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    compose_levels_kernel(Lanes p, Tables tb, const void* __restrict__ atlas,
                          long long n, int n_slots, int n_levels, int soft) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const size_t i = (size_t)lane;
  Lane l;
  l.i = i;
  l.bg_hard = p.bg_hard[i] != 0;
  l.needs_far = p.needs_far[i] != 0;
  l.cap_drop = soft && p.cap_drop[i] != 0;
  l.n_rec = p.n_rec[i];
  l.last = l.needs_far ? min(l.n_rec, n_slots) : l.n_rec - 1;
  State s{make_float4(0.0f, 0.0f, 0.0f, 0.0f), p.open_init[i] != 0, false,
          false};
#pragma unroll 1
  for (int k = 0; k < n_levels; ++k) {
    if (k == 0 || pending(p, l, s, k, n_slots, soft != 0))
      level_lane<kBf16>(p, tb, atlas, l, s, k, n_slots, soft != 0);
  }
  reinterpret_cast<float4*>(p.color)[i] = s.c;
  p.open[i] = s.open;
  p.captured[i] = s.captured;
  p.bg_done[i] = s.bg_done;
}

}  // namespace

extern "C" {

// lanes: kLanePtrs plane pointers in Lanes' order; slots: a device array of
// the n_slots slot starts, then their directions, then their lengths; offs:
// Tables' kTableInts offsets and counts in order.  Runs levels 0 ..
// n_levels - 1 (at most n_slots + 2).  Enqueues one kernel on ``stream``
// and returns cudaGetLastError().
int compose_levels_launch(void* const* lanes, const float* const* slots,
                          int n_slots, int n_levels, const float* words,
                          const int* offs, const float* tubes, int n_tubes,
                          const float* r_s, const void* atlas, int atlas_bf16,
                          long long n, int soft, void* stream) {
  if (n_slots < 0 || n_levels < 1 || n_levels > n_slots + 2 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Lanes p{};
  p.color = static_cast<float*>(lanes[0]);
  p.open = static_cast<unsigned char*>(lanes[1]);
  p.captured = static_cast<unsigned char*>(lanes[2]);
  p.bg_done = static_cast<unsigned char*>(lanes[3]);
  p.open_init = static_cast<const unsigned char*>(lanes[4]);
  p.needs_far = static_cast<const unsigned char*>(lanes[5]);
  p.bg_hard = static_cast<const unsigned char*>(lanes[6]);
  p.cap_drop = static_cast<const unsigned char*>(lanes[7]);
  p.n_rec = static_cast<const int*>(lanes[8]);
  p.bg_scale = static_cast<const float*>(lanes[9]);
  p.use_pos = static_cast<const float*>(lanes[10]);
  p.use_dir = static_cast<const float*>(lanes[11]);
  p.bgu = static_cast<const float*>(lanes[12]);
  p.bgv = static_cast<const float*>(lanes[13]);
  p.slots = slots;
  p.n_slots = n_slots;
  Tables tb;
  tb.w = words;
  int* f[kTableInts] = {&tb.spheres, &tb.n_spheres, &tb.planes, &tb.n_planes,
                        &tb.disks,   &tb.n_disks,   &tb.hollow, &tb.n_hollow,
                        &tb.cyl,     &tb.n_cyl,     &tb.rects,  &tb.n_rects,
                        &tb.boxes,   &tb.n_boxes,   &tb.box_uv, &tb.mats,
                        &tb.n_mats,  &tb.lights,    &tb.n_lights,
                        &tb.tex_sizes, &tb.n_tex,   &tb.max_size,
                        &tb.layers,  &tb.n_layers};
  for (int j = 0; j < kTableInts; ++j) *f[j] = offs[j];
  tb.tubes = tubes;
  tb.n_tubes = n_tubes;
  tb.r_s = r_s;
  auto kernel = atlas_bf16 ? compose_levels_kernel<true>
                           : compose_levels_kernel<false>;
  const long long blocks = (n + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, tb, atlas, n, n_slots, n_levels, soft);
  return (int)cudaGetLastError();
}

}  // extern "C"
