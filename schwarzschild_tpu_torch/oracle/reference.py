"""NumPy float64 oracle: a line-faithful transcription of the reference's
fragment shader (assets/shaders/black_hole.frag) with real control flow
(counterpart of ``schwarzschild_tpu.oracle.reference``, of which it is a
copy: nothing here imports the JAX package).

This module mirrors the GLSL structure (per-pixel functions, early
returns, if/else branches) instead of the renderers' vectorized masked
style.  It shares only the scene and texture data with them; their
disagreement is how faults are caught, and its float64 precision defines
the target of the float32 renderers.  It is slow (about 100x slower than
``native.py``'s C++ twin) and, unlike that twin, draws the debug test ray.

Every function cites the frag lines it transcribes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

PI = math.pi
EPSILON = 1e-7  # frag:30

OBJECT_TYPE_TEST_RAY_CURVED = -99
OBJECT_TYPE_TEST_RAY_FLAT = -98
OBJECT_TYPE_SPECIAL = -42
OBJECT_TYPE_SPHERE = 0
OBJECT_TYPE_PLANE = 1
OBJECT_TYPE_DISK = 2
OBJECT_TYPE_HOLLOW_DISK = 3
OBJECT_TYPE_CYLINDER = 4
OBJECT_TYPE_RECTANGLE = 5
OBJECT_TYPE_BOX = 6

CURVED, FLAT, HALF_WIDTH, HALF_HEIGHT = 0, 1, 2, 3

TEST_RAY_CURVED_COLOR = np.array([1.0, 0.0, 0.0, 1.0])
TEST_RAY_FLAT_COLOR = np.array([0.0, 1.0, 0.0, 1.0])

CROSSHAIR_LENGTH = 10.0
CROSSHAIR_WIDTH = 2.0
CROSSHAIR_SPACE = 5.0
CROSSHAIR_COLOR = np.array([0.5, 0.5, 0.5, 0.5])


def _host(x):
    """A tensor (on any device) or an array as numpy."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _np(x):
    return np.asarray(_host(x), np.float64)


@dataclass
class OracleScene:
    """Float64 view of a scene, its textures and its test ray."""

    materials: dict
    lights: dict
    spheres: dict
    planes: dict
    disks: dict
    hollow_disks: dict
    cylinders: dict
    rectangles: dict
    boxes: dict
    background: Optional[np.ndarray] = None  # (H, W, 4), row 0 = bottom
    tex_data: Optional[np.ndarray] = None  # (T, Hmax, Wmax, 4)
    tex_sizes: Optional[np.ndarray] = None  # (T, 2)
    tex_max_size: Optional[np.ndarray] = None  # (2,)
    r_s: float = 1.0
    test_ray_points: Optional[np.ndarray] = None  # (K, 3) valid points only
    test_ray_flat_origin: Optional[np.ndarray] = None
    test_ray_flat_dir: Optional[np.ndarray] = None
    test_ray_radius: float = 0.025  # frag:189
    test_ray_extended_length: float = 1000.0  # frag:190

    @classmethod
    def from_scene(cls, sc, background=None, tex=None, r_s=1.0, test_ray=None):
        """From this package's ``Scene``, a background (a ``Texture`` or an
        (H, W, 4) array), a ``TextureStack`` and a ``TestRay``; every
        tensor to numpy, floats to float64."""

        def leaf(v):
            a = _host(v)
            if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
                return a
            return a.astype(np.float64)

        def d(soa):
            return {k: leaf(v) for k, v in soa._asdict().items()}

        kwargs = dict(
            materials=d(sc.materials),
            lights=d(sc.lights),
            spheres=d(sc.spheres),
            planes=d(sc.planes),
            disks=d(sc.disks),
            hollow_disks=d(sc.hollow_disks),
            cylinders=d(sc.cylinders),
            rectangles=d(sc.rectangles),
            boxes=d(sc.boxes),
            r_s=float(r_s),
        )
        if background is not None:
            kwargs["background"] = _np(getattr(background, "data",
                                               background))
        if tex is not None:
            kwargs["tex_data"] = _np(tex.data)
            kwargs["tex_sizes"] = _np(tex.sizes)
            kwargs["tex_max_size"] = _np(tex.max_size)
        if test_ray is not None:
            n = int(test_ray.num_points)
            kwargs["test_ray_points"] = _np(test_ray.points)[:n]
            kwargs["test_ray_flat_origin"] = _np(test_ray.flat_origin)
            kwargs["test_ray_flat_dir"] = _np(test_ray.flat_dir)
        return cls(**kwargs)


# --- small vec helpers -----------------------------------------------------


def normalize(v):
    return v / np.linalg.norm(v)


def square_vector(v):
    return float(np.dot(v, v))


def reflect(i, n):
    return i - 2.0 * np.dot(n, i) * n


def min_positive(n1, n2):
    """frag:441-454."""
    if n1 > 0 and n2 > 0:
        return min(n1, n2)
    if n1 > 0:
        return n1
    if n2 > 0:
        return n2
    return -1.0


def project(v, target):
    return np.dot(v, target) / square_vector(target) * target


def gram_schmidt(m):
    """frag:744-753; columns, keeps direction of column 1."""
    m = m.copy()
    m[:, 0] = m[:, 0] - project(m[:, 0], m[:, 1])
    m[:, 2] = m[:, 2] - project(m[:, 2], m[:, 1]) - project(m[:, 2], m[:, 0])
    for c in range(3):
        m[:, c] = normalize(m[:, c])
    return m


# --- physics (frag:336-355) -------------------------------------------------


def ddu(u, r_s=1.0):
    return -u * (1.0 - 1.5 * r_s * u)


def rk4_step(u, du, h, r_s=1.0):
    k1 = du
    l1 = ddu(u, r_s)
    k2 = du + 0.5 * l1 * h
    l2 = ddu(u + 0.5 * k1 * h, r_s)
    k3 = du + 0.5 * l2 * h
    l3 = ddu(u + 0.5 * k2 * h, r_s)
    k4 = du + l3 * h
    l4 = ddu(u + k3 * h, r_s)
    return (h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4),
            h / 6.0 * (l1 + 2 * l2 + 2 * l3 + l4))


# --- hit record -------------------------------------------------------------


class Hit:
    __slots__ = ("is_hit", "dist", "point", "tangent_space", "uv",
                 "obj_type", "mat_idx", "plane_idx")

    def __init__(self):
        self.is_hit = False
        self.dist = 0.0
        self.point = np.zeros(3)
        self.tangent_space = np.eye(3)  # columns [tangent, bitangent, normal]
        self.uv = np.zeros(2)
        self.obj_type = OBJECT_TYPE_SPECIAL
        self.mat_idx = 0
        self.plane_idx = -1


# --- intersections (frag:457-736) -------------------------------------------


def sphere_intersect(origin, direction, pos, axes, radius, max_lambda=-1.0):
    """frag:457-478 + tangent space frag:209-232."""
    res = Hit()
    oc = origin - pos
    d = np.dot(direction, oc) ** 2 - square_vector(oc) + radius * radius
    if d < 0:
        return res
    sqrt_d = math.sqrt(d)
    first = -np.dot(direction, oc)
    lam = min_positive(first - sqrt_d, first + sqrt_d)
    if not (lam >= 0 and (max_lambda < 0 or lam <= max_lambda)):
        return res
    res.is_hit = True
    res.point = origin + lam * direction
    res.dist = np.linalg.norm(res.point - origin)

    disp = res.point - pos
    nrm = normalize(disp)
    local = axes.T @ disp
    phi = math.atan2(local[0], local[2])
    if phi < 0:
        phi += 2 * PI
    theta = math.asin(np.clip(local[1] / radius, -1.0, 1.0))
    res.uv = np.array([phi / (2 * PI), theta / PI + 0.5])
    tangent = axes @ np.array([math.cos(phi), 0.0, -math.sin(phi)])
    bitangent = axes @ np.array([
        math.sin(phi) * math.cos(theta), math.sin(theta),
        math.cos(phi) * math.cos(theta),
    ])
    res.tangent_space = np.stack([tangent, bitangent, nrm], axis=1)
    res.obj_type = OBJECT_TYPE_SPHERE
    return res


def plane_intersect(origin, direction, pos, axes, max_lambda=-1.0):
    """frag:483-499 + frag:234-247."""
    res = Hit()
    nrm = axes[:, 1]
    denom = np.dot(nrm, direction)
    if abs(denom) < EPSILON:
        return res
    lam = np.dot(nrm, pos - origin) / denom
    if not (lam >= 0 and (max_lambda < 0 or lam <= max_lambda)):
        return res
    res.is_hit = True
    res.point = origin + direction * lam
    res.dist = np.linalg.norm(res.point - origin)
    local = axes.T @ (res.point - pos)
    res.uv = np.array([local[0], 1.0 - local[2]])
    res.tangent_space = np.stack([axes[:, 0], -axes[:, 2], axes[:, 1]], axis=1)
    res.obj_type = OBJECT_TYPE_PLANE
    return res


def _radial_tangent_space(res, pos, axes):
    disp = res.point - pos
    local = axes.T @ disp
    phi = math.atan2(local[0], local[2])
    if phi < 0:
        phi += 2 * PI
    tangent = normalize(disp)
    bitangent = axes @ np.array([math.cos(phi), 0.0, -math.sin(phi)])
    res.tangent_space = np.stack([tangent, bitangent, axes[:, 1]], axis=1)
    return phi, np.linalg.norm(local)


def disk_intersect(origin, direction, pos, axes, radius, max_lambda=-1.0):
    """frag:502-508 + frag:249-271."""
    res = plane_intersect(origin, direction, pos, axes, max_lambda)
    if res.is_hit and square_vector(res.point - pos) <= radius * radius:
        phi, r_local = _radial_tangent_space(res, pos, axes)
        res.uv = np.array([r_local / radius, phi / (2 * PI)])
        res.obj_type = OBJECT_TYPE_DISK
    else:
        res.is_hit = False
    return res


def hollow_disk_intersect(origin, direction, pos, axes, inner, outer,
                          max_lambda=-1.0):
    """frag:510-517 + frag:273-295."""
    res = plane_intersect(origin, direction, pos, axes, max_lambda)
    if res.is_hit:
        sq = square_vector(res.point - pos)
        if inner * inner <= sq <= outer * outer:
            phi, r_local = _radial_tangent_space(res, pos, axes)
            res.uv = np.array([(r_local - inner) / (outer - inner),
                               phi / (2 * PI)])
            res.obj_type = OBJECT_TYPE_HOLLOW_DISK
            return res
    res.is_hit = False
    return res


def cylinder_intersect(origin, direction, pos, axes, height, radius,
                       max_lambda=-1.0):
    """frag:523-570 + frag:297-318."""
    res = Hit()
    axis = axes[:, 1]
    lo = axes.T @ (origin - pos)
    ld = axes.T @ direction
    a = lo[0] * ld[0] + lo[2] * ld[2]
    dir_par_sq = ld[0] ** 2 + ld[2] ** 2
    d = a * a + dir_par_sq * (radius * radius - (lo[0] ** 2 + lo[2] ** 2))
    if d < 0 or dir_par_sq == 0.0:
        return res
    lam1 = -(a + math.sqrt(d)) / dir_par_sq
    lam2 = -(a - math.sqrt(d)) / dir_par_sq
    p1 = origin + direction * lam1
    p2 = origin + direction * lam2
    in1 = 0.0 <= np.dot(p1 - pos, axis) <= height
    in2 = 0.0 <= np.dot(p2 - pos, axis) <= height
    if not in1 and not in2:
        return res
    if in1 and in2:
        lam = min_positive(lam1, lam2)
    elif in1:
        lam = lam1
    else:
        lam = lam2
    if not (lam >= 0 and (max_lambda < 0 or lam <= max_lambda)):
        return res
    res.is_hit = True
    res.point = origin + direction * lam
    res.dist = np.linalg.norm(res.point - origin)

    disp = res.point - pos
    nrm = normalize(disp)  # reference quirk: includes axial component
    local = axes.T @ disp
    phi = math.atan2(local[0], local[2])
    if phi < 0:
        phi += 2 * PI
    res.uv = np.array([phi / (2 * PI), local[1] / height])
    tangent = axes @ np.array([math.cos(phi), 0.0, -math.sin(phi)])
    res.tangent_space = np.stack([tangent, axis, nrm], axis=1)
    res.obj_type = OBJECT_TYPE_CYLINDER
    return res


def rectangle_intersect(origin, direction, pos, axes, width, height,
                        max_lambda=-1.0):
    """frag:573-584 + frag:320-333."""
    res = plane_intersect(origin, direction, pos, axes, max_lambda)
    if not res.is_hit:
        return res
    disp = res.point - pos
    alpha = np.dot(disp, axes[:, 0])
    beta = np.dot(disp, axes[:, 2])
    if not (0.0 <= alpha <= width and 0.0 <= beta <= height):
        res.is_hit = False
        return res
    local = axes.T @ disp
    res.uv = np.array([local[0] / width, 1.0 - local[2] / height])
    res.obj_type = OBJECT_TYPE_RECTANGLE
    return res


_BOX_ATLAS = [(1.0, 0.0), (1.0, 2.0), (1.0, 1.0), (3.0, 1.0), (0.0, 1.0), (2.0, 1.0)]


def box_intersect(origin, direction, face_pos, face_axes, face_w, face_h,
                  max_lambda=-1.0):
    """frag:586-695: closest of 6 precomputed face rectangles + atlas UV."""
    res = Hit()
    closest = -1
    for i in range(6):
        hit = rectangle_intersect(origin, direction, face_pos[i], face_axes[i],
                                  face_w[i], face_h[i], max_lambda)
        if not hit.is_hit:
            continue
        if closest < 0 or hit.dist < res.dist:
            res = hit
            closest = i
    if not res.is_hit:
        return res
    du, dv = _BOX_ATLAS[closest]
    res.uv = np.array([(res.uv[0] + du) / 4.0, (res.uv[1] + dv) / 3.0])
    res.obj_type = OBJECT_TYPE_BOX
    return res


# --- closest hit over scene (frag:755-822) ----------------------------------


def scene_intersect(osc: OracleScene, origin, direction, max_lambda=-1.0):
    # Black hole first (frag:757-758).
    closest = sphere_intersect(origin, direction, np.zeros(3), np.eye(3),
                               osc.r_s, max_lambda)
    closest.obj_type = OBJECT_TYPE_SPECIAL

    def consider(hit, obj_type, mat_idx, plane_idx=-1):
        nonlocal closest
        if hit.is_hit and (not closest.is_hit or hit.dist < closest.dist):
            hit.obj_type = obj_type
            hit.mat_idx = mat_idx
            hit.plane_idx = plane_idx
            closest = hit

    # Test rays (frag:760-803) come before scene objects.
    if osc.test_ray_points is not None:
        frame = gram_schmidt(np.stack([
            osc.test_ray_flat_dir[[0, 2, 1]],
            osc.test_ray_flat_dir,
            osc.test_ray_flat_dir[[2, 0, 1]],
        ], axis=1))
        hit = cylinder_intersect(origin, direction, osc.test_ray_flat_origin,
                                 frame, osc.test_ray_extended_length,
                                 osc.test_ray_radius, max_lambda)
        consider(hit, OBJECT_TYPE_TEST_RAY_FLAT, 0)

        pts = osc.test_ray_points
        n = len(pts)
        for i in range(n - 1):
            if n < 2:
                break
            diff = pts[i + 1] - pts[i]
            seg_len = np.linalg.norm(diff)
            if i == n - 2 and np.linalg.norm(pts[n - 1]) < 1.0:
                seg_len = osc.test_ray_extended_length
            frame = gram_schmidt(np.stack(
                [diff[[0, 2, 1]], diff, diff[[2, 0, 1]]], axis=1))
            hit = cylinder_intersect(origin, direction, pts[i], frame, seg_len,
                                     osc.test_ray_radius, max_lambda)
            consider(hit, OBJECT_TYPE_TEST_RAY_CURVED, 0)

    sp = osc.spheres
    for i in range(len(sp["radius"])):
        hit = sphere_intersect(origin, direction, sp["pos"][i], sp["axes"][i],
                               sp["radius"][i], max_lambda)
        consider(hit, OBJECT_TYPE_SPHERE, int(sp["mat_idx"][i]))
    pl = osc.planes
    for i in range(len(pl["mat_idx"])):
        hit = plane_intersect(origin, direction, pl["pos"][i], pl["axes"][i],
                              max_lambda)
        consider(hit, OBJECT_TYPE_PLANE, int(pl["mat_idx"][i]), plane_idx=i)
    dk = osc.disks
    for i in range(len(dk["mat_idx"])):
        hit = disk_intersect(origin, direction, dk["pos"][i], dk["axes"][i],
                             dk["radius"][i], max_lambda)
        consider(hit, OBJECT_TYPE_DISK, int(dk["mat_idx"][i]))
    hd = osc.hollow_disks
    for i in range(len(hd["mat_idx"])):
        hit = hollow_disk_intersect(origin, direction, hd["pos"][i],
                                    hd["axes"][i], hd["inner_radius"][i],
                                    hd["outer_radius"][i], max_lambda)
        consider(hit, OBJECT_TYPE_HOLLOW_DISK, int(hd["mat_idx"][i]))
    cy = osc.cylinders
    for i in range(len(cy["mat_idx"])):
        hit = cylinder_intersect(origin, direction, cy["pos"][i], cy["axes"][i],
                                 cy["height"][i], cy["radius"][i], max_lambda)
        consider(hit, OBJECT_TYPE_CYLINDER, int(cy["mat_idx"][i]))
    rc = osc.rectangles
    for i in range(len(rc["mat_idx"])):
        hit = rectangle_intersect(origin, direction, rc["pos"][i],
                                  rc["axes"][i], rc["width"][i],
                                  rc["height"][i], max_lambda)
        consider(hit, OBJECT_TYPE_RECTANGLE, int(rc["mat_idx"][i]))
    bx = osc.boxes
    for i in range(len(bx["mat_idx"])):
        hit = box_intersect(origin, direction, bx["face_pos"][i],
                            bx["face_axes"][i], bx["face_width"][i],
                            bx["face_height"][i], max_lambda)
        consider(hit, OBJECT_TYPE_BOX, int(bx["mat_idx"][i]))

    return closest


# --- texturing / lighting (frag:365-438) ------------------------------------


def _bilinear(data, u, v):
    """GL_LINEAR + GL_REPEAT (matches textures._bilinear_gather)."""
    h, w = data.shape[0], data.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = math.floor(x)
    y0 = math.floor(y)
    fx = x - x0
    fy = y - y0
    x0i, x1i = int(x0) % w, (int(x0) + 1) % w
    y0i, y1i = int(y0) % h, (int(y0) + 1) % h
    c00 = data[y0i, x0i]
    c10 = data[y0i, x1i]
    c01 = data[y1i, x0i]
    c11 = data[y1i, x1i]
    top = c00 + fx * (c10 - c00)
    bot = c01 + fx * (c11 - c01)
    return top + fy * (bot - top)


def calculate_lighting(osc: OracleScene, hit: Hit, view_dir):
    """frag:365-438."""
    if hit.obj_type == OBJECT_TYPE_SPECIAL:
        return np.array([0.0, 0.0, 0.0, 1.0])
    if hit.obj_type == OBJECT_TYPE_TEST_RAY_CURVED:
        return TEST_RAY_CURVED_COLOR.copy()
    if hit.obj_type == OBJECT_TYPE_TEST_RAY_FLAT:
        return TEST_RAY_FLAT_COLOR.copy()

    m = osc.materials
    i = hit.mat_idx
    ts = hit.tangent_space.copy()
    if m["flip_normals"][i]:
        ts[:, 2] = -ts[:, 2]
    if not m["double_sided_normals"][i] and np.dot(ts[:, 2], view_dir) < 0:
        return np.zeros(4)

    uv = hit.uv.copy()
    if m["swap_uvs"][i]:
        uv = uv[::-1].copy()
    if m["invert_uv_x"][i]:
        ext = osc.planes["texture_size"][hit.plane_idx][0] \
            if hit.obj_type == OBJECT_TYPE_PLANE else 1.0
        uv[0] = ext - uv[0]
    if m["invert_uv_y"][i]:
        ext = osc.planes["texture_size"][hit.plane_idx][1] \
            if hit.obj_type == OBJECT_TYPE_PLANE else 1.0
        uv[1] = ext - uv[1]

    base_color = m["color"][i].copy()
    ti = int(m["texture_index"][i])
    if ti >= 0 and osc.tex_data is not None:
        rescaled = uv * osc.tex_sizes[ti] / osc.tex_max_size
        render_color = True
        if hit.obj_type == OBJECT_TYPE_PLANE:
            p = osc.planes
            j = hit.plane_idx
            rescaled = rescaled - p["texture_offset"][j]
            plane_uv = rescaled / p["texture_size"][j]
            rescaled = np.mod(rescaled, p["texture_size"][j]) / p["texture_size"][j]
            render_color = bool(p["repeat_texture"][j]) or (
                0.0 <= plane_uv[0] <= 1.0 and 0.0 <= plane_uv[1] <= 1.0
            )
        if render_color:
            base_color = _bilinear(osc.tex_data[ti], rescaled[0], rescaled[1])

    final_rgb = m["ambient"][i] * base_color[:3]

    normal = ts[:, 2]
    ni = int(m["normal_map_index"][i])
    if ni >= 0 and osc.tex_data is not None:
        rescaled = uv * osc.tex_sizes[ni] / osc.tex_max_size
        nm = _bilinear(osc.tex_data[ni], rescaled[0], rescaled[1])[:3]
        normal = normalize(ts @ nm)  # raw rgb, no *2-1 (frag:411-412)

    lt = osc.lights
    for j in range(len(lt["intensity"])):
        to_light = lt["pos"][j] - hit.point
        distance = np.linalg.norm(to_light)
        light_dir = to_light / distance
        attenuation = 1.0 / (
            lt["attenuation_constant"][j]
            + lt["attenuation_linear"][j] * distance
            + lt["attenuation_quadratic"][j] * distance * distance
        )
        diff = max(np.dot(normal, light_dir), 0.0)
        diffuse = m["diffuse"][i] * diff * lt["color"][j] * base_color[:3]
        reflect_dir = reflect(-light_dir, normal)
        spec = max(np.dot(view_dir, reflect_dir), 0.0) ** m["shininess"][i]
        specular = m["specular"][i] * spec * lt["color"][j]
        final_rgb = final_rgb + (diffuse + specular) * attenuation * lt["intensity"][j]

    return np.array([final_rgb[0], final_rgb[1], final_rgb[2], base_color[3]])


def intersect_color(osc, origin, direction, max_lambda=-1.0):
    """frag:755-822: closest hit -> shaded color (transparent black on miss)."""
    hit = scene_intersect(osc, origin, direction, max_lambda)
    if hit.is_hit:
        return calculate_lighting(osc, hit, -direction)
    return np.zeros(4)


def get_bg(osc, direction):
    """frag:829-837."""
    if osc.background is None:
        return np.zeros(4)
    u = math.atan2(direction[2], direction[0]) / PI
    if u < 0:
        u += 2.0
    u *= 0.5
    v = math.asin(np.clip(direction[1], -1.0, 1.0)) / PI + 0.5
    return _bilinear(osc.background, u, v)


def pixel_hash_rand(x, y, width, seed=0):
    """Portable lowbias32 pixel hash -> uniform [0,1); bit-identical to
    schwarzschild_tpu.render.pixel_hash_rand."""
    m = 0xFFFFFFFF
    h = (y * width + x + ((seed & m) * 0x9E3779B9 & m)) & m
    h ^= h >> 16
    h = (h * 0x7FEB352D) & m
    h ^= h >> 15
    h = (h * 0x846CA68B) & m
    h ^= h >> 16
    return np.float32(h) * np.float32(2.3283064365386963e-10)


def glsl_rand_f32(co):
    """The f32 GLSL hash (frag:839-841) — evaluated in float32 like the GPU so
    the skip mask matches the TPU renderer bit-for-bit."""
    co = np.asarray(co, np.float32)
    s = np.sin(co[0] * np.float32(12.9898) + co[1] * np.float32(78.233),
               dtype=np.float32)
    x = np.float32(s * np.float32(43758.5453))
    return float(x - np.floor(x))


# --- per-pixel main (frag:843-936) ------------------------------------------


def trace_ray(osc: OracleScene, origin, direction, max_steps=100,
              max_revolutions=2, u_f=0.01):
    """The curved-space march for one ray (frag:883-935), assuming the flat
    dispatch has already been handled by the caller.  Returns RGBA."""
    color = np.zeros(4)
    max_angle = 2.0 * float(max_revolutions) * PI
    r_s = osc.r_s

    normal_vec = normalize(origin)
    tangent_vec = normalize(np.cross(np.cross(normal_vec, direction), normal_vec))
    pos = origin.copy()
    direction = direction.copy()
    u = 1.0 / np.linalg.norm(origin)
    du = -u * np.dot(direction, normal_vec) / np.dot(direction, tangent_vec)

    phi = 0.0
    for i in range(max_steps):
        if u < u_f:
            # flat-space approximation (frag:891-912)
            big = sphere_intersect(pos, direction, np.zeros(3), np.eye(3),
                                   1.0 / u_f)
            if not big.is_hit:
                c = intersect_color(osc, pos, direction)
                color += c
                if c[3] != 1.0:
                    color += get_bg(osc, direction)
                return color
            normal_vec = normalize(big.point)
            if abs(np.dot(direction, normal_vec)) >= 1.0 - EPSILON:
                c = intersect_color(osc, pos, direction)
                color += c
                if c[3] != 1.0:
                    color += get_bg(osc, direction)
                return color
            tangent_vec = normalize(
                np.cross(np.cross(normal_vec, direction), normal_vec))
            u = 1.0 / np.linalg.norm(big.point)
            du = -u * np.dot(direction, normal_vec) / np.dot(direction, tangent_vec)

        step = (max_angle - phi) / float(max_steps - i)
        phi += step
        d_u, d_du = rk4_step(u, du, step, r_s)
        u += d_u
        du += d_du

        if u < 0:
            break

        prev = pos
        pos = (math.cos(phi) * normal_vec + math.sin(phi) * tangent_vec) / u
        delta = pos - prev
        seg_len = np.linalg.norm(delta)
        direction = delta / seg_len

        c = intersect_color(osc, prev, direction, seg_len)
        color += c
        if c[3] == 1.0:
            return color

    color += get_bg(osc, direction)
    return color


def render_pixel(osc: OracleScene, cam_pos, cam_axes, fov, u_ndc, v_ndc,
                 width, height, max_steps=100, max_revolutions=2, u_f=0.01,
                 percent_black=-1.0, raytrace_type=CURVED,
                 curved_percentage=0.5, crosshair=False,
                 noise_mode="hash", noise_seed=0, pixel_xy=None):
    """frag:843-936 for one pixel; (u_ndc, v_ndc) in (-1, 1)."""
    color = np.zeros(4)
    if crosshair:
        px = abs(u_ndc * width / 2.0)
        py = abs(v_ndc * height / 2.0)
        if ((px < CROSSHAIR_WIDTH / 2 and CROSSHAIR_SPACE < py < CROSSHAIR_LENGTH + CROSSHAIR_SPACE)
                or (py < CROSSHAIR_WIDTH / 2 and CROSSHAIR_SPACE < px < CROSSHAIR_LENGTH + CROSSHAIR_SPACE)):
            color = CROSSHAIR_COLOR.copy()

    ray_forward = 1.0 / math.tan(fov / 360.0 * PI)
    uv_vec = np.array([u_ndc, v_ndc * height / width])
    direction = normalize(cam_axes @ np.array([uv_vec[0], uv_vec[1], ray_forward]))
    origin = _np(cam_pos)

    normal_vec = normalize(origin)
    flat = (
        raytrace_type == FLAT
        or (raytrace_type == HALF_WIDTH and u_ndc > 2.0 * curved_percentage - 1.0)
        or (raytrace_type == HALF_HEIGHT and v_ndc > 2.0 * curved_percentage - 1.0)
        or abs(np.dot(direction, normal_vec)) >= 1.0 - EPSILON
    )
    if flat:
        c = intersect_color(osc, origin, direction)
        color = color + c
        if c[3] != 1.0:
            color = color + get_bg(osc, direction)
        return color
    if percent_black >= 0.0 and noise_mode != "none":
        if noise_mode == "glsl" or pixel_xy is None:
            rnd = glsl_rand_f32(uv_vec)
        elif noise_mode == "hash":
            rnd = pixel_hash_rand(pixel_xy[0], pixel_xy[1], width, noise_seed)
        else:
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        if rnd <= percent_black:
            return color

    return color + trace_ray(osc, origin, direction, max_steps,
                             max_revolutions, u_f)


def render_image(osc: OracleScene, cam_pos, cam_axes, fov, width, height,
                 **kwargs):
    """Full-frame oracle render (slow; use small sizes or sampled pixels)."""
    img = np.zeros((height, width, 4))
    cam_axes = _np(cam_axes)
    cam_pos = _np(cam_pos)
    for row in range(height):
        v = 1.0 - (2.0 * row + 1.0) / height
        for col in range(width):
            u = (2.0 * col + 1.0) / width - 1.0
            img[row, col] = render_pixel(osc, cam_pos, cam_axes, fov, u, v,
                                         width, height, pixel_xy=(col, row),
                                         **kwargs)
    return img
