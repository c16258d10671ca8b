"""Analytic ray-primitive intersections over the scene struct-of-arrays
(counterpart of ``schwarzschild_tpu.intersect``).

Every primitive of every type is intersected at once (rays x primitives)
and the closest hit is reduced with elementwise selects in the JAX
package's candidate order: black hole, the debug test ray's flat tube and
curved tubes, spheres, planes, disks, hollow disks, cylinders, rectangles,
boxes; ties keep the earlier candidate.  The division and square-root
guards are the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import geometry as geo
from .scene import (
    OBJECT_TYPE_BOX,
    OBJECT_TYPE_CYLINDER,
    OBJECT_TYPE_DISK,
    OBJECT_TYPE_HOLLOW_DISK,
    OBJECT_TYPE_PLANE,
    OBJECT_TYPE_RECTANGLE,
    OBJECT_TYPE_SPECIAL,
    OBJECT_TYPE_SPHERE,
    OBJECT_TYPE_TEST_RAY_CURVED,
    OBJECT_TYPE_TEST_RAY_FLAT,
    Scene,
)

_TINY = 1e-20
_DIV_GUARD = 1e-12
_INF = math.inf
_TWO_PI = 2.0 * math.pi


def _safe_div(a, b):
    """a / b with b guarded away from 0 (sign-preserving)."""
    guarded = torch.where(torch.abs(b) < _DIV_GUARD,
                          torch.where(b < 0, -_DIV_GUARD, _DIV_GUARD), b)
    return a / guarded


def _safe_normalize(v):
    return geo.safe_normalize(v, _TINY)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, _TINY))


def _safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))


class TestRay(NamedTuple):
    """Debug test-ray overlay (black_hole.frag:182-192): a fixed-size (K, 3)
    polyline with ``num_points`` valid entries (the host-integrated
    geodesic, :func:`features.calculate_test_ray`) and the un-deflected
    straight ray beside it."""

    points: torch.Tensor  # (K, 3)
    num_points: torch.Tensor  # () int32
    flat_origin: torch.Tensor  # (3,)
    flat_dir: torch.Tensor  # (3,)


class Hit(NamedTuple):
    """Closest-hit record (HitInfo, black_hole.frag:199-206)."""

    valid: torch.Tensor  # (...,) bool
    dist: torch.Tensor  # (...,)
    point: torch.Tensor  # (..., 3)
    tangent: torch.Tensor  # (..., 3)
    bitangent: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3)
    uv: torch.Tensor  # (..., 2)
    obj_type: torch.Tensor  # (...,) int32
    mat_idx: torch.Tensor  # (...,) int32
    plane_tex_offset: torch.Tensor  # (..., 2)
    plane_tex_size: torch.Tensor  # (..., 2)
    plane_repeat: torch.Tensor  # (...,) bool


def _mk_cand(valid, dist, point, tangent, bitangent, normal, uv, obj_type,
             mat_idx, plane_fields=None):
    """A candidate set: the fields of Hit with a trailing candidate axis N."""
    batch_n = valid.shape
    dev = valid.device
    if plane_fields is None:
        plane_fields = (torch.zeros(batch_n + (2,), device=dev),
                        torch.ones(batch_n + (2,), device=dev),
                        torch.ones(batch_n, dtype=torch.bool, device=dev))
    return Hit(
        valid=valid,
        dist=torch.where(valid, dist, _INF),
        point=point,
        tangent=tangent,
        bitangent=bitangent,
        normal=normal,
        uv=uv,
        obj_type=torch.broadcast_to(
            torch.as_tensor(obj_type, dtype=torch.int32, device=dev),
            batch_n),
        mat_idx=torch.broadcast_to(mat_idx.to(torch.int32), batch_n),
        plane_tex_offset=plane_fields[0],
        plane_tex_size=plane_fields[1],
        plane_repeat=plane_fields[2],
    )


def _phi_of(local_x, local_z):
    """atan(x, z) wrapped to [0, 2pi), with the JAX package's substitution
    on lanes within 1e-12 of the pole axis."""
    degenerate = local_x * local_x + local_z * local_z < _DIV_GUARD * _DIV_GUARD
    x = torch.where(degenerate, 0.0, local_x)
    z = torch.where(degenerate, 1.0, local_z)
    phi = torch.atan2(x, z)
    return torch.where(phi < 0.0, phi + _TWO_PI, phi)


def _within(lam, max_lambda):
    """lam >= 0 and (max_lambda < 0 or lam <= max_lambda)."""
    return (lam >= 0.0) & ((max_lambda < 0.0) | (lam <= max_lambda))


def _local_tangent(phi):
    cp, sp = torch.cos(phi), torch.sin(phi)
    return cp, sp, torch.stack([cp, torch.zeros_like(cp), -sp], dim=-1)


def sphere_candidates(origin, direction, max_lambda, pos, axes, radius,
                      mat_idx, obj_type=OBJECT_TYPE_SPHERE):
    """Quadratic sphere intersection + spherical tangent space
    (frag:457-478, 209-232)."""
    o = origin[..., None, :]
    d = direction[..., None, :]
    ml = max_lambda[..., None]

    oc = o - pos
    d_oc = geo.dot(d, oc)
    disc = d_oc * d_oc - geo.square_vector(oc) + radius * radius
    sqrt_d = _safe_sqrt(disc)
    lam = geo.min_positive(-d_oc - sqrt_d, -d_oc + sqrt_d)
    valid = (disc >= 0.0) & _within(lam, ml)

    point = o + lam[..., None] * d
    disp = point - pos
    normal = _safe_normalize(disp)
    local = geo.mat_tvec(axes, disp)
    phi = _phi_of(local[..., 0], local[..., 2])
    theta = _safe_asin(_safe_div(local[..., 1], radius))
    uv = torch.stack([geo.true_div(phi, _TWO_PI),
                      geo.true_div(theta, math.pi) + 0.5], dim=-1)
    cp, sp, tangent_local = _local_tangent(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    bitangent_local = torch.stack([sp * ct, st, cp * ct], dim=-1)
    tangent = geo.mat_vec(axes, tangent_local)
    bitangent = geo.mat_vec(axes, bitangent_local)
    dist = geo.safe_length(point - o)
    return _mk_cand(valid, dist, point, tangent, bitangent, normal, uv,
                    obj_type, mat_idx)


def _plane_lambda(o, d, ml, pos, axes):
    normal = axes[..., :, 1]
    denom = geo.dot(normal, d)
    lam = _safe_div(geo.dot(normal, pos - o), denom)
    valid = (torch.abs(denom) >= geo.EPSILON) & _within(lam, ml)
    return normal, lam, valid


def plane_candidates(origin, direction, max_lambda, planes):
    """Infinite plane + plane tangent space (frag:483-499, 234-247)."""
    o = origin[..., None, :]
    d = direction[..., None, :]
    ml = max_lambda[..., None]
    pos, axes = planes.pos, planes.axes

    _, lam, valid = _plane_lambda(o, d, ml, pos, axes)
    point = o + d * lam[..., None]
    local = geo.mat_tvec(axes, point - pos)
    uv = torch.stack([local[..., 0], 1.0 - local[..., 2]], dim=-1)
    tangent = torch.broadcast_to(axes[..., :, 0], point.shape)
    bitangent = torch.broadcast_to(-axes[..., :, 2], point.shape)
    nrm = torch.broadcast_to(axes[..., :, 1], point.shape)
    dist = geo.safe_length(point - o)
    batch_n = valid.shape
    plane_fields = (
        torch.broadcast_to(planes.texture_offset, batch_n + (2,)),
        torch.broadcast_to(planes.texture_size, batch_n + (2,)),
        torch.broadcast_to(planes.repeat_texture, batch_n),
    )
    return _mk_cand(valid, dist, point, tangent, bitangent, nrm, uv,
                    OBJECT_TYPE_PLANE, planes.mat_idx, plane_fields)


def _radial_frame(pos, axes, point):
    """Shared disk/hollow-disk tangent space (frag:249-295)."""
    disp = point - pos
    local = geo.mat_tvec(axes, disp)
    phi = _phi_of(local[..., 0], local[..., 2])
    r_local = geo.safe_length(local)
    tangent = _safe_normalize(disp)
    _, _, bl = _local_tangent(phi)
    bitangent = geo.mat_vec(axes, bl)
    normal = torch.broadcast_to(axes[..., :, 1], point.shape)
    return phi, r_local, tangent, bitangent, normal


def disk_candidates(origin, direction, max_lambda, disks):
    """Plane hit restricted to a disk (frag:502-508, 249-271)."""
    o = origin[..., None, :]
    d = direction[..., None, :]
    ml = max_lambda[..., None]
    pos, axes, radius = disks.pos, disks.axes, disks.radius

    _, lam, valid = _plane_lambda(o, d, ml, pos, axes)
    point = o + d * lam[..., None]
    valid = valid & (geo.square_vector(point - pos) <= radius * radius)
    phi, r_local, tangent, bitangent, normal = _radial_frame(pos, axes, point)
    uv = torch.stack([_safe_div(r_local, radius),
                      geo.true_div(phi, _TWO_PI)], dim=-1)
    dist = geo.safe_length(point - o)
    return _mk_cand(valid, dist, point, tangent, bitangent, normal, uv,
                    OBJECT_TYPE_DISK, disks.mat_idx)


def hollow_disk_candidates(origin, direction, max_lambda, hd):
    """Annulus (frag:510-517, 273-295): the accretion disk."""
    o = origin[..., None, :]
    d = direction[..., None, :]
    ml = max_lambda[..., None]
    pos, axes = hd.pos, hd.axes
    inner, outer = hd.inner_radius, hd.outer_radius

    _, lam, valid = _plane_lambda(o, d, ml, pos, axes)
    point = o + d * lam[..., None]
    sq = geo.square_vector(point - pos)
    valid = valid & (sq >= inner * inner) & (sq <= outer * outer)
    phi, r_local, tangent, bitangent, normal = _radial_frame(pos, axes, point)
    uv = torch.stack([_safe_div(r_local - inner, outer - inner),
                      geo.true_div(phi, _TWO_PI)], dim=-1)
    dist = geo.safe_length(point - o)
    return _mk_cand(valid, dist, point, tangent, bitangent, normal, uv,
                    OBJECT_TYPE_HOLLOW_DISK, hd.mat_idx)


def _in_height(p, pos, axis, height):
    t = geo.dot(p - pos, axis)
    return (t >= 0.0) & (t <= height)


def cylinder_candidates(origin, direction, max_lambda, pos, axes, height,
                        radius, mat_idx, obj_type=OBJECT_TYPE_CYLINDER):
    """Open lateral cylinder (frag:523-570, 297-318)."""
    o = origin[..., None, :]
    d = direction[..., None, :]
    ml = max_lambda[..., None]

    axis = axes[..., :, 1]
    local_o = geo.mat_tvec(axes, o - pos)
    local_d = geo.mat_tvec(axes, d)

    a = local_o[..., 0] * local_d[..., 0] + local_o[..., 2] * local_d[..., 2]
    dir_par_sq = local_d[..., 0] ** 2 + local_d[..., 2] ** 2
    origin_par_sq = local_o[..., 0] ** 2 + local_o[..., 2] ** 2
    disc = a * a + dir_par_sq * (radius * radius - origin_par_sq)
    sqrt_d = _safe_sqrt(disc)
    lam1 = _safe_div(-(a + sqrt_d), dir_par_sq)
    lam2 = _safe_div(-(a - sqrt_d), dir_par_sq)

    in1 = _in_height(o + d * lam1[..., None], pos, axis, height)
    in2 = _in_height(o + d * lam2[..., None], pos, axis, height)
    lam = torch.where(
        in1 & in2, geo.min_positive(lam1, lam2),
        torch.where(in1, lam1, torch.where(in2, lam2, -1.0)))
    valid = (disc >= 0.0) & (in1 | in2) & _within(lam, ml)
    point = o + d * lam[..., None]

    disp = point - pos
    normal = _safe_normalize(disp)  # reference quirk: includes axial part
    bitangent = torch.broadcast_to(axis, point.shape)
    local = geo.mat_tvec(axes, disp)
    phi = _phi_of(local[..., 0], local[..., 2])
    uv = torch.stack([geo.true_div(phi, _TWO_PI),
                      _safe_div(local[..., 1], height)], dim=-1)
    _, _, tl = _local_tangent(phi)
    tangent = geo.mat_vec(axes, tl)
    dist = geo.safe_length(point - o)
    return _mk_cand(valid, dist, point, tangent, bitangent, normal, uv,
                    obj_type, mat_idx)


def _rectangle_core(o, d, ml, pos, axes, width, height):
    """Plane hit + extent test + tangent space (frag:573-584, 320-333)."""
    _, lam, valid = _plane_lambda(o, d, ml, pos, axes)
    point = o + d * lam[..., None]
    disp = point - pos
    alpha = geo.dot(disp, axes[..., :, 0])
    beta = geo.dot(disp, axes[..., :, 2])
    valid = (valid & (alpha >= 0.0) & (alpha <= width) & (beta >= 0.0)
             & (beta <= height))
    local = geo.mat_tvec(axes, disp)
    uv = torch.stack([_safe_div(local[..., 0], width),
                      1.0 - _safe_div(local[..., 2], height)], dim=-1)
    tangent = torch.broadcast_to(axes[..., :, 0], point.shape)
    bitangent = torch.broadcast_to(-axes[..., :, 2], point.shape)
    normal = torch.broadcast_to(axes[..., :, 1], point.shape)
    dist = geo.safe_length(point - o)
    return valid, dist, point, tangent, bitangent, normal, uv


def rectangle_candidates(origin, direction, max_lambda, rects):
    o = origin[..., None, :]
    d = direction[..., None, :]
    ml = max_lambda[..., None]
    valid, dist, point, tangent, bitangent, normal, uv = _rectangle_core(
        o, d, ml, rects.pos, rects.axes, rects.width, rects.height)
    return _mk_cand(valid, dist, point, tangent, bitangent, normal, uv,
                    OBJECT_TYPE_RECTANGLE, rects.mat_idx)


def box_candidates(origin, direction, max_lambda, boxes):
    """Box = closest of its 6 face rectangles + 4x3 atlas UV
    (frag:586-695); one candidate per box."""
    o = origin[..., None, None, :]
    d = direction[..., None, None, :]
    ml = max_lambda[..., None, None]

    valid, dist, point, tangent, bitangent, normal, uv = _rectangle_core(
        o, d, ml, boxes.face_pos, boxes.face_axes, boxes.face_width,
        boxes.face_height)
    uv = (uv + boxes.atlas_offset) / torch.tensor([4.0, 3.0],
                                                  device=uv.device)
    dist = torch.where(valid, dist, _INF)

    best = [valid[..., 0], dist[..., 0], point[..., 0, :],
            tangent[..., 0, :], bitangent[..., 0, :], normal[..., 0, :],
            uv[..., 0, :]]
    for i in range(1, 6):
        cand = [valid[..., i], dist[..., i], point[..., i, :],
                tangent[..., i, :], bitangent[..., i, :], normal[..., i, :],
                uv[..., i, :]]
        better = cand[1] < best[1]
        bv = better[..., None]
        best = [torch.where(better, cand[0], best[0]),
                torch.where(better, cand[1], best[1])] + [
            torch.where(bv, c, b) for c, b in zip(cand[2:], best[2:])]
    return _mk_cand(*best, OBJECT_TYPE_BOX, boxes.mat_idx)


def black_hole_candidate(origin, direction, max_lambda, r_s):
    """The event horizon: a sphere of radius r_s at the origin (frag:104,
    757-758) that shades opaque black (OBJECT_TYPE_SPECIAL)."""
    dev = origin.device
    r = torch.as_tensor(r_s, dtype=torch.float32, device=dev).reshape(1)
    return sphere_candidates(
        origin, direction, max_lambda,
        torch.zeros((1, 3), device=dev),
        torch.eye(3, device=dev)[None], r,
        torch.zeros((1,), dtype=torch.int32, device=dev),
        obj_type=OBJECT_TYPE_SPECIAL)


def tube_frame(diff):
    """A tube's frame: gram_schmidt(mat3(diff.xzy, diff, diff.zxy)), the
    axis along ``diff`` (frag:764, 789)."""
    xzy = diff[..., [0, 2, 1]]
    zxy = diff[..., [2, 0, 1]]
    return geo.gram_schmidt(torch.stack([xzy, diff, zxy], dim=-1))


def tube_segments(test_ray: TestRay, r_s, extended_length=1000.0):
    """The curved tube chain's segments i -> i+1: (start (K-1, 3), frame
    (K-1, 3, 3), length (K-1,), active (K-1,)).  A segment is active for
    i < num_points - 1; the last one is extended to ``extended_length``
    when the geodesic's final point lies inside the horizon (frag:782-784,
    the radius test against r_s).  Inactive segments get the identity
    frame: their zero-length ``diff`` has none, and a NaN frame would reach
    the gradients of the rays through the masked candidates."""
    pts = test_ray.points
    npts = test_ray.num_points.to(torch.int64)
    p0 = pts[:-1]
    diff = pts[1:] - p0
    seg_idx = torch.arange(pts.shape[0] - 1, device=pts.device)
    active = (seg_idx < npts - 1) & (npts >= 2)
    last_inside = geo.length(pts[torch.clamp_min(npts - 1, 0)]) < r_s
    is_last = seg_idx == npts - 2
    seg_len = torch.where(is_last & last_inside, extended_length,
                          geo.length(diff))
    eye = torch.eye(3, device=pts.device).expand(diff.shape[:-1] + (3, 3))
    frames = torch.where(active[:, None, None], tube_frame(diff), eye)
    return p0, frames, seg_len, active


def test_ray_candidates(origin, direction, max_lambda, test_ray: TestRay,
                        radius=0.025, extended_length=1000.0, r_s=1.0):
    """Test-ray tubes (frag:760-803): one flat cylinder along the straight
    ray plus the chain of curved segment cylinders (:func:`tube_segments`).
    Returns (flat, curved) candidate sets."""
    dev = origin.device
    f32 = dict(dtype=torch.float32, device=dev)
    flat = cylinder_candidates(
        origin, direction, max_lambda, test_ray.flat_origin[None],
        tube_frame(test_ray.flat_dir)[None],
        torch.tensor([extended_length], **f32), torch.tensor([radius], **f32),
        torch.zeros((1,), dtype=torch.int32, device=dev),
        obj_type=OBJECT_TYPE_TEST_RAY_FLAT)
    r_s = torch.as_tensor(r_s, **f32).detach()
    p0, frames, seg_len, active = tube_segments(test_ray, r_s,
                                                extended_length)
    n = p0.shape[0]
    curved = cylinder_candidates(
        origin, direction, max_lambda, p0, frames, seg_len,
        torch.full((n,), radius, **f32),
        torch.zeros((n,), dtype=torch.int32, device=dev),
        obj_type=OBJECT_TYPE_TEST_RAY_CURVED)
    curved = curved._replace(valid=curved.valid & active,
                             dist=torch.where(active, curved.dist, _INF))
    return flat, curved


def _merge_hits(a: Hit, b: Hit) -> Hit:
    """Keep the closer hit; ties keep ``a`` (frag:811)."""
    better = b.dist < a.dist
    bv = better[..., None]
    return Hit(*(torch.where(better if x.dim() == better.dim() else bv, y, x)
                 for x, y in zip(a, b)))


def _reduce_cand(c: Hit, best: Optional[Hit] = None) -> Hit:
    n = c.valid.shape[-1]
    for i in range(n):
        h = Hit(*(x[..., i] if j in _SCALAR_FIELDS else x[..., i, :]
                  for j, x in enumerate(c)))
        best = h if best is None else _merge_hits(best, h)
    return best


# Hit fields without a trailing vector axis.
_SCALAR_FIELDS = {Hit._fields.index(f) for f in
                  ("valid", "dist", "obj_type", "mat_idx", "plane_repeat")}


def intersect_scene(origin, direction, max_lambda, sc: Scene,
                    r_s=1.0, test_ray: Optional[TestRay] = None) -> Hit:
    """Closest hit against the black hole, the test ray's tubes (if any)
    and the whole scene (frag:755-822).  ``max_lambda`` < 0 means an
    unbounded ray."""
    cands = [black_hole_candidate(origin, direction, max_lambda, r_s)]
    if test_ray is not None:
        cands.extend(test_ray_candidates(origin, direction, max_lambda,
                                         test_ray, r_s=r_s))
    if sc.spheres.radius.shape[0]:
        cands.append(sphere_candidates(
            origin, direction, max_lambda, sc.spheres.pos, sc.spheres.axes,
            sc.spheres.radius, sc.spheres.mat_idx))
    if sc.planes.mat_idx.shape[0]:
        cands.append(plane_candidates(origin, direction, max_lambda,
                                      sc.planes))
    if sc.disks.mat_idx.shape[0]:
        cands.append(disk_candidates(origin, direction, max_lambda, sc.disks))
    if sc.hollow_disks.mat_idx.shape[0]:
        cands.append(hollow_disk_candidates(origin, direction, max_lambda,
                                            sc.hollow_disks))
    if sc.cylinders.mat_idx.shape[0]:
        cands.append(cylinder_candidates(
            origin, direction, max_lambda, sc.cylinders.pos,
            sc.cylinders.axes, sc.cylinders.height, sc.cylinders.radius,
            sc.cylinders.mat_idx))
    if sc.rectangles.mat_idx.shape[0]:
        cands.append(rectangle_candidates(origin, direction, max_lambda,
                                          sc.rectangles))
    if sc.boxes.mat_idx.shape[0]:
        cands.append(box_candidates(origin, direction, max_lambda, sc.boxes))

    best = None
    for c in cands:
        best = _reduce_cand(c, best)
    return best
