"""Full-scene march and frame (counterpart of ``schwarzschild_tpu.kernel_scene``).

``march_scene`` is the wrapper of the CUDA kernel ``march_scene_kernel``
(csrc/march.cu), which replaces the Pallas kernel ``_scene_march_kernel``:
the geodesic march of kernel.py plus, per segment, validity-only tests
against the horizon and every scene-table row; each hit segment (start,
direction, length) is recorded into the next of K slots, every hit is
counted, and the ray stops when the horizon (status 1) or a provably opaque
primitive (status 4) is the segment's closest hit.  ``march_scene_torch``
is its plain version.

``march_scene_bwd`` is the wrapper of ``march_scene_bwd_kernel``, which
replaces the Pallas kernel ``_scene_march_bwd_kernel``: the adjoint of the
march with respect to origin, direction and r_s at the decisions the
forward run recorded in its event planes (``march_scene(events=True)``).
Its plain version ``march_scene_bwd_torch`` replays the differentiable
core with ``diff_step_torch`` and sweeps back with ``diff_step_vjp_torch``,
the hand-written VJP the kernel computes, line for line.
``march_scene_diff`` joins the two as a ``torch.autograd.Function``.

``render_fast`` composes those records into the frame.  A bilinear frame
composes through ``compose.compose_atlas``, the tile-compacted level
engine with one merged texel-or-sky fetch a lane a level from the fetch
atlas; a trilinear frame through the per-slot pass loop (each slot
re-intersected and shaded in order, added together, cut at the first
opaque hit; the far-field or flat ray folded into the first free slot; a
residual far pass; then the sky), as in the JAX package
(kernel_scene.py:1789-1889 there).  Frames whose noise mask is a static
function of the config (per-pixel hash noise, tile noise) render only the
surviving lanes or tiles, packed into a dense pseudo-image
(``_render_fast_lane_sparse``, ``_render_fast_tile_sparse``).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np
import torch

from . import _ext
from . import geometry as geo
from . import physics
from .compose import compose_atlas
from .config import CURVED, FLAT, RenderConfig
from .intersect import TestRay, intersect_scene, tube_frame, tube_segments
from .kernel import (  # noqa: F401  (statuses and noise_field are public here too)
    STATUS_CAPTURED,
    STATUS_ESCAPED,
    STATUS_MARCHING,
    _advance,
    _dot3,
    _far_field,
    _final_status,
    _f32,
    _guard,
    _init_march,
    _rk4_segment,
    _rnorm,
    _sphere_entry,
    _tangent_of,
    check_rays,
    compact_march,
    grid_planes,
    init_events,
    march_scalars,
    noise_field,
    pixel_masks,
    soft_shadow_alphas,
    steps_of,
)
from .noise import pixel_hash_rand_np, tile_hash_rand_np
from .scene import OBJECT_TYPE_SPECIAL, Scene
from .shading import (CROSSHAIR_COLOR, crosshair_mask, equirect_uv,
                      get_background, shade)
from .textures import Texture, TextureStack, build_atlas_cached, ensure_mips

STATUS_FLAT_FINISH = 3.0
STATUS_HIT_OPAQUE = 4.0

# Table names in the order the kernel reads them, with their row widths
# (kSphereCols ... kRectCols in csrc/march.cu).
TABLE_COLUMNS = (("spheres", 5), ("planes", 7), ("disks", 8), ("hollow", 9),
                 ("cylinders", 15), ("rects", 15))

# Tables (bounds, rows, planes) of at most this many 32-bit words are
# copied into each block's shared memory by the scene kernel; larger ones
# are read from device memory (8% slower on the demo scene at 1280x720 on
# an H100, tools/ab_march.py).  32 KB a block still lets 7 blocks of 128
# threads share an SM (its registers allow 8), and stays under the 48 KB a
# launch may ask for without an opt-in.
SHARED_TABLE_WORDS = 8192

_PRIMITIVES = ("spheres", "planes", "disks", "hollow_disks", "cylinders",
               "rectangles")


def _np(x):
    return x.detach().cpu().numpy()


def _opaque_flags(sc: Scene, tex: Optional[TextureStack]):
    """Per-primitive "provably opaque at every sample" flags, in numpy
    (kernel_scene.py:118-179 of the JAX package): material alpha exactly 1,
    no texture or a texture whose whole padded layer has alpha 1, and
    double-sided normals.  A stack that is being optimized
    (``requires_grad``) proves nothing, as a traced one in the JAX package:
    the flags are then those of no stack."""
    if tex is not None and tex.data.requires_grad:
        tex = None
    m = sc.materials
    color_a = _np(m.color)[:, 3]
    tex_idx = _np(m.texture_index)
    dbl = _np(m.double_sided_normals)
    tmin = (None if tex is None
            else _np(tex.data[..., 3].amin(dim=(1, 2)).to(torch.float32)))

    def mat_opaque(mat_idx):
        mi = _np(mat_idx).astype(int)
        if mi.size == 0:
            return np.zeros(0, np.float32)
        mi = np.clip(mi, 0, color_a.shape[0] - 1)
        a_ok = color_a[mi] == 1.0
        ti = tex_idx[mi]
        if tmin is None:
            t_ok = ti < 0
        else:
            t_ok = (ti < 0) | (tmin[np.clip(ti, 0, len(tmin) - 1)] == 1.0)
        return (a_ok & t_ok & dbl[mi]).astype(np.float32)

    flags = {name: mat_opaque(getattr(sc, name).mat_idx)
             for name in _PRIMITIVES}
    flags["boxes"] = np.repeat(mat_opaque(sc.boxes.mat_idx), 6)
    return flags


def _test_ray_cylinder_rows(test_ray: TestRay, r_s, radius=0.025,
                            extended_length=1000.0):
    """Debug test-ray tubes (frag:760-803) as (1 + K-1, 14) float32 numpy
    cylinder rows [pos, axes columns, height, radius] for the kernel's
    validity test: the straight (flat, green) tube, then the chain of
    curved (red) segment tubes (kernel_scene.py:70-118 of the JAX
    package).  The frames are :func:`intersect.tube_frame`'s, computed on
    the host, so the rows and the composition's re-intersection share one
    realization.  Inactive chain slots get height -1 (no point passes the
    y in [0, height] test) and the identity frame (no NaN in the tables)."""
    tr = TestRay(*(x.detach().cpu() for x in test_ray))
    r_s = torch.tensor(float(r_s), dtype=torch.float32)
    p0, frames, seg_len, active = tube_segments(tr, r_s, extended_length)
    height = torch.where(active, seg_len, -1.0)

    def rows(pos, fr, h):
        return torch.cat([pos, fr[:, :, 0], fr[:, :, 1], fr[:, :, 2],
                          h[:, None], torch.full_like(h[:, None], radius)], 1)

    flat = rows(tr.flat_origin[None], tube_frame(tr.flat_dir)[None],
                torch.tensor([extended_length]))
    return torch.cat([flat, rows(p0, frames, height)]).numpy()


def _pack_scene_smem(sc: Scene, tex: Optional[TextureStack] = None,
                     test_ray: Optional[TestRay] = None, r_s=1.0):
    """Scene -> dict of float32 (N, F) numpy tables, each with a trailing
    "provably opaque" column (all zero without ``tex``), the columns of the
    JAX package's tables (kernel_scene.py:182-270 there).  ``test_ray``
    appends its tube rows (:func:`_test_ray_cylinder_rows`, horizon radius
    ``r_s``) to the cylinders, marked opaque (the tube colours have alpha
    1, frag:191-192), so a tube stops the ray like the reference's
    first-opaque break.

    spheres (N,5) [pos, radius, opq]        planes (N,7) [pos, normal, opq]
    disks (N,8) [pos, normal, r^2, opq]     hollow (N,9) [pos, normal, in^2, out^2, opq]
    cylinders (N,15) [pos, axes columns, height, radius, opq]
    rects (N,15) [pos, axes columns, width, height, opq]; 6 rows per box."""
    if tex is not None:
        opq = _opaque_flags(sc, tex)
    else:
        opq = {name: np.zeros(getattr(sc, name).mat_idx.shape[0], np.float32)
               for name in _PRIMITIVES}
        opq["boxes"] = np.zeros(sc.boxes.mat_idx.shape[0] * 6, np.float32)

    def f(x):
        return _np(x).astype(np.float32)

    def col(name):
        return opq[name][:, None]

    out = {}
    if sc.spheres.radius.shape[0]:
        out["spheres"] = np.concatenate(
            [f(sc.spheres.pos), f(sc.spheres.radius)[:, None],
             col("spheres")], 1)
    if sc.planes.mat_idx.shape[0]:
        out["planes"] = np.concatenate(
            [f(sc.planes.pos), f(sc.planes.axes)[:, :, 1], col("planes")], 1)
    if sc.disks.mat_idx.shape[0]:
        out["disks"] = np.concatenate(
            [f(sc.disks.pos), f(sc.disks.axes)[:, :, 1],
             (f(sc.disks.radius) ** 2)[:, None], col("disks")], 1)
    if sc.hollow_disks.mat_idx.shape[0]:
        hd = sc.hollow_disks
        out["hollow"] = np.concatenate(
            [f(hd.pos), f(hd.axes)[:, :, 1], (f(hd.inner_radius) ** 2)[:, None],
             (f(hd.outer_radius) ** 2)[:, None], col("hollow_disks")], 1)
    if sc.cylinders.mat_idx.shape[0]:
        ax = f(sc.cylinders.axes)
        out["cylinders"] = np.concatenate(
            [f(sc.cylinders.pos), ax[:, :, 0], ax[:, :, 1], ax[:, :, 2],
             f(sc.cylinders.height)[:, None], f(sc.cylinders.radius)[:, None],
             col("cylinders")], 1)
    if test_ray is not None:
        tubes = _test_ray_cylinder_rows(test_ray, r_s)
        tubes = np.concatenate([tubes, np.ones((len(tubes), 1), np.float32)],
                               1)
        out["cylinders"] = np.concatenate(
            [out["cylinders"], tubes]) if "cylinders" in out else tubes
    rect_rows = []
    if sc.rectangles.mat_idx.shape[0]:
        ax = f(sc.rectangles.axes)
        rect_rows.append(np.concatenate(
            [f(sc.rectangles.pos), ax[:, :, 0], ax[:, :, 1], ax[:, :, 2],
             f(sc.rectangles.width)[:, None],
             f(sc.rectangles.height)[:, None], col("rectangles")], 1))
    if sc.boxes.mat_idx.shape[0]:
        fa = f(sc.boxes.face_axes).reshape(-1, 3, 3)
        rect_rows.append(np.concatenate(
            [f(sc.boxes.face_pos).reshape(-1, 3), fa[:, :, 0], fa[:, :, 1],
             fa[:, :, 2], f(sc.boxes.face_width).reshape(-1, 1),
             f(sc.boxes.face_height).reshape(-1, 1), col("boxes")], 1))
    if rect_rows:
        out["rects"] = np.concatenate(rect_rows, 0)
    return out


def _row_candidates(tables, px, py, pz, sdx, sdy, sdz, seg_len):
    """Each table row's exact test, as the kernel runs it: yields (table
    name, row index, candidate, opaque flag), the candidate the hit lambda
    within [0, seg_len] or inf where the row is not hit."""
    inf = float("inf")

    def within(lam):
        return (lam >= 0.0) & (lam <= seg_len)

    def cand(ok, lam):
        return torch.where(ok, lam, inf)

    def plane_lam(t0, t1, t2, nxs, nys, nzs):
        denom = _dot3(nxs, nys, nzs, sdx, sdy, sdz)
        num = nxs * (t0 - px) + nys * (t1 - py) + nzs * (t2 - pz)
        lam = num / _guard(denom)
        return (torch.abs(denom) >= geo.EPSILON) & within(lam), lam

    def sq32(x):  # an f32 product of two table values, as the kernel forms it
        return float(np.float32(x) * np.float32(x))

    for j, r in enumerate(tables.get("spheres", ())):
        t = [float(x) for x in r]
        ok, lam = _sphere_entry(px, py, pz, sdx, sdy, sdz, sq32(r[3]),
                                t[0], t[1], t[2])
        yield "spheres", j, cand(ok & within(lam), lam), t[4]
    for j, r in enumerate(tables.get("planes", ())):
        t = [float(x) for x in r]
        yield "planes", j, cand(*plane_lam(*t[:6])), t[6]
    for j, r in enumerate(tables.get("disks", ())):
        t = [float(x) for x in r]
        ok, lam = plane_lam(*t[:6])
        hx = px + lam * sdx - t[0]
        hy = py + lam * sdy - t[1]
        hz = pz + lam * sdz - t[2]
        yield "disks", j, cand(ok & (_dot3(hx, hy, hz, hx, hy, hz) <= t[6]),
                               lam), t[7]
    for j, r in enumerate(tables.get("hollow", ())):
        t = [float(x) for x in r]
        ok, lam = plane_lam(*t[:6])
        hx = px + lam * sdx - t[0]
        hy = py + lam * sdy - t[1]
        hz = pz + lam * sdz - t[2]
        sq = _dot3(hx, hy, hz, hx, hy, hz)
        yield "hollow", j, cand(ok & (sq >= t[6]) & (sq <= t[7]), lam), t[8]
    for j, r in enumerate(tables.get("cylinders", ())):
        t = [float(x) for x in r]
        rx, ry, rz = px - t[0], py - t[1], pz - t[2]
        lox = _dot3(t[3], t[4], t[5], rx, ry, rz)
        loy = _dot3(t[6], t[7], t[8], rx, ry, rz)
        loz = _dot3(t[9], t[10], t[11], rx, ry, rz)
        ldx = _dot3(t[3], t[4], t[5], sdx, sdy, sdz)
        ldy = _dot3(t[6], t[7], t[8], sdx, sdy, sdz)
        ldz = _dot3(t[9], t[10], t[11], sdx, sdy, sdz)
        height = t[12]
        a = lox * ldx + loz * ldz
        dps = ldx * ldx + ldz * ldz
        disc = a * a + dps * (sq32(r[13]) - (lox * lox + loz * loz))
        sq = torch.sqrt(torch.clamp_min(disc, 1e-20))
        dps_s = _guard(dps)
        lam1 = -(a + sq) / dps_s
        lam2 = -(a - sq) / dps_s
        y1 = loy + lam1 * ldy
        y2 = loy + lam2 * ldy
        in1 = (y1 >= 0.0) & (y1 <= height)
        in2 = (y2 >= 0.0) & (y2 <= height)
        both = torch.where((lam1 > 0) & (lam2 > 0), torch.minimum(lam1, lam2),
                           torch.where(lam1 > 0, lam1,
                                       torch.where(lam2 > 0, lam2, -1.0)))
        lam = torch.where(in1 & in2, both,
                          torch.where(in1, lam1, torch.where(in2, lam2, -1.0)))
        yield "cylinders", j, cand((disc >= 0.0) & (in1 | in2) & within(lam),
                                   lam), t[14]
    for j, r in enumerate(tables.get("rects", ())):
        t = [float(x) for x in r]
        ok, lam = plane_lam(t[0], t[1], t[2], t[6], t[7], t[8])
        hx = px + lam * sdx - t[0]
        hy = py + lam * sdy - t[1]
        hz = pz + lam * sdz - t[2]
        alpha = _dot3(t[3], t[4], t[5], hx, hy, hz)
        beta = _dot3(t[9], t[10], t[11], hx, hy, hz)
        ok = (ok & (alpha >= 0.0) & (alpha <= t[12]) & (beta >= 0.0)
              & (beta <= t[13]))
        yield "rects", j, cand(ok, lam), t[14]


def _segment_min_dist(tables, px, py, pz, sdx, sdy, sdz, seg_len):
    """Plain version of the kernel's segment_min_dist: the closest table hit
    lambda within [0, seg_len] (inf if none) and the closest over the rows
    flagged provably opaque."""
    best = torch.full_like(px, float("inf"))
    best_opq = best
    for _, _, cand, opq in _row_candidates(tables, px, py, pz, sdx, sdy, sdz,
                                           seg_len):
        best = torch.minimum(best, cand)
        if opq > 0.5:
            best_opq = torch.minimum(best_opq, cand)
    return best, best_opq


# ---------------------------------------------------------------------------
# The cull of the table tests.  Every row but a plane's lies inside a sphere
# (its bound), a box's six faces inside one more (their group's), and every
# bounded row inside one for the whole scene.  A segment from p along the
# unit direction sd of length L lies inside the ball of radius hl about
# m = p + hl sd for any hl >= L/2, so a row it hits has
# |m - c| <= R + hl: a segment that fails that test for the scene, its
# group or its row has no exact hit there, and the kernel skips the row's
# exact test (a skipped row folds inf, as its exact test would).
#
# The margins keep the test conservative under f32 rounding.  An exact test
# accepts a point that is off its primitive by rounding: a few ulps of the
# coordinates in play (|p|, |c|, L), and near a tangent a quadric's root
# moves by up to about sqrt(eps) of them (the discriminant's rounding
# error enters under a square root).  So the bound radius grows by
# CULL_REL of (R + |c|) plus CULL_ABS scene units (for rows of zero size at
# the origin), and hl is L/2 grown by the same CULL_REL: sqrt(f32 eps) is
# 3.5e-4, CULL_REL is 45 times that.  Rows with a non-finite bound (a
# degenerate axes matrix, non-finite columns) get an infinite radius and
# are never culled.
#
# One exact test accepts points off its primitive by more than rounding: a
# cylinder's, on a segment within 1e-6 of its axis direction (dps < 1e-12,
# where _guard replaces dps and lambda = -(a +- sq) * 1e12 lies anywhere;
# an axis-parallel segment "hits" at lambda = 100 at any distance from the
# axis).  No bound holds those, so the cull lets every such segment through
# to the cylinder's exact test (_parallel: |ldx| and |ldz| below 2e-6, which
# dps < 1e-12 needs), and the fold stays exact.  With dps >= 1e-12 the
# clamp of the discriminant at 1e-20 moves a root by at most 1e-10 / dps,
# off the surface by at most 1e-10 / sqrt(dps) <= 1e-4, inside CULL_ABS.
# ---------------------------------------------------------------------------

CULL_REL = 1.0 / 64.0
CULL_ABS = 1e-3
# hl = seg_len * CULL_HALF, one f32 product (the kernel gets it at launch).
CULL_HALF = float(np.float32(0.5 * (1.0 + CULL_REL)))

# Kernel type codes of the bounded tables (kSphere ... kRect in
# csrc/march.cu); planes are unbounded and tested on every step.
_BOUNDED = ("spheres", "disks", "hollow", "cylinders", "rects")


def _f32_up(x):
    """float64 array x rounded up to float32 values (radii that rounding
    must not shrink), as float64."""
    y = np.asarray(x, np.float32)
    y = np.where(y < x, np.nextafter(y, np.float32(np.inf)), y)
    return y.astype(np.float64)


def _sphere_around(centres, radii):
    """A ball around balls (centres (N, 3), radii (N,)), in float64: the
    centre of their bounding box and the largest distance past it."""
    c = 0.5 * (np.min(centres - radii[:, None], 0)
               + np.max(centres + radii[:, None], 0))
    return c, np.max(np.linalg.norm(centres - c, axis=1) + radii)


def _table_bounds(name, table):
    """(centres (N, 3), radii (N,), corners (N, 4, 3) or None) of a table's
    primitives before the margins, in float64; the radius is inf where a
    row has no finite bound (non-finite columns, a singular axes matrix).

    A row's axes matrix A has its columns at t[3:6], t[6:9], t[9:12]; its
    local offsets map to world ones through A^-T, which stretches a
    length by at most 1 / A's smallest singular value."""
    t = np.asarray(table, np.float64).reshape(len(table), -1)
    ok = np.all(np.isfinite(t), 1)
    t = np.where(ok[:, None], t, 0.0)
    corners = None
    if name == "spheres":
        r = np.abs(t[:, 3])
    elif name == "disks":
        r = np.sqrt(np.maximum(t[:, 6], 0.0))
    elif name == "hollow":
        r = np.sqrt(np.maximum(t[:, 7], 0.0))
    else:
        a = np.stack([t[:, 3:6], t[:, 6:9], t[:, 9:12]], 2)
        sv = np.linalg.svd(a, compute_uv=False)
        ok &= sv[:, -1] > 1e-12 * np.maximum(sv[:, 0], 1e-30)
        a = np.where(ok[:, None, None], a, np.eye(3))
        inv_t = np.linalg.inv(a).transpose(0, 2, 1)
        grow = 1.0 / np.where(ok, sv[:, -1], 1.0)
        w, h = t[:, 12], t[:, 13]
        zero = np.zeros_like(w)
        if name == "cylinders":  # y in [0, height] along the second column
            local = np.stack([zero, 0.5 * w, zero], 1)
            r = np.hypot(0.5 * np.abs(w), np.abs(h)) * grow
        else:  # rects: [0, width] along the first column, [0, height]
            local = np.stack([0.5 * w, zero, 0.5 * h], 1)  # along the third
            r = np.hypot(0.5 * w, 0.5 * h) * grow
            quad = np.stack([np.stack([a_, zero, b_], 1) for a_ in (zero, w)
                             for b_ in (zero, h)], 1)
            corners = t[:, None, :3] + np.einsum("nij,nkj->nki", inv_t, quad)
        t[:, :3] += np.einsum("nij,nj->ni", inv_t, local)
    return t[:, :3], np.where(ok, r, np.inf), corners


def _with_margin(c, r):
    """Bounds (c (N, 3), r (N,)) as (cx, cy, cz, R) tuples of float32-exact
    floats, r grown by the margins and rounded up; a non-finite bound
    becomes (0, 0, 0, inf)."""
    ok = np.all(np.isfinite(c), 1) & np.isfinite(r)
    c = np.where(ok[:, None], c, 0.0)
    c32 = c.astype(np.float32).astype(np.float64)
    r = (r + CULL_REL * (r + np.linalg.norm(c, axis=1)) + CULL_ABS
         + np.linalg.norm(c32 - c, axis=1))  # the centre's own rounding
    r = np.where(ok, _f32_up(np.where(ok, r, 0.0)), np.inf)
    return [tuple(x) for x in np.concatenate([c32, r[:, None]], 1).tolist()]


def _row_bounds(tables, n_box_faces: int = 0):
    """The cull's bounds of a table dict (:func:`_pack_scene_smem`):
    {"rows": {name: [(cx, cy, cz, R)] per row}, "groups": [(name, first,
    count, (cx, cy, cz, R))], "scene": (cx, cy, cz, R) or None}.  Each
    bound is a centre and a radius with the margins (see CULL_REL), as
    float32-exact floats.  A group is one row, or the six faces of a box:
    the last ``n_box_faces`` rows of "rects", six to a box, bounded by the
    ball around their corners (a face is the parallelogram they span).
    Planes are unbounded and have none."""
    rows, groups = {}, []
    for name in _BOUNDED:
        table = tables.get(name, ())
        if not len(table):
            rows[name] = []
            continue
        c, r, corners = _table_bounds(name, table)
        rows[name] = _with_margin(c, r)
        first_box = len(table) - (n_box_faces if name == "rects" else 0)
        groups += [(name, j, 1, rows[name][j]) for j in range(first_box)]
        for j in range(first_box, len(table), 6):
            box = corners[j:j + 6].reshape(-1, 3)
            if np.all(np.isfinite(r[j:j + 6])):
                bc, br = _sphere_around(box, np.zeros(len(box)))
            else:
                bc, br = np.zeros(3), np.inf
            groups.append((name, j, 6, _with_margin(bc[None],
                                                    np.array([br]))[0]))
    bounded = [b for name in _BOUNDED for b in rows[name]]
    if not bounded:
        return dict(rows=rows, groups=groups, scene=None)
    b = np.array(bounded)
    if np.all(np.isfinite(b[:, 3])):
        c, r = _sphere_around(b[:, :3], b[:, 3])
        scene = _with_margin(c[None], np.array([r]))[0]
    else:
        scene = (0.0, 0.0, 0.0, float("inf"))
    return dict(rows=rows, groups=groups, scene=scene)


def _reaches(b, mx, my, mz, hl):
    """The cull test of one bound b = (cx, cy, cz, R): |m - c|^2 <= (R +
    hl)^2, in csrc/march.cu's f32 operation order."""
    ex, ey, ez = mx - b[0], my - b[1], mz - b[2]
    reach = b[3] + hl
    return ex * ex + ey * ey + ez * ez <= reach * reach


def _parallel(row, sdx, sdy, sdz):
    """Where a segment runs along a cylinder's axis (``row`` its table row):
    |ldx| and |ldz| of its exact test below 2e-6, which holds wherever the
    test's dps = ldx^2 + ldz^2 is below 1e-12 and its guard takes over
    (csrc/march.cu's axis_parallel, the same f32 operations)."""
    t = [float(x) for x in row]
    ldx = _dot3(t[3], t[4], t[5], sdx, sdy, sdz)
    ldz = _dot3(t[9], t[10], t[11], sdx, sdy, sdz)
    return (torch.abs(ldx) < 2e-6) & (torch.abs(ldz) < 2e-6)


def segment_cull_torch(tables, bounds, px, py, pz, sdx, sdy, sdz, seg_len):
    """Plain version of the kernel's cull, level by level: {"scene": mask,
    "groups": [mask per group], "parallel": [mask per cylinder], "rows":
    {name: [mask per row]}}.  A row passes where the segment reaches the
    scene's bound, its group's and, in a group of several rows, its own,
    and a cylinder also where the segment runs along its axis; the kernel
    runs a row's exact test only there.  ``bounds`` is
    :func:`_row_bounds`'s of ``tables``."""
    hl = seg_len * CULL_HALF
    mx, my, mz = px + hl * sdx, py + hl * sdy, pz + hl * sdz
    out = dict(scene=None, groups=[], parallel=[
        _parallel(r, sdx, sdy, sdz) for r in tables.get("cylinders", ())],
        rows={name: [None] * len(b) for name, b in bounds["rows"].items()})
    if bounds["scene"] is None:
        return out
    out["scene"] = _reaches(bounds["scene"], mx, my, mz, hl)
    for name, first, count, bound in bounds["groups"]:
        in_group = out["scene"] & _reaches(bound, mx, my, mz, hl)
        out["groups"].append(in_group)
        for j in range(first, first + count):
            out["rows"][name][j] = (
                in_group if count == 1 else in_group & _reaches(
                    bounds["rows"][name][j], mx, my, mz, hl))
    for j, par in enumerate(out["parallel"]):
        out["rows"]["cylinders"][j] = out["rows"]["cylinders"][j] | par
    return out


def _kernel_tables(tables, bounds):
    """The table buffer march_scene_kernel reads (csrc/march.cu, "Table
    buffer"): float32 words, integer fields as int32 bit patterns, the
    cylinders' groups first.  Returns (buffer, n_groups, n_cylinder_groups,
    planes_at, n_planes)."""
    words = list(bounds["scene"] or (0.0, 0.0, 0.0, 0.0))
    groups = sorted(bounds["groups"], key=lambda g: g[0] != "cylinders")
    at = 4 + 8 * len(groups)
    ints, body = [], []
    for name, first, count, bound in groups:
        width = dict(TABLE_COLUMNS)[name] + 4
        words += list(bound) + [0.0] * 4
        ints.append((len(words) - 4, (_BOUNDED.index(name), at, count,
                                      width)))
        for j in range(first, first + count):
            body += list(bounds["rows"][name][j]) + list(tables[name][j])
        at += count * width
    planes = tables.get("planes", np.zeros((0, 7), np.float32))
    buf = np.concatenate([np.asarray(words + body, np.float32),
                          planes.reshape(-1).astype(np.float32)])
    view = buf.view(np.int32)
    for w, fields in ints:
        view[w:w + 4] = fields
    n_cylinders = sum(g[0] == "cylinders" for g in groups)
    return buf, len(groups), n_cylinders, at, planes.shape[0]


@functools.lru_cache(maxsize=16)
def _kernel_buffer_of(key, n_box_faces):
    tables = {name: np.frombuffer(data, np.float32).reshape(shape)
              for name, shape, data in key}
    return _kernel_tables(tables, _row_bounds(tables, n_box_faces))


def _kernel_buffer(tables, n_box_faces: int):
    """:func:`_kernel_tables` of ``tables`` with their bounds, cached on the
    tables' exact bytes: a frame of a scene seen before skips the bounds'
    host work.  The buffer is shared between calls; do not modify it."""
    key = tuple((name, t.shape, np.ascontiguousarray(t, np.float32).tobytes())
                for name, t in sorted(tables.items()))
    return _kernel_buffer_of(key, n_box_faces)


def _split_slots(start, sdir, slen):
    return [(start[k], sdir[k], slen[k]) for k in range(start.shape[0])]


def march_scene_torch(origin, direction, active, r_s, sc: Scene,
                      cfg: RenderConfig, n_slots: int = 4,
                      tex: Optional[TextureStack] = None,
                      events: bool = False,
                      test_ray: Optional[TestRay] = None):
    """Plain version of the scene march: (final_dir, final_pos, status,
    slots, nhits), slots a list of K (start (...,3), dir (...,3), len), and
    with ``events`` the dict of :func:`march_scene`."""
    p = _march_scene_planes_torch(origin, direction, active, r_s, sc, cfg,
                                  n_slots, tex, test_ray=test_ray)
    return _as_outputs(p, events, False, cfg)


# The JAX package's name for its plain twin of the march.
march_scene_jnp = march_scene_torch


def _as_outputs(p, events, count_steps, cfg):
    """A dict of march planes -> march_scene's return tuple."""
    out = (p["fdir"], p["fpos"], p["status"],
           _split_slots(p["start"], p["sdir"], p["slen"]), p["nhits"])
    if events:
        out = out + (dict(t_end=p["t_end"], ssteps=list(p["sstep"])),)
    if count_steps:
        out = out + (steps_of(p["t_end"], cfg.max_steps),)
    return out


def _march_scene_planes_torch(origin, direction, active, r_s, sc: Scene,
                              cfg: RenderConfig, n_slots: int,
                              tex: Optional[TextureStack], on_segment=None,
                              test_ray: Optional[TestRay] = None):
    """The plain scene march as a dict of planes (fdir, fpos, status, nhits,
    start, sdir, slen, t_end, sstep), slots stacked on a leading K axis.
    ``on_segment(live, px, py, pz, sdx, sdy, sdz, seg_len)``, if given, sees
    every step's segments before their table tests, ``live`` the lanes that
    run them (for the cull's tests and counts)."""
    dev = origin.device
    r_s = torch.as_tensor(r_s, dtype=torch.float32, device=dev)
    rs2 = r_s * r_s
    max_angle, u_f, far_r2 = march_scalars(cfg)
    tables = _pack_scene_smem(sc, tex, test_ray, r_s)
    s = _init_march(origin, direction, active)
    nh = torch.zeros(active.shape, device=dev)
    start = torch.zeros((n_slots,) + origin.shape, device=dev)
    sdir = torch.zeros_like(start)
    slen = torch.zeros((n_slots,) + active.shape, device=dev)
    t_end = init_events(active, cfg.max_steps)
    sstep = torch.full_like(slen, -1.0)
    inf = float("inf")
    for i in range(cfg.max_steps):
        if not bool(s["live"].any()):
            break  # every later step is the identity
        live = s["live"]
        finish = _far_field(s, u_f, far_r2)
        status = torch.where(finish, STATUS_FLAT_FINISH, s["status"])
        live = live & ~finish
        seg, seg_len = _rk4_segment(s, i, r_s, cfg.max_steps, max_angle)
        escaped = live & (seg["u"] < 0.0)
        status = torch.where(escaped, STATUS_ESCAPED, status)
        live = live & ~escaped

        px, py, pz = s["px"], s["py"], s["pz"]
        sdx, sdy, sdz = seg["dx"], seg["dy"], seg["dz"]
        bh_ok, bh_lam = _sphere_entry(px, py, pz, sdx, sdy, sdz, rs2)
        bh = torch.where(bh_ok & (bh_lam >= 0.0) & (bh_lam <= seg_len),
                         bh_lam, inf)
        if on_segment is not None:
            on_segment(live, px, py, pz, sdx, sdy, sdz, seg_len)
        best, best_opq = _segment_min_dist(tables, px, py, pz, sdx, sdy, sdz,
                                           seg_len)
        any_hit = live & (torch.minimum(best, bh) < inf)
        captured = any_hit & (bh <= best)  # the horizon wins ties
        opq_closest = any_hit & ~captured & (best_opq <= best)

        seg_start = torch.stack([px, py, pz], -1)
        seg_dir = torch.stack([sdx, sdy, sdz], -1)
        for k in range(n_slots):
            take = any_hit & (nh == float(k))
            start[k] = torch.where(take[..., None], seg_start, start[k])
            sdir[k] = torch.where(take[..., None], seg_dir, sdir[k])
            slen[k] = torch.where(take, seg_len, slen[k])
            sstep[k] = torch.where(take, float(i), sstep[k])
        nh = torch.where(any_hit, nh + 1.0, nh)

        status = torch.where(captured, STATUS_CAPTURED, status)
        status = torch.where(opq_closest, STATUS_HIT_OPAQUE, status)
        live = live & ~captured & ~opq_closest
        _advance(s, live | captured | opq_closest, seg)
        # The four terminal events are disjoint (each is gated on live).
        t_end = torch.where(finish | escaped | captured | opq_closest,
                            float(i), t_end)
        s["status"], s["live"] = status, live
    return dict(fdir=torch.stack([s["dx"], s["dy"], s["dz"]], -1),
                fpos=torch.stack([s["px"], s["py"], s["pz"]], -1),
                status=_final_status(s), nhits=nh, start=start, sdir=sdir,
                slen=slen, t_end=t_end, sstep=sstep)


def march_scene(origin, direction, active, r_s, sc: Scene, cfg: RenderConfig,
                n_slots: int = 4, tex: Optional[TextureStack] = None,
                events: bool = False, count_steps: bool = False,
                test_ray: Optional[TestRay] = None, mesh=None,
                compact: bool = False):
    """Scene march of (..., 3) rays: (final_dir, final_pos, status, slots,
    nhits); ``nhits`` counts every hit (uncapped), so ``nhits > n_slots``
    flags rays whose extra hits were dropped.  ``tex`` (the stack the hits
    will be shaded with) enables the in-kernel stop on provably opaque
    primitives.  ``test_ray`` adds its tubes to the cylinder table (opaque
    rows; see :func:`_pack_scene_smem`).

    ``events=True`` appends the dict {"t_end": (...), "ssteps": [(...)] * K}
    that the backward needs: the step of each ray's terminal event
    (``max_steps`` if it used up its steps, -1 if it never marched) and the
    step at which slot k recorded (-1 if never).  ``count_steps=True``
    appends the executed lane-steps, the sum over rays of their loop
    iterations, min(t_end + 1, max_steps) each (an int64 scalar tensor; the
    JAX package counts whole (8, 128) tiles instead, since a TPU tile runs
    until its last lane ends).

    A CUDA tensor launches ``march_scene_kernel`` (counted in
    ``march_scene.launches``); a CPU tensor runs :func:`march_scene_torch`.
    ``mesh`` (a ``DeviceMesh``) marches this rank's tile of the (H, W)
    rays, one launch, and returns the full planes on every rank
    (``sharding.shard_march``).  ``compact=True`` packs the active rays into
    the leading lanes first (``kernel.compact_march``; under a mesh, within
    each tile); it takes no ``events`` or ``count_steps``."""
    if (events or count_steps) and compact:
        raise ValueError("events and count_steps: non-compact marches only")
    if mesh is not None:
        if count_steps:
            raise ValueError("count_steps: a march on one device only")
        from .sharding import shard_march

        return shard_march(mesh, functools.partial(
            march_scene, sc=sc, cfg=cfg, n_slots=n_slots, tex=tex,
            events=events, test_ray=test_ray, compact=compact))(
                origin, direction, active, r_s)
    if compact:
        return compact_march(
            lambda o, d, a: march_scene(o, d, a, r_s, sc, cfg, n_slots, tex,
                                        test_ray=test_ray),
            origin, direction, active)
    p = _march_scene_planes(origin, direction, active, r_s, sc, cfg, n_slots,
                            tex, events or count_steps, test_ray)
    return _as_outputs(p, events, count_steps, cfg)


def _march_scene_planes(origin, direction, active, r_s, sc: Scene,
                        cfg: RenderConfig, n_slots: int,
                        tex: Optional[TextureStack], want_events: bool,
                        test_ray: Optional[TestRay] = None):
    """:func:`march_scene` as a dict of planes (see
    :func:`_march_scene_planes_torch`); t_end and sstep are None on the card
    unless ``want_events``."""
    check_rays(origin, direction, active)
    if n_slots < 0:
        raise ValueError(f"n_slots must be >= 0, got {n_slots}")
    if origin.device.type == "cpu":
        return _march_scene_planes_torch(origin, direction, active, r_s, sc,
                                         cfg, n_slots, tex, test_ray=test_ray)
    dev = origin.device
    tables = _pack_scene_smem(sc, tex, test_ray, r_s)
    for name, width in TABLE_COLUMNS:  # the kernel's fixed row layout
        if name in tables and tables[name].shape[1] != width:
            raise ValueError(f"{name} table rows have "
                             f"{tables[name].shape[1]} columns, not {width}")
    words, n_groups, n_cylinders, planes_at, n_planes = _kernel_buffer(
        tables, 6 * sc.boxes.mat_idx.shape[0])
    buf = torch.as_tensor(words, device=dev)

    fdir = torch.empty_like(origin)
    fpos = torch.empty_like(origin)
    status = torch.empty(active.shape, dtype=torch.float32, device=dev)
    nhits = torch.empty_like(status)
    # The kernel writes a slot only where a ray records one: zero the rest.
    start = torch.zeros((n_slots,) + origin.shape, device=dev)
    sdir = torch.zeros_like(start)
    slen = torch.zeros((n_slots,) + active.shape, device=dev)
    t_end = torch.empty_like(status) if want_events else None
    sstep = torch.full_like(slen, -1.0) if want_events else None
    n = active.numel()
    if n:
        max_angle, u_f, far_r2 = march_scalars(cfg)
        lib = _ext.library()
        width = active.shape[-1] if active.dim() else 1
        rc = lib.march_scene_launch(
            _ext.ptr(origin), _ext.ptr(direction), _ext.ptr(active),
            _ext.ptr(buf), words.size, int(words.size <= SHARED_TABLE_WORDS),
            n_groups, n_cylinders, planes_at, n_planes, CULL_HALF, n // width, width, _ext.ptr(fdir), _ext.ptr(fpos),
            _ext.ptr(status), _ext.ptr(nhits), _ext.ptr(start),
            _ext.ptr(sdir), _ext.ptr(slen), _ext.ptr(t_end), _ext.ptr(sstep),
            n_slots, n, float(np.float32(float(r_s))), cfg.max_steps,
            max_angle, u_f, far_r2, _ext.stream_ptr(dev))
        _ext.check(rc, "march_scene")
        march_scene.launches += 1
    return dict(fdir=fdir, fpos=fpos, status=status, nhits=nhits,
                start=start, sdir=sdir, slen=slen, t_end=t_end, sstep=sstep)


march_scene.launches = 0


# ---------------------------------------------------------------------------
# The adjoint: the differentiable core, its hand-written VJP, the backward
# kernel's wrapper and plain version, and the differentiable march.
# ---------------------------------------------------------------------------

# The core values a step carries gradients through (kernel_scene._CORE of
# the JAX package; the kernel's save scratch rows follow this order).
_CORE = ("px", "py", "pz", "dx", "dy", "dz", "nx", "ny", "nz",
         "tx", "ty", "tz", "u", "du", "phi")


def _init_core_torch(origin, direction):
    """The differentiable slice of the march's init (_init_core of the JAX
    package): a tuple of the 15 core planes."""
    s = _init_march(origin, direction,
                    torch.ones(origin.shape[:-1], dtype=torch.bool,
                               device=origin.device))
    return tuple(s[k] for k in _CORE)


def diff_step_torch(i, core, live_in, moved, r_s, cfg: RenderConfig):
    """One march step at fixed decisions (_make_diff_step of the JAX
    package), through the forward march's own functions: a live ray takes
    the far-field re-init where its values call for it, a ray that moved
    takes its segment's end.  Returns (new core, slot values (start x, y, z,
    segment direction x, y, z, segment length))."""
    max_angle, u_f, far_r2 = march_scalars(cfg)
    s = dict(zip(_CORE, core))
    s["live"] = live_in
    _far_field(s, u_f, far_r2)
    seg, seg_len = _rk4_segment(s, i, r_s, cfg.max_steps, max_angle)
    slot = (s["px"], s["py"], s["pz"], seg["dx"], seg["dy"], seg["dz"],
            seg_len)
    _advance(s, moved, seg)
    return tuple(s[k] for k in _CORE), slot


# The VJP helpers mirror march_common.cuh's: each returns the cotangents it
# contributes, 3-vectors as tuples of planes.  The guards follow the JAX
# package: max(x, c) passes 1 above c, 1/2 at a tie and 0 below; min(a, b)
# passes to the smaller, 1/2 each at a tie; guard(x) passes nothing where it
# replaced x; a select passes only to the branch it took.


def _vmax_grad(x, c):
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0))


def _axpy(g, b):
    return tuple(g * bi for bi in b)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _rnorm3_vjp(v, inv, g_inv):
    x, y, z = v
    m = x * x + y * y + z * z
    g_m = g_inv * (-0.5 * inv / torch.clamp_min(m, 1e-20)) * _vmax_grad(
        m, 1e-20)
    return _axpy(2.0 * g_m, v)


def _len3_vjp(v, length, g_len):
    x, y, z = v
    m = x * x + y * y + z * z
    g_m = g_len * (0.5 / length) * _vmax_grad(m, 1e-20)
    return _axpy(2.0 * g_m, v)


def _tangent_of_vjp(n, d, g_t):
    """t = tangent_of(n, d): the cotangents of n and d.  With c = n x d and
    x = c x n: g_c = n x g_x, g_n = g_x x c + d x g_c, g_d = g_c x n."""
    nx, ny, nz = n
    dx, dy, dz = d
    cx = ny * dz - nz * dy
    cy = nz * dx - nx * dz
    cz = nx * dy - ny * dx
    x = cy * nz - cz * ny
    y = cz * nx - cx * nz
    z = cx * ny - cy * nx
    inv = _rnorm(x, y, z)
    gx, gy, gz = _add(_axpy(inv, g_t),
                      _rnorm3_vjp((x, y, z), inv, _dot3(*g_t, x, y, z)))
    gcx = ny * gz - nz * gy
    gcy = nz * gx - nx * gz
    gcz = nx * gy - ny * gx
    g_n = ((gy * cz - gz * cy) + (dy * gcz - dz * gcy),
           (gz * cx - gx * cz) + (dz * gcx - dx * gcz),
           (gx * cy - gy * cx) + (dx * gcy - dy * gcx))
    g_d = (gcy * nz - gcz * ny, gcz * nx - gcx * nz, gcx * ny - gcy * nx)
    return g_n, g_d


def _binet_du_vjp(u, nd, dt, du, g_du):
    """du = -u * nd / guard(dt): the cotangents of u, nd and dt."""
    den = _guard(dt)
    g_num = g_du / den
    g_dt = torch.where(torch.abs(dt) < 1e-12, 0.0, -g_du * du / den)
    return -g_num * nd, g_num * -u, g_dt


def _min_positive_vjp(a, b, g):
    both = (a > 0.0) & (b > 0.0)
    ga = torch.where(both, torch.where(a < b, g, torch.where(b < a, 0.0,
                                                             0.5 * g)),
                     torch.where(a > 0.0, g, 0.0))
    gb = torch.where(both, torch.where(b < a, g, torch.where(a < b, 0.0,
                                                             0.5 * g)),
                     torch.where((a <= 0.0) & (b > 0.0), g, 0.0))
    return ga, gb


def _far_field_vjp(c, far_r2, g_nn, g_nt, g_new_u, g_new_du):
    """The far-field re-init values (nn, nt, new_u, new_du) as functions of
    the core's p and d: their cotangents (g_p, g_d)."""
    p = (c["px"], c["py"], c["pz"])
    d = (c["dx"], c["dy"], c["dz"])
    d_oc = _dot3(*d, *p)
    oc2 = _dot3(*p, *p)
    disc = d_oc * d_oc - oc2 + far_r2
    sq = torch.sqrt(torch.clamp_min(disc, 1e-20))
    lam1, lam2 = -d_oc - sq, -d_oc + sq
    big_lam = geo.min_positive(lam1, lam2)
    h = tuple(pi + big_lam * di for pi, di in zip(p, d))
    inv_h = _rnorm(*h)
    nn = _axpy(inv_h, h)
    nd = _dot3(*nn, *d)
    nt = _tangent_of(*nn, *d)
    dt = _dot3(*nt, *d)
    new_du = -inv_h * nd / _guard(dt)

    g_u, g_nd, g_dt = _binet_du_vjp(inv_h, nd, dt, new_du, g_new_du)
    g_inv_h = g_new_u + g_u
    g_nt = _add(g_nt, _axpy(g_dt, d))
    g_d = _axpy(g_dt, nt)
    tn, td = _tangent_of_vjp(nn, d, g_nt)
    g_nn = _add(_add(g_nn, tn), _axpy(g_nd, d))
    g_d = _add(_add(g_d, td), _axpy(g_nd, nn))
    g_inv_h = g_inv_h + _dot3(*g_nn, *h)
    g_h = _add(_axpy(inv_h, g_nn), _rnorm3_vjp(h, inv_h, g_inv_h))
    g_p = g_h
    g_lam = _dot3(*g_h, *d)
    g_d = _add(g_d, _axpy(big_lam, g_h))
    g_lam1, g_lam2 = _min_positive_vjp(lam1, lam2, g_lam)
    g_sq = g_lam2 - g_lam1
    g_disc = g_sq * (0.5 / sq) * _vmax_grad(disc, 1e-20)
    g_doc = -(g_lam1 + g_lam2) + 2.0 * d_oc * g_disc
    g_p = _add(g_p, _axpy(-2.0 * g_disc, p))
    g_d = _add(g_d, _axpy(g_doc, p))
    g_p = _add(g_p, _axpy(g_doc, d))
    return g_p, g_d


def _ddu_du(u, r_s):
    return -(1.0 - 1.5 * r_s * u) + 1.5 * r_s * u


def _ddu_drs(u):
    return 1.5 * u * u


def diff_step_vjp_torch(i, core, ct, ct_slot, live_in, moved, r_s,
                        cfg: RenderConfig):
    """The hand-written VJP of :func:`diff_step_torch` at step ``i`` from
    its input ``core``, as march_common.cuh's diff_step_vjp computes it:
    ``ct`` (15 planes) is the cotangent of the step's output core and
    ``ct_slot`` (7 planes) that of its slot values.  Returns (the cotangent
    of the input core, the per-lane r_s cotangent)."""
    max_angle, u_f, far_r2 = march_scalars(cfg)
    c = dict(zip(_CORE, core))
    g = dict(c)
    g["live"] = live_in
    finish = _far_field(g, u_f, far_r2)
    reinit = live_in & (c["u"] < u_f) & ~finish
    seg, seg_len = _rk4_segment(g, i, r_s, cfg.max_steps, max_angle)
    u0, du0 = g["u"], g["du"]
    h = geo.true_div(max_angle - c["phi"], float(cfg.max_steps - i))
    k1 = du0
    l1 = physics.ddu(u0, r_s)
    k2 = du0 + 0.5 * l1 * h
    a2 = u0 + 0.5 * k1 * h
    l2 = physics.ddu(a2, r_s)
    k3 = du0 + 0.5 * l2 * h
    a3 = u0 + 0.5 * k2 * h
    l3 = physics.ddu(a3, r_s)
    k4 = du0 + l3 * h
    a4 = u0 + k3 * h
    l4 = physics.ddu(a4, r_s)
    h6 = geo.true_div(h, 6.0)
    su = k1 + 2.0 * k2 + 2.0 * k3 + k4
    sl = l1 + 2.0 * l2 + 2.0 * l3 + l4
    u1 = seg["u"]
    inv_u = 1.0 / torch.clamp_min(u1, 1e-6)
    cphi, sphi = torch.cos(seg["phi"]), torch.sin(seg["phi"])
    n = (g["nx"], g["ny"], g["nz"])
    t = (g["tx"], g["ty"], g["tz"])
    q = _add(_axpy(cphi, n), _axpy(sphi, t))
    p = (c["px"], c["py"], c["pz"])
    dd = (seg["px"] - p[0], seg["py"] - p[1], seg["pz"] - p[2])
    inv_seg = _rnorm(*dd)

    # The output selects.
    zero = torch.zeros_like(u0)

    def sel(m, a):
        return torch.where(m, a, zero)

    ct_p, ct_d = ct[0:3], ct[3:6]
    g_np = tuple(sel(moved, x) for x in ct_p)
    in_p = tuple(sel(~moved, x) + y for x, y in zip(ct_p, ct_slot[0:3]))
    g_sd = tuple(y + sel(moved, x) for x, y in zip(ct_d, ct_slot[3:6]))
    in_d = tuple(sel(~moved, x) for x in ct_d)
    g_u1, g_du1, g_phi1 = (sel(moved, x) for x in ct[12:15])
    g_u0, g_du0 = sel(~moved, ct[12]), sel(~moved, ct[13])
    in_phi = sel(~moved, ct[14])
    g_n, g_t = ct[6:9], ct[9:12]

    # Segment: sd = dd * inv_seg, seg_len = len3(dd), dd = np - p.
    g_dd = _add(_axpy(inv_seg, g_sd),
                _rnorm3_vjp(dd, inv_seg, _dot3(*g_sd, *dd)))
    g_dd = _add(g_dd, _len3_vjp(dd, seg_len, ct_slot[6]))
    g_np = _add(g_np, g_dd)
    in_p = tuple(x - y for x, y in zip(in_p, g_dd))

    # Polar -> Cartesian: np = q * inv_u, q = cos(phi1) n + sin(phi1) t.
    g_inv_u = _dot3(*g_np, *q)
    g_q = _axpy(inv_u, g_np)
    g_u1 = g_u1 + -g_inv_u * inv_u * inv_u * _vmax_grad(u1, 1e-6)
    g_n = _add(g_n, _axpy(cphi, g_q))
    g_t = _add(g_t, _axpy(sphi, g_q))
    g_c = _dot3(*g_q, *n)
    g_s = _dot3(*g_q, *t)
    g_phi1 = g_phi1 + (-sphi * g_c + cphi * g_s)

    # RK4 (physics.rk4_step), in reverse.
    g_u0 = g_u0 + g_u1
    g_du0 = g_du0 + g_du1
    g_h = (g_u1 * su + g_du1 * sl) / 6.0
    g_su, g_sl = g_u1 * h6, g_du1 * h6
    g_k1, g_k2, g_k3, g_k4 = g_su, 2.0 * g_su, 2.0 * g_su, g_su
    g_l1, g_l2, g_l3, g_l4 = g_sl, 2.0 * g_sl, 2.0 * g_sl, g_sl
    g_a4 = g_l4 * _ddu_du(a4, r_s)
    g_rs = g_l4 * _ddu_drs(a4)
    g_du0 = g_du0 + g_k4
    g_l3 = g_l3 + g_k4 * h
    g_h = g_h + g_k4 * l3
    g_u0 = g_u0 + g_a4
    g_k3 = g_k3 + g_a4 * h
    g_h = g_h + g_a4 * k3
    g_a3 = g_l3 * _ddu_du(a3, r_s)
    g_rs = g_rs + g_l3 * _ddu_drs(a3)
    g_du0 = g_du0 + g_k3
    g_l2 = g_l2 + g_k3 * 0.5 * h
    g_h = g_h + g_k3 * 0.5 * l2
    g_u0 = g_u0 + g_a3
    g_k2 = g_k2 + g_a3 * 0.5 * h
    g_h = g_h + g_a3 * 0.5 * k2
    g_a2 = g_l2 * _ddu_du(a2, r_s)
    g_rs = g_rs + g_l2 * _ddu_drs(a2)
    g_du0 = g_du0 + g_k2
    g_l1 = g_l1 + g_k2 * 0.5 * h
    g_h = g_h + g_k2 * 0.5 * l1
    g_u0 = g_u0 + g_a2
    g_k1 = g_k1 + g_a2 * 0.5 * h
    g_h = g_h + g_a2 * 0.5 * k1
    g_u0 = g_u0 + g_l1 * _ddu_du(u0, r_s)
    g_rs = g_rs + g_l1 * _ddu_drs(u0)
    g_du0 = g_du0 + g_k1
    # phi1 = phi + h, h = (max_angle - phi) / (max_steps - i).
    g_h = g_h + g_phi1
    in_phi = in_phi + g_phi1 - g_h / float(cfg.max_steps - i)

    # The re-init select.
    ff_p, ff_d = _far_field_vjp(c, far_r2, g_n, g_t, g_u0, g_du0)
    in_p = tuple(x + sel(reinit, y) for x, y in zip(in_p, ff_p))
    in_d = tuple(x + sel(reinit, y) for x, y in zip(in_d, ff_d))
    keep = ~reinit
    in_n = tuple(sel(keep, x) for x in g_n)
    in_t = tuple(sel(keep, x) for x in g_t)
    ct_in = (in_p + in_d + in_n + in_t
             + (sel(keep, g_u0), sel(keep, g_du0), in_phi))
    return ct_in, g_rs


def _init_core_vjp_torch(origin, direction, ct):
    """The VJP of :func:`_init_core_torch` from the initial core's
    cotangent ``ct``: (g_origin, g_direction), each (..., 3)."""
    s = _init_march(origin, direction,
                    torch.ones(origin.shape[:-1], dtype=torch.bool,
                               device=origin.device))
    o = (s["px"], s["py"], s["pz"])
    d = (s["dx"], s["dy"], s["dz"])
    n = (s["nx"], s["ny"], s["nz"])
    t = (s["tx"], s["ty"], s["tz"])
    inv = s["u"]
    nd0 = _dot3(*n, *d)
    dt0 = _dot3(*t, *d)
    g_o, g_d, g_n, g_t = ct[0:3], ct[3:6], ct[6:9], ct[9:12]
    g_u, g_nd, g_dt = _binet_du_vjp(inv, nd0, dt0, s["du"], ct[13])
    g_inv = ct[12] + g_u
    g_t = _add(g_t, _axpy(g_dt, d))
    g_d = _add(g_d, _axpy(g_dt, t))
    g_n = _add(g_n, _axpy(g_nd, d))
    g_d = _add(g_d, _axpy(g_nd, n))
    tn, td = _tangent_of_vjp(n, d, g_t)
    g_n = _add(g_n, tn)
    g_d = _add(g_d, td)
    g_o = _add(g_o, _axpy(inv, g_n))
    g_inv = g_inv + _dot3(*g_n, *o)
    g_o = _add(g_o, _rnorm3_vjp(o, inv, g_inv))
    return torch.stack(g_o, -1), torch.stack(g_d, -1)


def _died_moving(status, events):
    """Whether each ray moved at its end step: the horizon march records it
    (``events["died_moving"]``); for the scene march a capture or an opaque
    stop moves into its hit and an escape or a flat finish does not."""
    if "died_moving" in events:
        return events["died_moving"]
    return (status == STATUS_CAPTURED) | (status == STATUS_HIT_OPAQUE)


def _step_masks(i, t_end, died_moving):
    """(live_in, moved) of step i from the event planes."""
    live_in = float(i) <= t_end
    moved = (float(i) < t_end) | ((t_end == float(i)) & died_moving)
    return live_in, moved


def march_scene_bwd_torch(origin, direction, r_s, cfg: RenderConfig,
                          cotangents, status, events, n_slots: int = 4):
    """Plain version of the adjoint kernel (arguments and result as
    :func:`march_scene_bwd`): replay the core over every step some ray ran,
    saving it, then sweep back with :func:`diff_step_vjp_torch`.  A ray's
    steps past its t_end pass its cotangent through unchanged, as the
    kernel, which never walks them, does."""
    ct_fdir, ct_fpos, ct_slots = cotangents
    r_s = _f32(r_s, origin.device)
    t_end = events["t_end"]
    ssteps = events["ssteps"]
    died_moving = _died_moving(status, events)
    last = (min(cfg.max_steps, int(t_end.max().item()) + 1)
            if t_end.numel() else 0)
    core = _init_core_torch(origin, direction)
    saves = []
    for i in range(last):
        saves.append(core)
        core, _ = diff_step_torch(i, core, *_step_masks(i, t_end, died_moving),
                                  r_s, cfg)
    zero = torch.zeros(origin.shape[:-1], device=origin.device)
    ct = ct_fpos.unbind(-1) + ct_fdir.unbind(-1) + (zero,) * 9
    g_rs = zero
    for i in reversed(range(last)):
        live_in, moved = _step_masks(i, t_end, died_moving)
        ct_slot = [zero] * 7
        for k in range(n_slots):
            take = ssteps[k] == float(i)
            cs, cd, cl = ct_slots[k]
            vals = cs.unbind(-1) + cd.unbind(-1) + (cl,)
            ct_slot = [a + torch.where(take, v, 0.0)
                       for a, v in zip(ct_slot, vals)]
        new_ct, g = diff_step_vjp_torch(i, saves[i], ct, ct_slot, live_in,
                                        moved, r_s, cfg)
        ct = tuple(torch.where(live_in, a, b) for a, b in zip(new_ct, ct))
        g_rs = g_rs + torch.where(live_in, g, 0.0)
    g_origin, g_dir = _init_core_vjp_torch(origin, direction, ct)
    return g_origin, g_dir, g_rs.sum()


def march_scene_bwd(origin, direction, r_s, cfg: RenderConfig, cotangents,
                    status, events, n_slots: int = 4):
    """Adjoint of :func:`march_scene` with respect to (origin, direction,
    r_s) at the decisions the forward run took.  ``cotangents`` = (ct_fdir,
    ct_fpos, ct_slots), ct_slots a list of K (ct_start, ct_dir, ct_len);
    ``status`` and ``events`` (the dict of ``march_scene(events=True)``)
    carry the forward's decisions, so no scene is needed.  ``events`` may
    also hold ``died_moving`` (the horizon march's record), which then
    replaces the one read from ``status``.  Returns (g_origin, g_direction,
    g_r_s scalar).

    A CUDA tensor launches ``march_scene_bwd_kernel`` (counted in
    ``march_scene_bwd.launches``) with a checkpoint scratch of
    ceil(max_steps / BWD_CHECKPOINT_EVERY) x 15 x rays f32
    (:func:`bwd_scratch_bytes`); a CPU tensor runs
    :func:`march_scene_bwd_torch`."""
    if origin.device.type == "cpu":
        return march_scene_bwd_torch(origin, direction, r_s, cfg, cotangents,
                                     status, events, n_slots)
    dev = origin.device
    ct_fdir, ct_fpos, ct_slots = cotangents
    if len(ct_slots) != n_slots or len(events["ssteps"]) != n_slots:
        raise ValueError(f"expected {n_slots} slot cotangents and sstep "
                         "planes")
    batch = origin.shape[:-1]
    planes = [origin, direction, ct_fdir, ct_fpos]
    if any(x.shape != origin.shape for x in planes):
        raise ValueError("origin, direction and the fdir/fpos cotangents "
                         "must share one (..., 3) shape")

    def stack(xs, shape):
        if not xs:
            return torch.zeros((0,) + shape, device=dev)
        return torch.stack([x.to(torch.float32) for x in xs]).contiguous()

    t_end = events["t_end"].to(torch.float32).contiguous()
    died = _died_moving(status, events).to(torch.bool).contiguous()
    sstep = stack(events["ssteps"], batch)
    ct_start = stack([c[0] for c in ct_slots], origin.shape)
    ct_sdir = stack([c[1] for c in ct_slots], origin.shape)
    ct_slen = stack([c[2] for c in ct_slots], batch)
    args = [origin, direction, t_end, died, sstep, ct_fdir.contiguous(),
            ct_fpos.contiguous(), ct_start, ct_sdir, ct_slen]
    if any(x.device != dev for x in args):
        raise ValueError("march_scene_bwd: every input must be on one device")
    g_origin = torch.empty_like(origin)
    g_dir = torch.empty_like(origin)
    g_rs = torch.zeros(batch, device=dev)
    n = t_end.numel()
    if n:
        ckpt = torch.empty(bwd_scratch_bytes(cfg, n) // 4, device=dev)
        max_angle, u_f, far_r2 = march_scalars(cfg)
        rc = _ext.library().march_scene_bwd_launch(
            *(_ext.ptr(x) for x in args), n_slots, _ext.ptr(g_origin),
            _ext.ptr(g_dir), _ext.ptr(g_rs), _ext.ptr(ckpt), n,
            float(np.float32(float(r_s))), cfg.max_steps, max_angle, u_f,
            far_r2, _ext.stream_ptr(dev))
        _ext.check(rc, "march_scene_bwd")
        march_scene_bwd.launches += 1
    return g_origin, g_dir, torch.sum(g_rs)


march_scene_bwd.launches = 0


# The adjoint kernel saves a ray's core at every BWD_CHECKPOINT_EVERY-th
# step and recomputes the steps between (the build's BWD_CKPT).
BWD_CHECKPOINT_EVERY = _ext.DESIGN["BWD_CKPT"]


def bwd_scratch_bytes(cfg: RenderConfig, n_rays: int) -> int:
    """Bytes of the adjoint kernel's checkpoint scratch: the 15 core values
    f32 at every BWD_CHECKPOINT_EVERY-th step of every ray."""
    saves = -(-cfg.max_steps // BWD_CHECKPOINT_EVERY)
    return saves * len(_CORE) * n_rays * 4


class _MarchSceneDiff(torch.autograd.Function):
    """The scene march with the adjoint kernel as its backward.  The slots
    travel as stacked (K, ...) tensors: a Function cannot return a list of
    tuples."""

    @staticmethod
    def forward(ctx, origin, direction, r_s, active, sc, cfg, n_slots, tex,
                test_ray):
        p = _march_scene_planes(origin, direction, active, r_s, sc, cfg,
                                n_slots, tex, True, test_ray)
        ctx.save_for_backward(origin, direction, r_s, p["status"],
                              p["t_end"], p["sstep"])
        ctx.cfg, ctx.n_slots = cfg, n_slots
        ctx.mark_non_differentiable(p["status"], p["nhits"])
        return (p["fdir"], p["fpos"], p["status"], p["nhits"], p["start"],
                p["sdir"], p["slen"])

    @staticmethod
    def backward(ctx, g_fdir, g_fpos, _g_status, _g_nhits, g_start, g_sdir,
                 g_slen):
        origin, direction, r_s, status, t_end, sstep = ctx.saved_tensors
        K = ctx.n_slots

        def ct(g, shape):
            return torch.zeros(shape, device=origin.device) if g is None else g

        g_fdir = ct(g_fdir, origin.shape)
        g_fpos = ct(g_fpos, origin.shape)
        g_start = ct(g_start, (K,) + origin.shape)
        g_sdir = ct(g_sdir, (K,) + origin.shape)
        g_slen = ct(g_slen, (K,) + origin.shape[:-1])
        slots = [(g_start[k], g_sdir[k], g_slen[k]) for k in range(K)]
        g_o, g_d, g_rs = march_scene_bwd(
            origin, direction, r_s, ctx.cfg, (g_fdir, g_fpos, slots), status,
            dict(t_end=t_end, ssteps=list(sstep)), n_slots=K)
        return (g_o, g_d, g_rs.reshape(r_s.shape)) + (None,) * 6


class _MarchSceneReplay(torch.autograd.Function):
    """The scene march whose backward replays the plain march
    (:func:`march_scene_torch`) under autograd: the JAX package's replay
    backward, kept as a gradient oracle for the adjoint kernel."""

    @staticmethod
    def forward(ctx, origin, direction, r_s, active, sc, cfg, n_slots, tex,
                test_ray):
        p = _march_scene_planes(origin, direction, active, r_s, sc, cfg,
                                n_slots, tex, False, test_ray)
        ctx.save_for_backward(origin, direction, r_s, active)
        ctx.args = (sc, cfg, n_slots, tex, test_ray)
        ctx.mark_non_differentiable(p["status"], p["nhits"])
        return (p["fdir"], p["fpos"], p["status"], p["nhits"], p["start"],
                p["sdir"], p["slen"])

    @staticmethod
    def backward(ctx, g_fdir, g_fpos, _g_status, _g_nhits, g_start, g_sdir,
                 g_slen):
        origin, direction, r_s, active = ctx.saved_tensors
        sc, cfg, n_slots, tex, test_ray = ctx.args
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True)
                      for x in (origin, direction, r_s)]
            p = _march_scene_planes_torch(*leaves[:2], active, leaves[2], sc,
                                          cfg, n_slots, tex,
                                          test_ray=test_ray)
            pairs = [(p[k], g) for k, g in (
                ("fdir", g_fdir), ("fpos", g_fpos), ("start", g_start),
                ("sdir", g_sdir), ("slen", g_slen)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        leaves, [g for _, g in pairs],
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return tuple(grads) + (None,) * 6


def march_scene_diff(origin, direction, active, r_s, sc: Scene,
                     cfg: RenderConfig, n_slots: int = 4,
                     tex: Optional[TextureStack] = None,
                     test_ray: Optional[TestRay] = None, mesh=None,
                     compact: bool = False, backward: str = "pallas"):
    """Differentiable :func:`march_scene`: the forward kernel with its event
    planes, and the adjoint kernel (:func:`march_scene_bwd`) as backward.
    Gradients reach (origin, direction, r_s) at the decisions the forward
    took (which object, capture or escape); status and nhits carry none.
    The scene's geometry gets no gradient through the march: the march reads
    it only in comparisons.  Scene and texture gradients come from the slot
    re-intersection in :func:`render_fast`.  Returns what
    :func:`march_scene` returns.  ``mesh`` and ``compact`` as
    :func:`march_scene`'s: each rank's adjoint runs on its own tile (the
    JAX package falls back to a scan replay under a mesh), and a compacted
    march's on the packed rays.  ``backward``: "pallas" (the JAX package's
    name for its adjoint-kernel mode) takes the adjoint kernel; "replay"
    re-runs the plain march under autograd in the backward (every step's
    values saved: a gradient oracle for small frames)."""
    if backward not in ("pallas", "replay"):
        raise ValueError(f"unknown backward mode {backward!r}")
    if mesh is not None:
        from .sharding import shard_march

        return shard_march(mesh, functools.partial(
            march_scene_diff, sc=sc, cfg=cfg, n_slots=n_slots, tex=tex,
            test_ray=test_ray, compact=compact, backward=backward))(
                origin, direction, active, r_s)
    if compact:
        return compact_march(
            lambda o, d, a: march_scene_diff(o, d, a, r_s, sc, cfg, n_slots,
                                             tex, test_ray,
                                             backward=backward),
            origin, direction, active)
    r_s = _f32(r_s, origin.device)
    fn = _MarchSceneDiff if backward == "pallas" else _MarchSceneReplay
    fdir, fpos, status, nhits, start, sdir, slen = fn.apply(
        origin, direction, r_s, active, sc, cfg, n_slots, tex, test_ray)
    return fdir, fpos, status, _split_slots(start, sdir, slen), nhits


def _sparse_call(sc, cfg, background, tex, r_s, n_slots, overflow, kw, pre):
    """render_fast of a sparse branch's pseudo-image (``pre``: its planes)
    without the crosshair, which the branch adds over the full frame:
    (image, n_overflowed or None)."""
    out = render_fast(sc, None, dataclasses.replace(cfg, crosshair=False),
                      background, tex, r_s, n_slots,
                      "ignore" if overflow == "ignore" else "return",
                      precomputed=pre, **kw)
    return out if overflow != "ignore" else (out, None)


def _sparse_finish(img, planes, cfg, n_over, n_slots, overflow):
    """The crosshair over the full frame (the reference draws it before the
    noise test, frag:845-857), then render_fast's overflow handling."""
    if cfg.crosshair:
        ch = crosshair_mask(planes["u_ndc"], planes["v_ndc"], cfg.width,
                            cfg.height)
        img = img + torch.where(ch[..., None], torch.tensor(
            CROSSHAIR_COLOR, device=img.device), 0.0)
    return _overflow_result(img, n_over, n_slots, overflow)


def _overflow_result(img, n_over, n_slots, overflow):
    if overflow == "ignore":
        return img
    n_over = int(n_over)
    if overflow == "return":
        return img, n_over
    if n_over:
        warnings.warn(f"render_fast: {n_over} rays exceeded n_slots={n_slots} "
                      "recording slots (extra translucent hits dropped; "
                      "raise n_slots)")
    return img


def _radial_dropped(planes, keep):
    """Pixels that render flat whatever the noise (radial rays: the
    reference tests radiality before the noise skip, frag:866-881) although
    the noise mask ``keep`` drops them."""
    o, d = planes["origin"], planes["direction"]
    return physics.is_radial(d, geo.safe_normalize(o)) & ~keep


def _first_true(mask, count: int):
    """The indices of the first ``count`` true entries of the 1-D ``mask``
    in order, padded with mask.numel(): ranks from a cumsum, so no read of
    the host."""
    n = mask.numel()
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.full((count + 1,), n, dtype=torch.int64, device=mask.device)
    out.index_copy_(0, torch.where(mask & (rank < count), rank, count),
                    torch.arange(n, device=mask.device))
    return out[:count]


@functools.lru_cache(maxsize=8)
def _lane_survivors(width: int, height: int, seed: int, percent_black: float,
                    device):
    """The hash mask's kept pixels, a function of the config alone and so
    computed once a config (on the host) and kept on ``device``: (keep
    (H * W,) bool, the kept pixels' ids int64).  Shared: read only."""
    keep = (pixel_hash_rand_np(width, height, seed)
            > np.float32(percent_black)).reshape(-1)
    return (torch.as_tensor(keep, device=device),
            torch.as_tensor(np.nonzero(keep)[0], device=device))


@functools.lru_cache(maxsize=8)
def _tile_survivors(width: int, height: int, seed: int, tile: tuple,
                    percent_black: float, device):
    """The tile mask's kept pixels (H, W) bool and kept tiles' ids (row-major
    tiles), once a config as :func:`_lane_survivors`.  Shared: read only."""
    th, tw = tile
    keep = (tile_hash_rand_np(width, height, seed, (th, tw))
            > np.float32(percent_black))
    ids = np.nonzero(keep[::th, ::tw].reshape(-1))[0]
    return (torch.as_tensor(keep, device=device),
            torch.as_tensor(ids, device=device))


def _render_fast_lane_sparse(sc, cam, cfg, background, tex, r_s, n_slots,
                             overflow, kw):
    """Per-pixel hash noise (the reference's default, percent_black 0.75,
    main.cpp:66, frag:879-881) renders only its surviving pixels.

    The hash mask is a function of the config alone, so the survivors'
    ids are known on the host (``noise.pixel_hash_rand_np``), once a
    config (:func:`_lane_survivors`).  Their rays,
    uv and noise values are taken from the full frame's grid planes, so
    each lane is the full frame's lane, and the whole pipeline (march,
    composition levels, fetches) runs on a dense (rows, 128) pseudo-image
    of them, scattered back over a black frame.  A noise-dropped radial
    pixel still renders flat: such pixels ride 4 slack tiles of 8 x 128
    lanes, the first tiles that hold one (radiality is an exact-alignment
    test, a few pixels in a tile or two); one past the slack renders black,
    the deviation the JAX package documents.  Kept pixels in a slack tile
    are skipped there (their static lane renders them)."""
    H, W = cfg.height, cfg.width
    dev = background.data.device
    keep, static_ids = _lane_survivors(W, H, cfg.noise_seed,
                                       cfg.percent_black, dev)
    n_static = static_ids.shape[0]
    th, tw, slack = 8, 128, 4
    ntw = W // tw
    planes = grid_planes(cam, cfg, dev)
    rad = _radial_dropped(planes, keep.reshape(H, W))
    tiles = _first_true(rad.reshape(H // th, th, ntw, tw).any(3).any(1)
                        .reshape(-1), slack)
    within = (torch.arange(th, device=dev)[:, None] * W
              + torch.arange(tw, device=dev)[None, :]).reshape(1, -1)
    dyn = (tiles // ntw * th * W + tiles % ntw * tw)[:, None] + within
    dyn = torch.where((tiles < (H // th) * ntw)[:, None], dyn, H * W)
    n_dyn = slack * th * tw
    rows = -(-(n_static + n_dyn) // 128)
    cap = -(-rows // 16) * 16 * 128  # rows a multiple of 16
    ids = torch.cat([static_ids, dyn.reshape(-1),
                     torch.full((cap - n_static - n_dyn,), H * W,
                                dtype=torch.int64, device=dev)])
    pid = torch.clamp(ids, max=H * W - 1)
    is_dyn = torch.arange(cap, device=dev) >= n_static
    # Filler lanes and kept pixels of the slack get rnd 0: noise-skipped,
    # no march work, no hit counted twice.
    skip = (ids == H * W) | (is_dyn & keep[pid])
    pre = {name: x.reshape((H * W,) + x.shape[2:]).index_select(0, pid)
           .reshape((cap // 128, 128) + x.shape[2:])
           for name, x in planes.items()}
    pre["rnd"] = torch.where(skip.reshape(cap // 128, 128), 0.0, pre["rnd"])
    img_d, n_over = _sparse_call(sc, cfg, background, tex, r_s, n_slots,
                                 overflow, kw, pre)
    dest = torch.where(skip, H * W, ids)
    img = torch.zeros((H * W + 1, 4), device=dev).index_copy(
        0, dest, img_d.reshape(cap, 4))[:H * W].reshape(H, W, 4)
    return _sparse_finish(img, planes, cfg, n_over, n_slots, overflow)


def _render_fast_tile_sparse(sc, cam, cfg, background, tex, r_s, n_slots,
                             overflow, kw):
    """Tile noise (``noise_mode="tile"``) renders only its surviving tiles.

    Which tiles the mask kills is a function of the config alone
    (``noise.tile_hash_rand_np``), so the pipeline runs on a dense
    pseudo-image of the kept tiles, taken from the full frame's grid
    planes, and scatters them back.  Noise-dropped tiles that hold a radial
    pixel (which renders flat whatever the noise) ride 16 slack tiles, the
    first such tiles; one past the slack renders black, as in the JAX
    package."""
    H, W = cfg.height, cfg.width
    th, tw = cfg.noise_tile
    nth, ntw = H // th, W // tw
    nt = nth * ntw
    slack = 16
    dev = background.data.device
    keep_px, static_ids = _tile_survivors(W, H, cfg.noise_seed, (th, tw),
                                          cfg.percent_black, dev)
    planes = grid_planes(cam, cfg, dev)

    def tiled(x):
        x = x.reshape((nth, th, ntw, tw) + x.shape[2:]).transpose(1, 2)
        return x.reshape((nt, th, tw) + x.shape[4:])

    rad = tiled(_radial_dropped(planes, keep_px)).any(2).any(1)
    ids = torch.cat([static_ids, _first_true(rad, slack)])
    valid = ids < nt
    capk = ids.shape[0]
    pre = {name: tiled(x).index_select(0, torch.clamp(ids, max=nt - 1))
           .reshape((capk * th, tw) + x.shape[2:])
           for name, x in planes.items()}
    # Fill rows of the slack get rnd 0: every lane noise-skipped.
    pre["rnd"] = torch.where(valid.repeat_interleave(th)[:, None],
                             pre["rnd"], 0.0)
    img_d, n_over = _sparse_call(sc, cfg, background, tex, r_s, n_slots,
                                 overflow, kw, pre)
    img = torch.zeros((nt + 1, th, tw, 4), device=dev).index_copy(
        0, torch.where(valid, ids, nt), img_d.reshape(capk, th, tw, 4))[:nt]
    img = img.reshape(nth, ntw, th, tw, 4).transpose(1, 2).reshape(H, W, 4)
    return _sparse_finish(img, planes, cfg, n_over, n_slots, overflow)


def render_fast(
    sc: Scene,
    cam,
    cfg: RenderConfig,
    background: Texture,
    tex: Optional[TextureStack] = None,
    r_s=1.0,
    n_slots: int = 4,
    overflow: str = "warn",
    *,
    opaque_stop: bool = True,
    test_ray=None,
    mesh=None,
    differentiable: bool = False,
    precomputed=None,
    compact_slots="auto",
    atlas=None,
    skip_empty_slots: bool = False,
):
    """Full-scene frame: :func:`march_scene` + K-slot composition, (H, W, 4)
    RGBA on the device of ``background``.

    ``overflow`` reports rays that crossed more than ``n_slots`` hits (their
    extra hits are dropped): "warn" warns, "return" returns
    ``(image, n_overflowed)``, "ignore" does neither.  ``opaque_stop`` lets
    the march stop at provably opaque primitives.  ``differentiable=True``
    marches through :func:`march_scene_diff` (the adjoint kernel as its
    backward) and composes with torch autograd, so gradients reach ``r_s``,
    the camera's tensors, the background texels and the texture stack
    (through its mips, which a trilinear frame builds from it); a stack
    that requires grad gives the march no opaque stop, as a traced stack
    does in the JAX package.  ``cfg.texture_filter="trilinear"`` samples
    the textures' mips (built here where a texture carries none) at a
    screen-space LOD in every pass.  ``test_ray`` (a
    :class:`intersect.TestRay`) draws the debug tubes: they ride the march
    kernel's cylinder table and the composition's re-intersection.

    A bilinear frame composes through ``compose.compose_atlas`` with the
    fetch atlas ``atlas`` (default: ``textures.build_atlas_cached`` of
    (background, tex), built once for a pair of textures); the texels get
    gradients through an atlas that requires grad (one built from texels
    that do), and are held constant otherwise.  ``compact_slots``: "auto"
    (default) or a sequence of per-pass capacities run the composition's
    trailing levels on the 8 x 128 tiles that still have work (forced off
    under ``mesh``; the capacities are the JAX package's, which its
    bilinear levels do not read); None runs every level on the whole
    frame.  A trilinear frame composes with the per-slot pass loop, which
    skips a slot no lane takes whatever ``skip_empty_slots`` says (the JAX
    package keeps that skip off by default for its TPU gathers' sake).

    Hash noise (``noise_mode="hash"``) on a curved bilinear frame of a
    multiple of 8 rows and 128 columns and at least 64 such tiles renders
    only its surviving pixels, and tile noise whose tiles divide the frame
    (at least 16 of them) only its surviving tiles (see
    ``_render_fast_lane_sparse``, ``_render_fast_tile_sparse``), unless
    ``compact_slots`` is None or a ``mesh`` or ``precomputed`` is given.

    ``mesh`` (a ``DeviceMesh``) marches each rank's tile of the frame
    (:func:`march_scene` with ``mesh=``) and composes the full frame on
    every rank.  ``precomputed``: a dict of ``origin``, ``direction``
    (batch + (3,)), ``u_ndc``, ``v_ndc`` and ``rnd`` (batch-shaped), the
    part of the frame's grid quantities (``kernel.grid_planes``) that this
    call renders, in place of the camera's (``cam`` may be None): the
    tile-sharding hook (``sharding.make_tile_render``)."""
    if overflow not in ("warn", "return", "ignore"):
        raise ValueError(f"unknown overflow mode {overflow!r}")
    if cfg.texture_filter not in ("bilinear", "trilinear"):
        raise ValueError(f"unknown texture_filter {cfg.texture_filter!r}")
    trilinear = cfg.texture_filter == "trilinear"
    H, W = cfg.height, cfg.width
    sparse_ok = (precomputed is None and mesh is None and not trilinear
                 and cfg.percent_black > 0.0 and cfg.raytrace_type == CURVED
                 and compact_slots is not None)
    kw = dict(opaque_stop=opaque_stop, test_ray=test_ray,
              differentiable=differentiable, compact_slots=compact_slots,
              atlas=atlas, skip_empty_slots=skip_empty_slots)
    if (sparse_ok and cfg.noise_mode == "hash" and H % 8 == 0
            and W % 128 == 0 and H * W >= 64 * 8 * 128):
        return _render_fast_lane_sparse(sc, cam, cfg, background, tex, r_s,
                                        n_slots, overflow, kw)
    th, tw = cfg.noise_tile
    if (sparse_ok and cfg.noise_mode == "tile" and H % th == 0
            and W % tw == 0 and H * W >= 16 * th * tw):
        return _render_fast_tile_sparse(sc, cam, cfg, background, tex, r_s,
                                        n_slots, overflow, kw)
    dev = background.data.device
    r_s = torch.as_tensor(r_s, dtype=torch.float32, device=dev)
    if precomputed is None:
        precomputed = grid_planes(cam, cfg, dev)
    px = pixel_masks(precomputed, cfg)
    origin, direction = px["origin"], px["direction"]
    flat_px, march_px = px["flat_px"], px["march_px"]
    batch = flat_px.shape
    if trilinear:
        background, tex = ensure_mips(background, tex)

    if cfg.raytrace_type != FLAT:
        march = march_scene_diff if differentiable else march_scene
        fdir, fpos, status, slots, nhits = march(
            origin, direction, march_px, r_s, sc, cfg, n_slots=n_slots,
            tex=tex if opaque_stop else None, test_ray=test_ray, mesh=mesh)
    else:
        fdir, fpos = direction, origin
        status = torch.full(batch, STATUS_ESCAPED, device=dev)
        slots = []
        nhits = torch.zeros(batch, device=dev)

    inputs = _composition_inputs(px, fdir, fpos, status, slots, r_s, cfg)
    if not trilinear:
        if atlas is None:
            atlas = build_atlas_cached(background, tex)
        color, _, _ = compose_atlas(
            sc, tex, atlas, r_s, test_ray=test_ray,
            compact_tiles=compact_slots is not None and mesh is None,
            frozen_texels=not atlas.data.requires_grad, **inputs)
    else:
        color = _compose_passes(sc, tex, background, r_s, test_ray, **inputs)
    img = px["base"] + color
    if overflow == "ignore":
        return img
    return _overflow_result(img, (nhits > float(n_slots)).sum(), n_slots,
                            overflow)


def _composition_inputs(px, fdir, fpos, status, slots, r_s,
                        cfg: RenderConfig):
    """The composition's per-lane inputs (``compose.compose_atlas``'s
    keywords) from a frame's pixel masks ``px`` (``kernel.pixel_masks``)
    and its march's final direction and position, status and slots."""
    origin, direction = px["origin"], px["direction"]
    flat_px, march_px = px["flat_px"], px["march_px"]
    batch = flat_px.shape
    use_pos = torch.where(flat_px[..., None], origin, fpos)
    use_dir = torch.where(flat_px[..., None], direction, fdir)
    needs_far = flat_px | (march_px & (status == STATUS_FLAT_FINISH))
    recs = [slen > 0.0 for _, _, slen in slots]
    # A lane's first free slot is its number of recorded slots (the march
    # fills slots in order).
    n_rec = torch.zeros(batch, dtype=torch.int32, device=flat_px.device)
    for r in recs:
        n_rec = n_rec + r.to(torch.int32)
    soft = cfg.horizon_softness > 0.0
    if soft:
        alpha_curved, alpha_flat = soft_shadow_alphas(
            origin, direction, px["normal_vec0"], use_pos, use_dir, r_s,
            cfg.horizon_softness)
        # Straight rays (flat pixels and far-field continuations) use the
        # straight-line impact parameter.
        bg_scale = (1.0 - torch.where(needs_far, alpha_flat,
                                      alpha_curved))[..., None]
    else:
        bg_scale = torch.ones(batch + (1,), device=flat_px.device)
    bgu, bgv = equirect_uv(use_dir)
    # Flat pixels take part through their far ray, folded into slot 0.
    return dict(slots=slots, recs=recs, n_rec=n_rec, needs_far=needs_far,
                use_pos=use_pos, use_dir=use_dir, bgu=bgu, bgv=bgv,
                bg_hard=flat_px | (march_px & (status != STATUS_CAPTURED)),
                bg_scale=bg_scale, soft=soft,
                cap_drop=march_px & (status == STATUS_CAPTURED),
                open_init=march_px | flat_px)


def _compose_passes(sc, tex, background, r_s, test_ray, *, slots, recs,
                    n_rec, needs_far, use_pos, use_dir, bg_hard, bg_scale,
                    soft, cap_drop, open_init, **_):
    """The trilinear frame's composition: the per-slot pass loop over the
    whole grid (its LOD needs the image's neighbours), each pass skipped
    when no lane takes it (one read of the host a pass)."""
    open_ = open_init
    batch = open_.shape
    dev = open_.device
    color = torch.zeros(batch + (4,), device=dev)
    captured_shaded = torch.zeros(batch, dtype=torch.bool, device=dev)
    unit_x = torch.tensor([1.0, 0.0, 0.0], device=dev)
    zeros3 = torch.zeros(batch + (3,), device=dev)

    def slot_pass(eff, start, sdir, slen, rec, fold):
        """Re-intersect and shade one slot (or the folded far ray) and add it
        to the lanes that are still open."""
        nonlocal color, captured_shaded, open_
        if not bool(eff.any()):
            return  # nothing to add: the pass would change no lane
        safe_dir = torch.where(fold[..., None], use_dir,
                               torch.where(rec[..., None], sdir, unit_x))
        safe_start = torch.where(fold[..., None], use_pos, start)
        # Recorded windows inflate slightly: the kernel's f32 lambda and
        # this recomputation differ by ~1 ulp, and a recorded hit must not
        # fall off the end of its own segment.
        window = torch.where(fold, -1.0,
                             torch.where(rec, slen * 1.0001 + 1e-5, 1.0))
        hit = intersect_scene(safe_start, safe_dir, window, sc, r_s, test_ray)
        rgba = shade(hit, -safe_dir, sc, tex, trilinear=True)
        take = eff & open_ & hit.valid
        opaque_take = take & (rgba[..., 3] == 1.0)
        color = color + torch.where(take[..., None], rgba, 0.0)
        captured_shaded = captured_shaded | (
            opaque_take & (hit.obj_type == OBJECT_TYPE_SPECIAL))
        open_ = open_ & ~opaque_take

    for k, ((start, sdir, slen), rec) in enumerate(zip(slots, recs)):
        fold_k = needs_far & (n_rec == k)
        slot_pass(rec | fold_k, start, sdir, slen, rec, fold_k)
    # Residual far rays: every slot recorded and a far-field continuation,
    # or FLAT mode, where there are no slots to fold into.
    residual = needs_far & (n_rec >= len(slots))
    slot_pass(residual, zeros3, zeros3, torch.zeros(batch, device=dev),
              torch.zeros(batch, dtype=torch.bool, device=dev), residual)

    # Sky for every lane still open, except captured rays: a capture is
    # opaque black even when its slot was dropped by overflow.
    march_bg = open_ & bg_hard
    bg = get_background(background, use_dir, trilinear=True)
    if soft:
        captured_m = captured_shaded | (cap_drop & open_)
        return color + torch.where((march_bg | captured_m)[..., None],
                                   bg * bg_scale, 0.0)
    return color + torch.where(march_bg[..., None], bg, 0.0)


def render_fast_auto(sc: Scene, cam, cfg: RenderConfig, background: Texture,
                     tex: Optional[TextureStack] = None, r_s=1.0, *,
                     start_slots: int = 2, max_slots: int = 8, **kw):
    """:func:`render_fast` with slot escalation: start at ``start_slots``
    and double (up to ``max_slots``) while the march reports dropped hits.
    Returns ``(image, n_slots_used)``."""
    if "n_slots" in kw or "overflow" in kw:
        raise TypeError("render_fast_auto manages n_slots/overflow itself")
    n = int(start_slots)
    while True:
        img, n_over = render_fast(sc, cam, cfg, background, tex, r_s,
                                  n_slots=n, overflow="return", **kw)
        if n >= int(max_slots) or n_over == 0:
            return img, n
        n = min(2 * n, int(max_slots))
