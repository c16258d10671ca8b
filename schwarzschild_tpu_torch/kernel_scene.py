"""Full-scene march and frame (counterpart of ``schwarzschild_tpu.kernel_scene``).

``march_scene`` is the wrapper of the CUDA kernel ``march_scene_kernel``
(csrc/march.cu), which replaces the Pallas kernel ``_scene_march_kernel``:
the geodesic march of kernel.py plus, per segment, validity-only tests
against the horizon and every scene-table row; each hit segment (start,
direction, length) is recorded into the next of K slots, every hit is
counted, and the ray stops when the horizon (status 1) or a provably opaque
primitive (status 4) is the segment's closest hit.  ``march_scene_torch``
is its plain version.

``render_fast`` composes those records into the frame with the per-slot
pass loop of the JAX package (kernel_scene.py:1831-1889 there): each slot
re-intersected and shaded in order, added together, cut at the first
opaque hit; the far-field or flat ray folded into the first free slot; a
residual far pass; then the sky.  The JAX package's tile-compacted fetch
atlas (compose.py) and its lane- and tile-sparse branches exist for the
TPU's per-index gather cost and are not part of this package.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from . import _ext
from . import geometry as geo
from .config import FLAT, RenderConfig
from .intersect import intersect_scene
from .kernel import (  # noqa: F401  (statuses and noise_field are public here too)
    STATUS_CAPTURED,
    STATUS_ESCAPED,
    STATUS_MARCHING,
    _advance,
    _dot3,
    _far_field,
    _final_status,
    _guard,
    _init_march,
    _rk4_segment,
    _sphere_entry,
    check_rays,
    march_scalars,
    noise_field,
    pixel_setup,
    reject_unported,
    soft_shadow_alphas,
)
from .scene import OBJECT_TYPE_SPECIAL, Scene
from .shading import get_background, shade
from .textures import Texture, TextureStack

STATUS_FLAT_FINISH = 3.0
STATUS_HIT_OPAQUE = 4.0

# Table names in the order the kernel reads them, with their row widths
# (kSphereCols ... kRectCols in csrc/march.cu).
TABLE_COLUMNS = (("spheres", 5), ("planes", 7), ("disks", 8), ("hollow", 9),
                 ("cylinders", 15), ("rects", 15))

_PRIMITIVES = ("spheres", "planes", "disks", "hollow_disks", "cylinders",
               "rectangles")


def _np(x):
    return x.detach().cpu().numpy()


def _opaque_flags(sc: Scene, tex: Optional[TextureStack]):
    """Per-primitive "provably opaque at every sample" flags, in numpy
    (kernel_scene.py:118-179 of the JAX package): material alpha exactly 1,
    no texture or a texture whose whole padded layer has alpha 1, and
    double-sided normals."""
    m = sc.materials
    color_a = _np(m.color)[:, 3]
    tex_idx = _np(m.texture_index)
    dbl = _np(m.double_sided_normals)
    tmin = None if tex is None else _np(tex.data[..., 3].amin(dim=(1, 2)))

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


def _pack_scene_smem(sc: Scene, tex: Optional[TextureStack] = None):
    """Scene -> dict of float32 (N, F) numpy tables, each with a trailing
    "provably opaque" column (all zero without ``tex``), the columns of the
    JAX package's tables (kernel_scene.py:182-270 there; test-ray tube rows
    are not available here):

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


def _segment_min_dist(tables, px, py, pz, sdx, sdy, sdz, seg_len):
    """Plain version of the kernel's segment_min_dist: the closest table hit
    lambda within [0, seg_len] (inf if none) and the closest over the rows
    flagged provably opaque."""
    inf = float("inf")
    best = torch.full_like(px, inf)
    best_opq = torch.full_like(px, inf)

    def within(lam):
        return (lam >= 0.0) & (lam <= seg_len)

    def fold(ok, lam, opq):
        nonlocal best, best_opq
        cand = torch.where(ok, lam, inf)
        best = torch.minimum(best, cand)
        if opq > 0.5:
            best_opq = torch.minimum(best_opq, cand)

    def plane_lam(t0, t1, t2, nxs, nys, nzs):
        denom = _dot3(nxs, nys, nzs, sdx, sdy, sdz)
        num = nxs * (t0 - px) + nys * (t1 - py) + nzs * (t2 - pz)
        lam = num / _guard(denom)
        return (torch.abs(denom) >= geo.EPSILON) & within(lam), lam

    def sq32(x):  # an f32 product of two table values, as the kernel forms it
        return float(np.float32(x) * np.float32(x))

    for r in tables.get("spheres", ()):
        t = [float(x) for x in r]
        ok, lam = _sphere_entry(px, py, pz, sdx, sdy, sdz, sq32(r[3]),
                                t[0], t[1], t[2])
        fold(ok & within(lam), lam, t[4])
    for r in tables.get("planes", ()):
        t = [float(x) for x in r]
        fold(*plane_lam(*t[:6]), t[6])
    for r in tables.get("disks", ()):
        t = [float(x) for x in r]
        ok, lam = plane_lam(*t[:6])
        hx = px + lam * sdx - t[0]
        hy = py + lam * sdy - t[1]
        hz = pz + lam * sdz - t[2]
        fold(ok & (_dot3(hx, hy, hz, hx, hy, hz) <= t[6]), lam, t[7])
    for r in tables.get("hollow", ()):
        t = [float(x) for x in r]
        ok, lam = plane_lam(*t[:6])
        hx = px + lam * sdx - t[0]
        hy = py + lam * sdy - t[1]
        hz = pz + lam * sdz - t[2]
        sq = _dot3(hx, hy, hz, hx, hy, hz)
        fold(ok & (sq >= t[6]) & (sq <= t[7]), lam, t[8])
    for r in tables.get("cylinders", ()):
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
        fold((disc >= 0.0) & (in1 | in2) & within(lam), lam, t[14])
    for r in tables.get("rects", ()):
        t = [float(x) for x in r]
        ok, lam = plane_lam(t[0], t[1], t[2], t[6], t[7], t[8])
        hx = px + lam * sdx - t[0]
        hy = py + lam * sdy - t[1]
        hz = pz + lam * sdz - t[2]
        alpha = _dot3(t[3], t[4], t[5], hx, hy, hz)
        beta = _dot3(t[9], t[10], t[11], hx, hy, hz)
        ok = (ok & (alpha >= 0.0) & (alpha <= t[12]) & (beta >= 0.0)
              & (beta <= t[13]))
        fold(ok, lam, t[14])
    return best, best_opq


def _split_slots(start, sdir, slen):
    return [(start[k], sdir[k], slen[k]) for k in range(start.shape[0])]


def march_scene_torch(origin, direction, active, r_s, sc: Scene,
                      cfg: RenderConfig, n_slots: int = 4,
                      tex: Optional[TextureStack] = None):
    """Plain version of the scene march: (final_dir, final_pos, status,
    slots, nhits), slots a list of K (start (...,3), dir (...,3), len)."""
    dev = origin.device
    r_s = torch.as_tensor(r_s, dtype=torch.float32, device=dev)
    rs2 = r_s * r_s
    max_angle, u_f, far_r2 = march_scalars(cfg)
    tables = _pack_scene_smem(sc, tex)
    s = _init_march(origin, direction, active)
    nh = torch.zeros(active.shape, device=dev)
    start = torch.zeros((n_slots,) + origin.shape, device=dev)
    sdir = torch.zeros_like(start)
    slen = torch.zeros((n_slots,) + active.shape, device=dev)
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
        nh = torch.where(any_hit, nh + 1.0, nh)

        status = torch.where(captured, STATUS_CAPTURED, status)
        status = torch.where(opq_closest, STATUS_HIT_OPAQUE, status)
        live = live & ~captured & ~opq_closest
        _advance(s, live | captured | opq_closest, seg)
        s["status"], s["live"] = status, live
    return (torch.stack([s["dx"], s["dy"], s["dz"]], -1),
            torch.stack([s["px"], s["py"], s["pz"]], -1),
            _final_status(s), _split_slots(start, sdir, slen), nh)


def march_scene(origin, direction, active, r_s, sc: Scene, cfg: RenderConfig,
                n_slots: int = 4, tex: Optional[TextureStack] = None):
    """Scene march of (..., 3) rays: (final_dir, final_pos, status, slots,
    nhits); ``nhits`` counts every hit (uncapped), so ``nhits > n_slots``
    flags rays whose extra hits were dropped.  ``tex`` (the stack the hits
    will be shaded with) enables the in-kernel stop on provably opaque
    primitives.

    A CUDA tensor launches ``march_scene_kernel`` (counted in
    ``march_scene.launches``); a CPU tensor runs :func:`march_scene_torch`."""
    check_rays(origin, direction, active)
    if n_slots < 0:
        raise ValueError(f"n_slots must be >= 0, got {n_slots}")
    if origin.device.type == "cpu":
        return march_scene_torch(origin, direction, active, r_s, sc, cfg,
                                 n_slots, tex)
    dev = origin.device
    tables = _pack_scene_smem(sc, tex)
    for name, width in TABLE_COLUMNS:  # the kernel's fixed row layout
        if name in tables and tables[name].shape[1] != width:
            raise ValueError(f"{name} table rows have "
                             f"{tables[name].shape[1]} columns, not {width}")
    rows = [tables[name].shape[0] if name in tables else 0
            for name, _ in TABLE_COLUMNS]
    flat = [tables[name].reshape(-1) for name, _ in TABLE_COLUMNS
            if name in tables]
    buf = torch.as_tensor(np.concatenate(flat) if flat
                          else np.zeros(1, np.float32), device=dev)

    fdir = torch.empty_like(origin)
    fpos = torch.empty_like(origin)
    status = torch.empty(active.shape, dtype=torch.float32, device=dev)
    nhits = torch.empty_like(status)
    # The kernel writes a slot only where a ray records one: zero the rest.
    start = torch.zeros((max(n_slots, 1),) + origin.shape, device=dev)
    sdir = torch.zeros_like(start)
    slen = torch.zeros((max(n_slots, 1),) + active.shape, device=dev)
    n = active.numel()
    if n:
        max_angle, u_f, far_r2 = march_scalars(cfg)
        lib = _ext.library()
        rc = lib.march_scene_launch(
            _ext.ptr(origin), _ext.ptr(direction), _ext.ptr(active),
            _ext.ptr(buf), *rows, _ext.ptr(fdir), _ext.ptr(fpos),
            _ext.ptr(status), _ext.ptr(nhits), _ext.ptr(start),
            _ext.ptr(sdir), _ext.ptr(slen), n_slots, n,
            float(np.float32(float(r_s))), cfg.max_steps, max_angle, u_f,
            far_r2, _ext.stream_ptr(dev))
        _ext.check(rc, "march_scene")
        march_scene.launches += 1
    slots = _split_slots(start[:n_slots], sdir[:n_slots], slen[:n_slots])
    return fdir, fpos, status, slots, nhits


march_scene.launches = 0


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
    compact_slots=None,
    atlas=None,
):
    """Full-scene frame: :func:`march_scene` + K-slot composition, (H, W, 4)
    RGBA on the device of ``background``.

    ``overflow`` reports rays that crossed more than ``n_slots`` hits (their
    extra hits are dropped): "warn" warns, "return" returns
    ``(image, n_overflowed)``, "ignore" does neither.  ``opaque_stop`` lets
    the march stop at provably opaque primitives.  The remaining keywords
    name options of the JAX package that this package does not have; any
    value but the default raises NotImplementedError."""
    if overflow not in ("warn", "return", "ignore"):
        raise ValueError(f"unknown overflow mode {overflow!r}")
    reject_unported(test_ray=test_ray, mesh=mesh,
                    differentiable=differentiable, precomputed=precomputed,
                    compact_slots=compact_slots, atlas=atlas)
    dev = background.data.device
    r_s = torch.as_tensor(r_s, dtype=torch.float32, device=dev)
    px = pixel_setup(cam, cfg, dev)
    origin, direction = px["origin"], px["direction"]
    flat_px, march_px = px["flat_px"], px["march_px"]
    batch = flat_px.shape

    if cfg.raytrace_type != FLAT:
        fdir, fpos, status, slots, nhits = march_scene(
            origin, direction, march_px, r_s, sc, cfg, n_slots=n_slots,
            tex=tex if opaque_stop else None)
    else:
        fdir, fpos = direction, origin
        status = torch.full(batch, STATUS_ESCAPED, device=dev)
        slots = []
        nhits = torch.zeros(batch, device=dev)

    use_pos = torch.where(flat_px[..., None], origin, fpos)
    use_dir = torch.where(flat_px[..., None], direction, fdir)
    needs_far = flat_px | (march_px & (status == STATUS_FLAT_FINISH))
    color = torch.zeros(batch + (4,), device=dev)
    # Lanes still accumulating (no opaque hit yet); flat pixels take part
    # through their far ray, folded into slot 0.
    open_ = march_px | flat_px
    captured_shaded = torch.zeros(batch, dtype=torch.bool, device=dev)
    recs = [slen > 0.0 for _, _, slen in slots]
    # A lane's first free slot is its number of recorded slots (the march
    # fills slots in order).
    n_rec = torch.zeros(batch, dtype=torch.int32, device=dev)
    for r in recs:
        n_rec = n_rec + r.to(torch.int32)
    unit_x = torch.tensor([1.0, 0.0, 0.0], device=dev)
    zeros3 = torch.zeros(batch + (3,), device=dev)

    soft = cfg.horizon_softness > 0.0
    if soft:
        alpha_curved, alpha_flat = soft_shadow_alphas(
            origin, direction, px["normal_vec0"], use_pos, use_dir, r_s,
            cfg.horizon_softness)
        # Straight rays (flat pixels and far-field continuations) use the
        # straight-line impact parameter.
        bg_scale = (1.0 - torch.where(needs_far, alpha_flat,
                                      alpha_curved))[..., None]
    bg_hard = flat_px | (march_px & (status != STATUS_CAPTURED))

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
        hit = intersect_scene(safe_start, safe_dir, window, sc, r_s)
        rgba = shade(hit, -safe_dir, sc, tex)
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
    bg = get_background(background, use_dir)
    if soft:
        captured_m = captured_shaded | (
            march_px & (status == STATUS_CAPTURED) & open_)
        color = color + torch.where((march_bg | captured_m)[..., None],
                                    bg * bg_scale, 0.0)
    else:
        color = color + torch.where(march_bg[..., None], bg, 0.0)

    img = px["base"] + color
    if overflow == "ignore":
        return img
    n_over = int((nhits > float(n_slots)).sum())
    if overflow == "return":
        return img, n_over
    if n_over:
        warnings.warn(f"render_fast: {n_over} rays exceeded n_slots={n_slots} "
                      "recording slots (extra translucent hits dropped; "
                      "raise n_slots)")
    return img


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
