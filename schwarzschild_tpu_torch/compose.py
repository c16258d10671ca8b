"""Slot composition for the fast renderer: the tile-compacted level engine
(counterpart of ``schwarzschild_tpu.compose``).

The composition problem (black_hole.frag:930-935): per lane, shade its
recorded hit segments in order, add them up, stop at the first opaque hit,
and add the background if nothing opaque ended the ray.

Level k composes each lane's k-th contribution (slot k, the far-field or
flat ray folded in at the lane's first free slot, or the residual far ray
once every slot is taken) with ONE merged fetch a lane from the atlas
(``textures.FetchAtlas``): its hit's texel if the hit is textured, else its
sky texel, which the lane consumes at once when its contributions end at
this level.  Level 0 runs on the whole frame.  Levels 1.. run on the 8 x 128
tiles that still hold a pending lane, as a dense domain of a fixed number
of tiles; a level whose pending tiles exceed that number runs on the whole
frame instead, and a level with no pending lane is skipped.  A last cleanup
level pays the sky of lanes whose last fetch was a texel (translucent
textured paths) and, with a soft horizon, of captured lanes whose slot was
dropped.

The schedule: each level that runs ends with the per-tile masks of the
later levels that would find a lane of the tile pending (``pending()``).  A
level changes only the lanes of its tiles, so the masks of the others stay
true, and ONE read of the host after each level that runs decides every
level until the next that runs: a frame whose lanes all end at level 0
reads the host once.

On CUDA tensors from which no gradient is asked (grad disabled, or nothing
the composition reads requires grad), the whole composition is one launch
of ``compose_levels_kernel`` (csrc/compose.cu, :func:`compose_levels`): a
thread takes its lane through level 0 and every later level that finds it
pending, with no schedule and no read of the host, bit-equal to the plain
version.  Otherwise the plain version :func:`_compose_atlas_torch` runs:
the schedule above in torch operations, differentiable through torch
autograd (the planes of a compacted level gathered into one array, one
gather, and scattered back, one scatter).

The per-lane arithmetic is the per-slot pass loop's (``kernel_scene.
render_fast``'s trilinear path) with the atlas in place of the samplers,
and a compacted level's lanes equal the full-frame level's bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _ext
from .intersect import intersect_scene, tube_frame, tube_segments
from .scene import OBJECT_TYPE_SPECIAL, Scene
from .shading import _concrete_none_negative, _gather, _shade_lit, texel_request
from .textures import (FetchAtlas, SourceMemo, atlas_fetch,
                       atlas_fetch_frozen)

# The compacted levels' tile: 8 rows of 128 lanes.
TILE_H, TILE_W = 8, 128


def _pack_planes(P, keys):
    """The named planes of ``P`` as one (H, W, F) float32 array (bools and
    ints ride as float32: small exact integers) and the recipe to unpack
    it: one gather or scatter moves them all."""
    cols, recipe, ofs = [], [], 0
    for k in keys:
        x = P[k]
        c = 1 if x.dim() == 2 else x.shape[-1]
        cols.append(x.to(torch.float32).reshape(x.shape[:2] + (c,)))
        recipe.append((k, ofs, c, x.dtype, x.dim()))
        ofs += c
    return torch.cat(cols, dim=-1), recipe


def _unpack_planes(packed, recipe):
    """Inverse of :func:`_pack_planes`; every plane contiguous, as the
    full-frame planes are (the CPU's vectorized loops round a lane the
    same way only on the same memory layout)."""
    out = {}
    for k, ofs, c, dtype, ndim in recipe:
        x = packed[..., ofs:ofs + c]
        if ndim == 2:
            x = x[..., 0]
        out[k] = x.to(dtype).contiguous()
    return out


def _tile_lanes(ids, ntw: int, width: int):
    """The flat lanes of tiles ``ids`` (row-major tile ids of a frame
    ``width`` lanes wide), tile by tile: the order of a (len(ids) * 8, 128)
    domain."""
    dev = ids.device
    within = (torch.arange(TILE_H, device=dev)[:, None] * width
              + torch.arange(TILE_W, device=dev)[None, :]).reshape(1, -1)
    base = (ids // ntw) * (TILE_H * width) + (ids % ntw) * TILE_W
    return (base[:, None] + within).reshape(-1)


def _tensors(tree):
    """Every tensor of a tree of tuples (NamedTuples included) and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def _needs_grad(*trees) -> bool:
    """Whether autograd would record a composition of these inputs."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(trees))


def compose_atlas(
    sc: Scene,
    tex,
    atlas: FetchAtlas,
    r_s,
    *,
    slots,
    recs,
    n_rec,
    needs_far,
    use_pos,
    use_dir,
    bgu,
    bgv,
    bg_hard,
    bg_scale,
    soft: bool,
    cap_drop,
    open_init,
    test_ray=None,
    compact_tiles: bool = True,
    max_levels: Optional[int] = None,
    return_pend: bool = False,
    frozen_texels: bool = False,
):
    """Run every composition level; returns (color, open, captured_shaded).

    ``slots``: the march's K (start, dir, length) records; ``recs`` their
    recorded masks (the levels read the lengths); ``n_rec`` each lane's
    recorded count (int32); ``needs_far`` the lanes whose far-field or flat
    ray folds in at slot ``n_rec``; ``use_pos``/``use_dir`` that ray;
    ``bgu``, ``bgv`` the sky's uv; ``bg_hard`` the lanes owed the sky when
    open at their end; ``bg_scale`` ((..., 1)) the sky's weight (ones with
    a hard horizon, already in the returned colour); ``cap_drop`` the lanes
    captured by the march whose capture slot overflow dropped (with a soft
    horizon they still owe scaled sky); ``open_init`` the lanes that take
    part.

    ``compact_tiles``: levels 1.. on the pending 8 x 128 tiles (frames of
    a multiple of 8 rows and 128 columns, 4 tiles or more), at most
    max(tiles // 4, 4) tiles at level 1, // 16 at level 2, // 32 after;
    False runs every level on the whole frame.  ``max_levels`` cuts the
    level count (default K + 2).  ``return_pend`` also returns each tiled
    level's pending-tile count (a CPU tensor) and its capacity (a tuple).
    ``frozen_texels`` fetches with :func:`textures.atlas_fetch_frozen`
    (gradients reach the uv only), right when the atlas does not depend
    on what is differentiated.

    CUDA tensors from which no gradient is asked (``torch.is_grad_enabled``
    off, or no input requiring grad) compose with one launch of
    ``compose_levels_kernel`` (:func:`compose_levels`), which has no tile
    schedule (``compact_tiles`` is moot there, and ``return_pend`` raises);
    every other input with the plain version :func:`_compose_atlas_torch`.
    The two give the same lanes bit for bit."""
    kw = dict(slots=slots, n_rec=n_rec, needs_far=needs_far,
              use_pos=use_pos, use_dir=use_dir, bgu=bgu, bgv=bgv,
              bg_hard=bg_hard, bg_scale=bg_scale, soft=soft,
              cap_drop=cap_drop, open_init=open_init, test_ray=test_ray)
    if bgu.device.type == "cuda" and not _needs_grad(
            sc, tex, atlas, r_s, test_ray, slots, use_pos, use_dir, bgu, bgv,
            bg_scale):
        if return_pend:
            raise ValueError("compose_atlas: return_pend reports the plain "
                             "version's tile schedule; the kernel has none")
        return compose_levels(sc, tex, atlas, r_s, max_levels=max_levels,
                              **kw)
    return _compose_atlas_torch(sc, tex, atlas, r_s, recs=recs,
                                compact_tiles=compact_tiles,
                                max_levels=max_levels,
                                return_pend=return_pend,
                                frozen_texels=frozen_texels, **kw)


def _tiling(batch, compact_tiles: bool):
    """(tile rows, tile columns) of a frame whose later levels run on
    their pending tiles, else None."""
    H, W = batch if len(batch) == 2 else (0, 0)
    if (compact_tiles and len(batch) == 2 and H % TILE_H == 0
            and W % TILE_W == 0 and H * W >= 4 * TILE_H * TILE_W):
        return H // TILE_H, W // TILE_W
    return None


def _compose_atlas_torch(sc: Scene, tex, atlas: FetchAtlas, r_s, *,
                         compact_tiles=True, max_levels=None,
                         return_pend=False, **kw):
    """:func:`compose_atlas` in torch operations on any device, with torch
    autograd: the plain version of ``compose_levels_kernel``.  The level
    schedule: level 0 on the whole frame, then each later level that the
    masks say changes a lane, on its pending tiles or the whole frame."""
    tiles = _tiling(tuple(kw["bgu"].shape), compact_tiles)
    n_slots = len(kw["slots"])
    n_levels = n_slots + 2 if max_levels is None else max_levels
    lv = _TorchLevels(sc, tex, atlas, r_s, tiles=tiles, n_levels=n_levels,
                      **kw)
    nt = tiles[0] * tiles[1] if tiles else 0
    # Level 0 always runs on the whole frame (nearly every lane has a
    # contribution or a sky fetch there).  ``read`` is the one read of the
    # host after a level: the masks of the later levels.
    lv.run(0, None)
    m = lv.read()
    n_pends, caps = [], []
    for k in range(1, n_levels):
        pend = m[k]
        if tiles is None:
            if pend.any():
                lv.run(k, None)
                m = lv.read()
            continue
        capt = max(nt // (4 if k == 1 else 16 if k == 2 else 32), 4)
        n_pend = int(pend.sum())
        n_pends.append(n_pend)
        caps.append(capt)
        if n_pend == 0:
            continue  # the level would change no lane
        ids = None  # too many tiles: the whole frame
        if n_pend <= capt:
            # The pending tiles' ids in order; the rows past n_pend keep
            # the fill id nt.
            ids = np.full(capt, nt, np.int64)
            ids[:n_pend] = np.flatnonzero(pend)
        lv.run(k, ids)
        m = lv.read()
    color, open_, captured = lv.result()
    if return_pend:
        return (color, open_, captured,
                torch.tensor(n_pends, dtype=torch.int64), tuple(caps))
    return color, open_, captured


class _TorchLevels:
    """The plain version's levels: ``body`` (level_body) and ``pending``
    over the planes dict ``P`` in torch operations; ``run`` runs one
    level, on the whole frame or on tiles, and ``read`` returns the masks
    of the later pending levels (``masks``)."""

    def __init__(self, sc, tex, atlas, r_s, *, slots, recs, n_rec, needs_far,
                 use_pos, use_dir, bgu, bgv, bg_hard, bg_scale, soft,
                 cap_drop, open_init, test_ray=None, frozen_texels=False,
                 tiles=None, n_levels=None):
        self.sc, self.tex, self.atlas, self.r_s = sc, tex, atlas, r_s
        self.test_ray, self.soft, self.tiles = test_ray, soft, tiles
        self.fetch = atlas_fetch_frozen if frozen_texels else atlas_fetch
        batch = tuple(bgu.shape)
        self.dev = dev = bgu.device
        self.n_slots = n_slots = len(slots)
        self.n_levels = n_slots + 2 if n_levels is None else n_levels
        self.have_stack = tex is not None
        self.nm_on = self.have_stack and not _concrete_none_negative(
            sc.materials.normal_map_index)
        self.unit_x = torch.tensor([1.0, 0.0, 0.0], device=dev)
        # Each lane's last contribution level: slot n_rec - 1, or the far
        # fold at level n_rec (the residual level K when every slot is
        # taken); -1 for a lane with no contribution (pure sky).
        last = torch.where(needs_far, torch.clamp(n_rec, max=n_slots),
                           n_rec - 1)
        P = dict(color=torch.zeros(batch + (4,), device=dev), open=open_init,
                 captured=torch.zeros(batch, dtype=torch.bool, device=dev),
                 bg_done=torch.zeros(batch, dtype=torch.bool, device=dev),
                 n_rec=n_rec, last=last, needs_far=needs_far,
                 bg_hard=bg_hard, bg_scale=bg_scale, use_pos=use_pos,
                 use_dir=use_dir, bgu=bgu, bgv=bgv)
        if soft:
            P["cap_drop"] = cap_drop
        for k, (start, sdir, slen) in enumerate(slots):
            P[f"s{k}"], P[f"d{k}"], P[f"l{k}"] = start, sdir, slen
        self.P = P

    def body(self, P, k):
        """One level over whatever rectangular domain P holds."""
        sc, tex, atlas, fetch = self.sc, self.tex, self.atlas, self.fetch
        n_slots, soft, m = self.n_slots, self.soft, sc.materials
        b = tuple(P["bgu"].shape)
        pdev = P["bgu"].device
        open_ = P["open"]
        if k > n_slots:
            # Cleanup: the sky for every lane still owed one.
            want = open_ & P["bg_hard"] & ~P["bg_done"]
            if soft:
                want = want | ((P["captured"] | (P["cap_drop"] & open_))
                               & ~P["bg_done"])
            bg = fetch(atlas, torch.zeros(b, dtype=torch.int64, device=pdev),
                       P["bgu"], P["bgv"])
            color = P["color"] + torch.where(want[..., None],
                                             bg * P["bg_scale"], 0.0)
            return {**P, "color": color, "bg_done": P["bg_done"] | want}
        if k < n_slots:
            rec = P[f"l{k}"] > 0.0
            fold = P["needs_far"] & (P["n_rec"] == k)
            start, sdir, slen = P[f"s{k}"], P[f"d{k}"], P[f"l{k}"]
        else:
            rec = torch.zeros(b, dtype=torch.bool, device=pdev)
            fold = P["needs_far"] & (P["n_rec"] >= n_slots)
            start = torch.zeros(b + (3,), device=pdev)
            sdir = start
            slen = torch.zeros(b, device=pdev)
        eff = rec | fold
        # Unrecorded lanes carry zero vectors, which would send NaNs
        # through intersect's backward: give them a harmless unit ray.
        # Folded lanes shoot the unbounded far ray (window -1); recorded
        # windows inflate slightly, so that a recorded hit cannot fall off
        # the end of its own segment by the ulp between the march's lambda
        # and this recomputation.
        safe_dir = torch.where(fold[..., None], P["use_dir"],
                               torch.where(rec[..., None], sdir, self.unit_x))
        safe_start = torch.where(fold[..., None], P["use_pos"], start)
        window = torch.where(fold, -1.0,
                             torch.where(rec, slen * 1.0001 + 1e-5, 1.0))
        hit = intersect_scene(safe_start, safe_dir, window, sc, self.r_s,
                              self.test_ray)
        regular = hit.obj_type >= 0  # a texel the shading actually uses
        mi = torch.clamp(hit.mat_idx, 0, m.color.shape[0] - 1)
        base_col = _gather(m.color, mi)
        if self.have_stack:
            req = texel_request(hit, sc, tex)
            texel_want = eff & open_ & hit.valid & req.use_tex & regular
            layer = torch.where(texel_want, req.index.to(torch.int64) + 1, 0)
            fu = torch.where(texel_want, req.u, P["bgu"])
            fv = torch.where(texel_want, req.v, P["bgv"])
        else:
            texel_want = torch.zeros(b, dtype=torch.bool, device=pdev)
            layer = torch.zeros(b, dtype=torch.int64, device=pdev)
            fu, fv = P["bgu"], P["bgv"]
        # The merged fetch: the lane's hit texel, or its sky texel.
        fetched = fetch(atlas, layer, fu, fv)
        base_col = torch.where(texel_want[..., None], fetched, base_col)

        nm_rgb = None
        if self.nm_on:
            nm_idx = _gather(m.normal_map_index, mi)
            nm_want = eff & open_ & hit.valid & (nm_idx >= 0) & regular
            nm_sizes = _gather(tex.sizes, torch.clamp(
                nm_idx, 0, tex.sizes.shape[0] - 1))
            nm_uv = req.uv * nm_sizes / tex.max_size
            nm_fetched = fetch(
                atlas, torch.where(nm_want, nm_idx.to(torch.int64) + 1, 0),
                torch.where(nm_want, nm_uv[..., 0], 0.0),
                torch.where(nm_want, nm_uv[..., 1], 0.0))
            # Raw rgb in [0, 1] (frag:408-413); other lanes carry zeros,
            # masked out by ``take`` below.
            nm_rgb = torch.where(nm_want[..., None], nm_fetched[..., :3], 0.0)

        rgba = _shade_lit(hit, -safe_dir, sc, base_col, nm_rgb)
        take = eff & open_ & hit.valid
        opaque_take = take & (rgba[..., 3] == 1.0)
        color = P["color"] + torch.where(take[..., None], rgba, 0.0)
        captured_new = opaque_take & (hit.obj_type == OBJECT_TYPE_SPECIAL)
        open_ = open_ & ~opaque_take
        # Lanes whose contributions end here and whose fetch was the sky
        # consume it now; textured translucent lanes (their fetch was the
        # texel) pay it at the cleanup level.
        bg_now = (open_ & (P["last"] <= k) & P["bg_hard"] & ~P["bg_done"]
                  & ~texel_want)
        if soft:
            # A fresh capture is opaque black plus scaled sky; its fetch
            # was the sky (the horizon is never textured).
            bg_now = bg_now | (captured_new & ~texel_want & ~P["bg_done"])
        color = color + torch.where(bg_now[..., None],
                                    fetched * P["bg_scale"], 0.0)
        return {**P, "color": color, "open": open_,
                "captured": P["captured"] | captured_new,
                "bg_done": P["bg_done"] | bg_now}

    def pending(self, P, k):
        """The lanes level k changes (every lane outside it is left as it
        is by the level)."""
        n_slots = self.n_slots
        open_ = P["open"]
        bg_pend = open_ & P["bg_hard"] & ~P["bg_done"] & (P["last"] <= k)
        if k < n_slots:
            eff = ((P[f"l{k}"] > 0.0)
                   | (P["needs_far"] & (P["n_rec"] == k)))
        elif k == n_slots:
            eff = P["needs_far"] & (P["n_rec"] >= n_slots)
        else:
            eff = torch.zeros_like(open_)
            if self.soft:
                bg_pend = bg_pend | ((P["captured"] | (P["cap_drop"] & open_))
                                     & ~P["bg_done"])
        return (open_ & eff) | bg_pend

    def masks(self, P, k):
        """After level k: for each later level, whether a lane of each tile
        (or, untiled, of the frame) is pending there; (levels after k,
        tiles) bools, or None after the last level."""
        rows = []
        for kk in range(k + 1, self.n_levels):
            pend = self.pending(P, kk)
            if self.tiles:
                nth, ntw = self.tiles
                rows.append(pend.reshape(nth, TILE_H, ntw, TILE_W).any(3)
                            .any(1).reshape(-1))
            else:
                rows.append(pend.any().reshape(1))
        return torch.stack(rows) if rows else None

    def read(self):
        """The masks after the last level run on the host (one read): a
        (levels, tiles) bool array, row k level k's, False up to that
        level."""
        first, rows = self.pend
        n = self.tiles[0] * self.tiles[1] if self.tiles else 1
        out = np.zeros((self.n_levels, n), bool)
        if rows is not None:
            out[first:] = rows.cpu().numpy()
        return out

    def keys(self, k):
        """The planes level k reads."""
        keys = ["color", "open", "captured", "bg_done", "bg_hard",
                "bg_scale", "bgu", "bgv"]
        if self.soft:
            keys.append("cap_drop")
        if k <= self.n_slots:
            keys += ["n_rec", "last", "needs_far", "use_pos", "use_dir"]
            if k < self.n_slots:
                keys += [f"s{k}", f"d{k}", f"l{k}"]
        return keys

    def run(self, k, ids):
        """Level k on the whole frame (``ids`` None) or on the tiles
        ``ids``; then the masks of the later levels."""
        self.P = (self.body(self.P, k) if ids is None
                  else self.on_tiles(k, ids))
        self.pend = k + 1, self.masks(self.P, k)

    def on_tiles(self, k, ids):
        """Level k on the tiles ``ids`` (a numpy array, filled up to the
        level's capacity with the fill id nt): their planes packed into one
        array, gathered into a (len(ids) * 8, 128) domain, and scattered
        back."""
        P = self.P
        nth, ntw = self.tiles
        nt = nth * ntw
        H, W = nth * TILE_H, ntw * TILE_W
        capt = len(ids)
        ids = torch.as_tensor(ids, device=self.dev)
        lanes = _tile_lanes(torch.clamp(ids, max=nt - 1), ntw, W)
        packed, recipe = _pack_planes(P, self.keys(k))
        dom = packed.reshape(H * W, -1).index_select(0, lanes)
        dom = self.body(_unpack_planes(
            dom.reshape(capt * TILE_H, TILE_W, -1), recipe), k)
        # Fill tiles scatter into a discard row past the frame.
        dest = torch.where((ids < nt).repeat_interleave(TILE_H * TILE_W),
                           lanes, H * W)
        mutated = ("color", "open", "captured", "bg_done")
        full, recipe = _pack_planes(P, mutated)
        dom_packed, _ = _pack_planes(dom, mutated)
        flat = torch.cat([full.reshape(H * W, -1),
                          full.new_zeros((1, full.shape[-1]))])
        flat = flat.index_copy(0, dest, dom_packed.reshape(dest.shape[0], -1))
        return {**P, **_unpack_planes(flat[:H * W].reshape(H, W, -1),
                                      recipe)}

    def result(self):
        return self.P["color"], self.P["open"], self.P["captured"]


# ---------------------------------------------------------------------------
# The composition kernel: its tables, its planes, its wrapper.
# ---------------------------------------------------------------------------

# Row widths of the kernel's word buffer (kSphereW ... kLayerW in
# csrc/compose.cu).
_TABLE_WIDTHS = dict(spheres=14, planes=18, disks=14, hollow=15,
                     cylinders=15, rects=15, boxes=85, materials=15,
                     lights=10, layers=4)
# The test ray's tube rows (kTubeW): pos, axes, height, radius, active;
# the radius and the straight tube's length are intersect's defaults.
_TUBE_RADIUS, _TUBE_LENGTH = 0.025, 1000.0


def _rows(*cols):
    """Per-row fields (each (N, ...)) as the flat words of N rows: float32
    as they are, int32 as bit patterns, bools as 0 or 1."""
    n = cols[0].shape[0]

    def word(c):
        c = c.reshape(n, int(np.prod(c.shape[1:], dtype=np.int64)))
        return c.view(torch.float32) if c.dtype == torch.int32 else c.to(
            torch.float32)

    return torch.cat([word(c) for c in cols], 1)


def _pack_tables(sc: Scene, tex, atlas: FetchAtlas):
    """The scene's tables, the materials, the lights, the stack's sizes and
    the atlas's layers as one float32 word buffer on the device (built
    with torch operations: no read of the host), and the kernel's offsets
    and row counts (``Tables`` of csrc/compose.cu, in its order)."""
    s, p, d, h = sc.spheres, sc.planes, sc.disks, sc.hollow_disks
    c, r, b, m, lt = (sc.cylinders, sc.rectangles, sc.boxes, sc.materials,
                      sc.lights)
    tables = dict(
        spheres=_rows(s.pos, s.axes, s.radius, s.mat_idx),
        planes=_rows(p.pos, p.axes, p.texture_offset, p.texture_size,
                     p.repeat_texture, p.mat_idx),
        disks=_rows(d.pos, d.axes, d.radius, d.mat_idx),
        hollow=_rows(h.pos, h.axes, h.inner_radius, h.outer_radius,
                     h.mat_idx),
        cylinders=_rows(c.pos, c.axes, c.height, c.radius, c.mat_idx),
        rects=_rows(r.pos, r.axes, r.width, r.height, r.mat_idx),
        boxes=_rows(b.face_pos, b.face_axes, b.face_width, b.face_height,
                    b.mat_idx),
        materials=_rows(m.color, m.ambient, m.diffuse, m.specular,
                        m.shininess, m.texture_index, m.normal_map_index,
                        m.invert_uv_x, m.invert_uv_y, m.swap_uvs,
                        m.double_sided_normals, m.flip_normals),
        lights=_rows(lt.pos, lt.color, lt.intensity, lt.attenuation_constant,
                     lt.attenuation_linear, lt.attenuation_quadratic),
        layers=_rows(atlas.wrap, atlas.base, atlas.gpr))
    for name, t in tables.items():  # the kernel's fixed row layout
        if t.shape[1] != _TABLE_WIDTHS[name]:
            raise ValueError(f"{name} rows have {t.shape[1]} words, not "
                             f"{_TABLE_WIDTHS[name]}")
    sizes = (tex.sizes if tex is not None
             else torch.zeros((0, 2), device=atlas.wrap.device))
    max_size = (tex.max_size if tex is not None
                else torch.zeros(2, device=atlas.wrap.device))
    order = [("spheres", True), ("planes", True), ("disks", True),
             ("hollow", True), ("cylinders", True), ("rects", True),
             ("boxes", True), ("box_uv", False), ("materials", True),
             ("lights", True), ("tex_sizes", True), ("max_size", False),
             ("layers", True)]
    parts = dict(tables, box_uv=b.atlas_offset.reshape(1, -1),
                 tex_sizes=sizes.to(torch.float32),
                 max_size=max_size.to(torch.float32).reshape(1, -1))
    words, offs, at = [], [], 0
    for name, counted in order:
        t = parts[name]
        offs.append(at)
        if counted:
            offs.append(t.shape[0])
        words.append(t.reshape(-1))
        at += t.numel()
    return torch.cat(words).contiguous(), offs


_TABLES = SourceMemo()


def _tables(sc: Scene, tex, atlas: FetchAtlas):
    """:func:`_pack_tables`, kept for its source tensors (a
    :class:`textures.SourceMemo`): the frames of one scene pack its tables
    once, and an in-place write to a source packs them anew."""
    src = _tensors((sc, None if tex is None else (tex.sizes, tex.max_size),
                    atlas.wrap, atlas.base, atlas.gpr))
    return _TABLES.get(src, None, lambda: _pack_tables(sc, tex, atlas))


def _tube_rows(test_ray, r_s, dev):
    """The test ray's straight tube and its chain of curved tubes as
    (1 + K-1, 15) rows, with intersect.test_ray_candidates' frames,
    lengths and activity (the chain's last segment depends on r_s)."""
    f32 = dict(dtype=torch.float32, device=dev)
    r_s = torch.as_tensor(r_s, **f32).detach()
    p0, frames, seg_len, active = tube_segments(test_ray, r_s, _TUBE_LENGTH)
    n = p0.shape[0]
    flat = torch.cat([test_ray.flat_origin.reshape(1, 3).to(torch.float32),
                      tube_frame(test_ray.flat_dir).reshape(1, 9),
                      *[torch.full((1, 1), x, **f32)
                        for x in (_TUBE_LENGTH, _TUBE_RADIUS, 1.0)]], 1)
    curved = torch.cat([p0, frames.reshape(n, 9), seg_len[:, None],
                        torch.full((n, 1), _TUBE_RADIUS, **f32),
                        active[:, None].to(torch.float32)], 1)
    return torch.cat([flat, curved]).contiguous()


def _plane(x, dtype, what):
    if x.dtype != dtype:
        raise ValueError(f"compose_levels: {what} must be {dtype}, "
                         f"got {x.dtype}")
    return x.contiguous()


def compose_levels(sc: Scene, tex, atlas: FetchAtlas, r_s, *, slots, n_rec,
                   needs_far, use_pos, use_dir, bgu, bgv, bg_hard, bg_scale,
                   soft: bool, cap_drop, open_init, test_ray=None,
                   max_levels: Optional[int] = None):
    """Launch ``compose_levels_kernel``: every level of :func:`compose_atlas`
    (0 .. ``max_levels`` - 1, default K + 2) for every lane of a frame of
    CUDA tensors, in one launch with no read of the host and no gradient.
    Returns (color, open, captured); counts the launch in
    ``compose_levels.launches``."""
    n_slots = len(slots)
    n_levels = n_slots + 2 if max_levels is None else max_levels
    if not 1 <= n_levels <= n_slots + 2:
        raise ValueError(f"compose_levels: {n_levels} levels for {n_slots} "
                         "slots")
    if atlas.data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compose_levels: the atlas must be float32 or "
                         f"bfloat16, got {atlas.data.dtype}")
    if not atlas.data.is_contiguous() or atlas.data.data_ptr() % 16:
        raise ValueError("compose_levels: the atlas must be contiguous and "
                         "16-byte aligned")
    batch = tuple(bgu.shape)
    dev, n = bgu.device, bgu.numel()
    f32, b8 = torch.float32, torch.bool
    color = torch.empty(batch + (4,), device=dev)
    open_, captured, bg_done = (torch.empty(batch, dtype=b8, device=dev)
                                for _ in range(3))
    planes = [color, open_, captured, bg_done,
              _plane(open_init, b8, "open_init"),
              _plane(needs_far, b8, "needs_far"),
              _plane(bg_hard, b8, "bg_hard"),
              _plane(cap_drop, b8, "cap_drop") if soft else None,
              _plane(n_rec, torch.int32, "n_rec"),
              _plane(bg_scale, f32, "bg_scale"),
              _plane(use_pos, f32, "use_pos"),
              _plane(use_dir, f32, "use_dir"),
              _plane(bgu, f32, "bgu"), _plane(bgv, f32, "bgv")]
    slot_planes = [_plane(s[j], f32, "slots") for j in range(3)
                   for s in slots]
    for x in planes + slot_planes:
        if x is not None and (x.device != dev
                              or x.numel() not in (n, 3 * n, 4 * n)):
            raise ValueError("compose_levels: every plane on the frame's "
                             "device and of its lanes")
    lanes = (ctypes.c_void_p * len(planes))(
        *[None if x is None else x.data_ptr() for x in planes])
    # The slots' pointers as a device array (any K), copied from pinned
    # memory without a wait.
    slot_ptrs = torch.tensor([x.data_ptr() for x in slot_planes],
                             dtype=torch.int64, pin_memory=True).to(
                                 dev, non_blocking=True)
    words, offs = _tables(sc, tex, atlas)
    tubes = None if test_ray is None else _tube_rows(test_ray, r_s, dev)
    r_s = torch.as_tensor(r_s, dtype=f32, device=dev).reshape(1)
    rc = _ext.library().compose_levels_launch(
        lanes, _ext.ptr(slot_ptrs), n_slots, n_levels, _ext.ptr(words),
        (ctypes.c_int * len(offs))(*offs), _ext.ptr(tubes),
        0 if tubes is None else tubes.shape[0], _ext.ptr(r_s),
        _ext.ptr(atlas.data), int(atlas.data.dtype == torch.bfloat16), n,
        int(soft), _ext.stream_ptr(dev))
    _ext.check(rc, "compose_levels")
    if n:
        compose_levels.launches += 1
    return color, open_, captured


compose_levels.launches = 0
