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
tiles that still hold a pending lane, gathered (all planes packed into one
array, one gather) into a dense domain of a fixed number of tiles and
scattered back (one scatter); a level whose pending tiles exceed that
number runs on the whole frame instead, and a level with no pending lane
is skipped.  One read of the host a level, the count of its pending tiles,
decides which, so each level is computed once.  A last cleanup level pays
the sky of lanes whose last fetch was a texel (translucent textured paths)
and, with a soft horizon, of captured lanes whose slot was dropped.

The per-lane arithmetic is the per-slot pass loop's (``kernel_scene.
render_fast``'s trilinear path) with the atlas in place of the samplers,
and a compacted level's lanes equal the full-frame level's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .intersect import intersect_scene
from .scene import OBJECT_TYPE_SPECIAL, Scene
from .shading import _concrete_none_negative, _gather, _shade_lit, texel_request
from .textures import FetchAtlas, atlas_fetch, atlas_fetch_frozen

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
    recorded count; ``needs_far`` the lanes whose far-field or flat ray
    folds in at slot ``n_rec``; ``use_pos``/``use_dir`` that ray; ``bgu``,
    ``bgv`` the sky's uv; ``bg_hard`` the lanes owed the sky when open at
    their end; ``bg_scale`` ((..., 1)) the sky's weight (ones with a hard
    horizon, already in the returned colour); ``cap_drop`` the lanes
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
    on what is differentiated."""
    fetch = atlas_fetch_frozen if frozen_texels else atlas_fetch
    batch = tuple(bgu.shape)
    dev = bgu.device
    n_slots = len(slots)
    m = sc.materials
    have_stack = tex is not None
    nm_on = have_stack and not _concrete_none_negative(m.normal_map_index)
    unit_x = torch.tensor([1.0, 0.0, 0.0], device=dev)

    # Each lane's last contribution level: slot n_rec - 1, or the far fold
    # at level n_rec (the residual level K when every slot is taken); -1
    # for a lane with no contribution (pure sky).
    last = torch.where(needs_far, torch.clamp(n_rec, max=n_slots), n_rec - 1)

    P = dict(color=torch.zeros(batch + (4,), device=dev), open=open_init,
             captured=torch.zeros(batch, dtype=torch.bool, device=dev),
             bg_done=torch.zeros(batch, dtype=torch.bool, device=dev),
             n_rec=n_rec, last=last, needs_far=needs_far, bg_hard=bg_hard,
             bg_scale=bg_scale, use_pos=use_pos, use_dir=use_dir, bgu=bgu,
             bgv=bgv)
    if soft:
        P["cap_drop"] = cap_drop
    for k, (start, sdir, slen) in enumerate(slots):
        P[f"s{k}"], P[f"d{k}"], P[f"l{k}"] = start, sdir, slen

    def level_body(P, k):
        """One level over whatever rectangular domain P holds."""
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
                               torch.where(rec[..., None], sdir, unit_x))
        safe_start = torch.where(fold[..., None], P["use_pos"], start)
        window = torch.where(fold, -1.0,
                             torch.where(rec, slen * 1.0001 + 1e-5, 1.0))
        hit = intersect_scene(safe_start, safe_dir, window, sc, r_s, test_ray)
        regular = hit.obj_type >= 0  # a texel the shading actually uses
        mi = torch.clamp(hit.mat_idx, 0, m.color.shape[0] - 1)
        base_col = _gather(m.color, mi)
        if have_stack:
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
        if nm_on:
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

    def pending(P, k):
        """The lanes level k changes (every lane outside it is left as it
        is by the level)."""
        open_ = P["open"]
        bg_pend = open_ & P["bg_hard"] & ~P["bg_done"] & (P["last"] <= k)
        if k < n_slots:
            eff = ((P[f"l{k}"] > 0.0)
                   | (P["needs_far"] & (P["n_rec"] == k)))
        elif k == n_slots:
            eff = P["needs_far"] & (P["n_rec"] >= n_slots)
        else:
            eff = torch.zeros_like(open_)
            if soft:
                bg_pend = bg_pend | ((P["captured"] | (P["cap_drop"] & open_))
                                     & ~P["bg_done"])
        return (open_ & eff) | bg_pend

    def level_keys(k):
        keys = ["color", "open", "captured", "bg_done", "bg_hard",
                "bg_scale", "bgu", "bgv"]
        if soft:
            keys.append("cap_drop")
        if k <= n_slots:
            keys += ["n_rec", "last", "needs_far", "use_pos", "use_dir"]
            if k < n_slots:
                keys += [f"s{k}", f"d{k}", f"l{k}"]
        return keys

    mutated = ("color", "open", "captured", "bg_done")

    # Level 0 always runs on the whole frame (nearly every lane has a
    # contribution or a sky fetch there).
    P = level_body(P, 0)
    H, W = batch if len(batch) == 2 else (0, 0)
    can_tile = (compact_tiles and len(batch) == 2 and H % TILE_H == 0
                and W % TILE_W == 0 and H * W >= 4 * TILE_H * TILE_W)
    nth, ntw = (H // TILE_H, W // TILE_W) if can_tile else (0, 0)
    nt = nth * ntw
    n_pends, caps = [], []
    n_levels = n_slots + 2 if max_levels is None else max_levels
    for k in range(1, n_levels):
        pend = pending(P, k)
        if not can_tile:
            if bool(pend.any()):  # one read of the host a level
                P = level_body(P, k)
            continue
        capt = max(nt // (4 if k == 1 else 16 if k == 2 else 32), 4)
        tpend = pend.reshape(nth, TILE_H, ntw, TILE_W).any(3).any(1)
        tpend = tpend.reshape(-1)
        n_pend = int(tpend.sum())  # one read of the host a level
        n_pends.append(n_pend)
        caps.append(capt)
        if n_pend == 0:
            continue  # the level would change no lane
        if n_pend > capt:
            P = level_body(P, k)  # too many tiles: the whole frame
            continue
        # The pending tiles' ids in order, each at its rank among them;
        # the rows past n_pend keep the fill id nt.
        rank = torch.cumsum(tpend.to(torch.int64), 0) - 1
        ids = torch.full((capt + 1,), nt, dtype=torch.int64, device=dev)
        ids = ids.index_copy_(0, torch.where(tpend, rank, capt),
                              torch.arange(nt, device=dev))[:capt]
        lanes = _tile_lanes(torch.clamp(ids, max=nt - 1), ntw, W)
        packed, recipe = _pack_planes(P, level_keys(k))
        dom = packed.reshape(H * W, -1).index_select(0, lanes)
        dom = level_body(_unpack_planes(
            dom.reshape(capt * TILE_H, TILE_W, -1), recipe), k)
        # Fill tiles scatter into a discard row past the frame.
        dest = torch.where((ids < nt).repeat_interleave(TILE_H * TILE_W),
                           lanes, H * W)
        full, recipe = _pack_planes(P, mutated)
        dom_packed, _ = _pack_planes(dom, mutated)
        flat = torch.cat([full.reshape(H * W, -1),
                          full.new_zeros((1, full.shape[-1]))])
        flat = flat.index_copy(0, dest, dom_packed.reshape(dest.shape[0], -1))
        P = {**P, **_unpack_planes(flat[:H * W].reshape(H, W, -1), recipe)}

    if return_pend:
        return (P["color"], P["open"], P["captured"],
                torch.tensor(n_pends, dtype=torch.int64), tuple(caps))
    return P["color"], P["open"], P["captured"]
