"""Textures, GL_LINEAR + GL_REPEAT sampling and mip pyramids (counterpart
of the loader, the bilinear samplers and the mip functions of
``schwarzschild_tpu.textures``).

Same conventions as the JAX package: images are flipped on load so row 0
is the BOTTOM row, a stack pads every image to the largest size with
(0, 0, 0, 0) texels, and per-texture true sizes rescale UVs.

Sampling is a plain four-corner gather per lane: on the GPU an indexed load
costs the same whatever its pattern, so the JAX package's channel-major
patch gathers are not carried over.  Every sampler casts the gathered
texels to float32 before its lerp, so texels stored as bfloat16
(:func:`with_dtype`) sample in float32 and an alpha of exactly 1 stays 1.

The merged fetch atlas (:class:`FetchAtlas`) holds the background and the
stack in one sheet of 2 x 2 bilinear footprints, the JAX package's storage
bit for bit, so that a composition level fetches each lane's texel or sky
texel with one indexed load of 64 bytes (``compose.compose_atlas``).  The
compacted samplers run a sampler only on the lanes that want it, packed
into a fixed number of rows without a read of the host.

Mips are opt-in, beyond the reference: its min filter is GL_LINEAR, so GL
never samples the mipmaps it generates, and bilinear level 0 is the parity
target.  ``RenderConfig(texture_filter="trilinear")`` samples the pyramid
at a screen-space LOD (:func:`screen_space_lod`); the renderers build the
pyramid with :func:`build_mips` when a texture carries none.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import resolve_device


class Texture(NamedTuple):
    """One RGBA texture: data (H, W, 4) float32 in [0, 1], row 0 = bottom.
    ``mips``: the levels below the base (half size, quarter, ...) for
    trilinear sampling (:func:`build_mips`); empty samples level 0 only."""

    data: torch.Tensor
    mips: tuple = ()


class TextureStack(NamedTuple):
    """Padded texture array + per-texture true sizes; ``mips`` as in
    :class:`Texture`, each level (T, h, w, 4)."""

    data: torch.Tensor  # (T, Hmax, Wmax, 4) float32
    sizes: torch.Tensor  # (T, 2) float32 — (width, height)
    max_size: torch.Tensor  # (2,) float32 — (Wmax, Hmax)
    mips: tuple = ()


def load_image(path) -> np.ndarray:
    """Decode an image file to (H, W, C) uint8 with row 0 = top."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA", "L"):
            im = im.convert("RGBA" if "A" in im.mode else "RGB")
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    return arr


def _to_gl_rgba_f32(arr: np.ndarray) -> np.ndarray:
    """uint8 (H, W, C) top-down -> float32 (H, W, 4) bottom-up in [0, 1]."""
    arr = arr[::-1]  # y-flip (image_utils.cpp:22)
    h, w, c = arr.shape
    out = np.zeros((h, w, 4), np.float32)
    out[..., :c] = arr.astype(np.float32) / 255.0
    if c < 4:
        out[..., 3] = 1.0
    return out


def load_texture(path, device=None) -> Texture:
    return Texture(data=torch.as_tensor(_to_gl_rgba_f32(load_image(path)),
                                        device=resolve_device(device)))


def from_array(arr, device=None) -> Texture:
    """Texture from an (H, W, 3|4) float array in [0, 1], row 0 = top."""
    arr = np.asarray(arr, np.float32)[::-1]
    if arr.shape[-1] == 3:
        arr = np.concatenate(
            [arr, np.ones(arr.shape[:-1] + (1,), np.float32)], -1)
    return Texture(data=torch.as_tensor(np.ascontiguousarray(arr),
                                        device=resolve_device(device)))


def load_texture_array(paths: Sequence[str], device=None) -> TextureStack:
    """Padded texture stack of image files (image_utils.cpp:42-117)."""
    return stack_textures([load_image(p) for p in paths], device=device)


def solid_color_texture(rgba, size=4, device=None) -> Texture:
    """A size x size texture of one RGBA colour."""
    rgba = torch.as_tensor(np.asarray(rgba, np.float32),
                           device=resolve_device(device))
    return Texture(data=rgba.expand(size, size, 4))


def stack_textures(raw_images: Sequence[np.ndarray],
                   device=None) -> TextureStack:
    """Pack top-down uint8 (H, W, C) images into a padded GL-convention
    stack."""
    device = resolve_device(device)
    max_h = max(im.shape[0] for im in raw_images)
    max_w = max(im.shape[1] for im in raw_images)
    data = np.zeros((len(raw_images), max_h, max_w, 4), np.float32)
    sizes = np.zeros((len(raw_images), 2), np.float32)
    for i, im in enumerate(raw_images):
        gl = _to_gl_rgba_f32(im)
        h, w, _ = gl.shape
        data[i, :h, :w] = gl
        sizes[i] = (w, h)
    return TextureStack(
        data=torch.as_tensor(data, device=device),
        sizes=torch.as_tensor(sizes, device=device),
        max_size=torch.as_tensor(np.array([max_w, max_h], np.float32),
                                 device=device),
    )


def _bilinear(data, layer, u, v):
    """GL_LINEAR + GL_REPEAT sample of ``data`` (T, H, W, 4) at layer
    ``layer`` and normalized (u, v), texel centres at (i + 0.5) / W.

    Indices wrap with ``torch.remainder`` (non-negative, like ``jnp.mod``),
    and the lerps are written ``a + f * (b - a)``: that form keeps an alpha
    of exactly 1 at 1, which the first-opaque test ``rgba[..., 3] == 1``
    depends on (``torch.lerp`` rounds differently).  The corners are cast
    to float32 first (bfloat16 texels sample in float32)."""
    h, w = data.shape[-3], data.shape[-2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    x1i = torch.where(x0i == w - 1, 0, x0i + 1)
    y1i = torch.where(y0i == h - 1, 0, y0i + 1)

    flat = data.reshape(-1, data.shape[-1])
    base = layer.to(torch.int64) * (h * w)
    c00 = flat[base + y0i * w + x0i].to(torch.float32)
    c10 = flat[base + y0i * w + x1i].to(torch.float32)
    c01 = flat[base + y1i * w + x0i].to(torch.float32)
    c11 = flat[base + y1i * w + x1i].to(torch.float32)
    top = c00 + fx * (c10 - c00)
    bot = c01 + fx * (c11 - c01)
    return top + fy * (bot - top)


def sample_texture(tex: Texture, u, v):
    """``texture(background_texture, uv)`` equivalent."""
    return _bilinear(tex.data[None], torch.zeros_like(u, dtype=torch.int64),
                     u, v)


def sample_stack(stack: TextureStack, index, u, v):
    """``texture(textures, vec3(uv, index))``; indices < 0 clamp to 0
    (callers mask the result)."""
    idx = torch.clamp(index, 0, stack.data.shape[0] - 1)
    return _bilinear(stack.data, torch.broadcast_to(idx, u.shape), u, v)


# ---------------------------------------------------------------------------
# Compacted samplers: a sampler run only on the lanes that want it.
# ---------------------------------------------------------------------------


def _compact_rows(cols, want, cap: int):
    """Pack the per-lane columns ``cols`` of the lanes that ``want`` into
    ``cap`` rows, without a read of the host.

    Each wanted lane's rank is ``cumsum(want) - 1``; lanes ranked below
    ``cap`` scatter their index into that row, every other lane into a
    discard row ``cap`` (dropped).  Returns (rows (cap, F) float32, idx
    (cap,) the flat lane of each row, cvalid (cap,) the rows that hold a
    lane, dropped (want's shape) the wanted lanes past ``cap``)."""
    flat_want = want.reshape(-1)
    n = flat_want.shape[0]
    dev = flat_want.device
    tab = torch.cat([c.reshape(n, -1).to(torch.float32) for c in cols],
                    dim=-1)
    rank = torch.cumsum(flat_want.to(torch.int64), 0) - 1
    row = torch.where(flat_want & (rank < cap), rank, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=dev).index_copy_(
        0, row, torch.arange(n, device=dev))[:cap]
    cvalid = torch.arange(cap, device=dev) < flat_want.sum()
    dropped = (flat_want & (rank >= cap)).reshape(want.shape)
    return tab.index_select(0, idx), idx, cvalid, dropped


def _compacted(sample_rows, cols, want, cap: int, full):
    """``sample_rows(rows, cvalid)`` -> (cap, 4) samples of the packed
    lanes, scattered back over zeros; wanted lanes past ``cap`` take
    ``full()``, the full-batch sampler, which runs only when one was
    dropped (one read of the host), so no lane is ever lost."""
    batch = want.shape
    rows, idx, cvalid, dropped = _compact_rows(cols, want, cap)
    sampled = torch.where(cvalid[:, None], sample_rows(rows, cvalid), 0.0)
    n = want.numel()
    out = torch.zeros((n + 1, 4), device=sampled.device)
    out = out.index_copy(0, torch.where(cvalid, idx, n), sampled)
    out = out[:-1].reshape(batch + (4,))
    if bool(dropped.any()):
        out = torch.where(dropped[..., None], full(), out)
    return out


def sample_stack_compact(stack: TextureStack, index, u, v, want, cap: int):
    """:func:`sample_stack` on the ``want`` lanes only, packed into ``cap``
    rows (zeros elsewhere): per lane the same arithmetic on the same
    values as the full batch, texel gradients included."""

    def rows_of(rows, ok):
        return sample_stack(stack,
                            torch.where(ok, rows[:, 0].to(torch.int64), 0),
                            torch.where(ok, rows[:, 1], 0.0),
                            torch.where(ok, rows[:, 2], 0.0))

    return _compacted(rows_of, [torch.broadcast_to(index, u.shape), u, v],
                      want, cap, lambda: sample_stack(stack, index, u, v))


def sample_texture_compact(tex: Texture, u, v, want, cap: int):
    """:func:`sample_texture` compacted to the ``want`` lanes (see
    :func:`sample_stack_compact`)."""

    def rows_of(rows, ok):
        return sample_texture(tex, torch.where(ok, rows[:, 0], 0.0),
                              torch.where(ok, rows[:, 1], 0.0))

    return _compacted(rows_of, [u, v], want, cap,
                      lambda: sample_texture(tex, u, v))


# ---------------------------------------------------------------------------
# The merged fetch atlas: the background (layer 0) and the stack (layers
# 1..T) as one sheet of bilinear footprints.
# ---------------------------------------------------------------------------


class FetchAtlas(NamedTuple):
    """Layer 0 the background, layer i + 1 stack texture i.

    ``data``: (G, 128) float32 or bfloat16; each row holds 8 quads of 16
    values, [c00 c10 c01 c11] x 4 channels, the 2 x 2 footprint of one
    texel origin with its REPEAT neighbours baked in.  Quad (l, y, x) is
    row ``base[l] + y * gpr[l] + (x >> 3)``, group ``x & 7``: read as a
    (G * 8, 16) view it is one 64-byte row.  Each layer packs at its own
    extent, its width padded to a multiple of 8 with zero quads that are
    never fetched.  ``wrap``: (L, 2) float32 (wrapW, wrapH), the REPEAT
    extents the samplers use (the background's own size, the stack's
    padded size); ``base``: (L,) int32 row offsets; ``gpr``: (L,) int32
    rows per texel row, ceil(wrapW / 8).  The JAX package's layout."""

    data: torch.Tensor
    wrap: torch.Tensor
    base: torch.Tensor
    gpr: torch.Tensor


def _quad_rows(src, wrap_h: int, wrap_w: int):
    """(H, W, 4) -> the layer's (wrap_h * ceil(wrap_w / 8), 128) rows;
    differentiable in ``src``."""
    s = src[:wrap_h, :wrap_w]
    xp = torch.roll(s, -1, 1)
    yp = torch.roll(s, -1, 0)
    xyp = torch.roll(xp, -1, 0)
    quads = torch.cat([s, xp, yp, xyp], dim=-1)  # (h, w, 16)
    wp = -(-wrap_w // 8) * 8
    if wp != wrap_w:
        quads = torch.nn.functional.pad(quads, (0, 0, 0, wp - wrap_w))
    return quads.reshape(wrap_h * (wp // 8), 128)


def _atlas_layers(background: Texture, stack: Optional[TextureStack]):
    """The (source, wrap_h, wrap_w) of every layer."""
    bh, bw = background.data.shape[-3], background.data.shape[-2]
    layers = [(background.data, bh, bw)]
    if stack is not None:
        sh, sw = stack.data.shape[1], stack.data.shape[2]
        layers += [(stack.data[i], sh, sw) for i in range(stack.data.shape[0])]
    return layers


def _atlas_tables(layers):
    """Per-layer (wrap, base, gpr) numpy tables and the sheet's rows."""
    wrap = np.asarray([[w, h] for _, h, w in layers], np.float32)
    gpr = np.asarray([-(-w // 8) for _, _, w in layers], np.int32)
    rows = np.asarray([h for _, h, _ in layers], np.int64) * gpr
    base = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    return wrap, base, gpr, int(rows.sum())


def _itemsize(dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def atlas_nbytes(background: Texture, stack: Optional[TextureStack] = None,
                 dtype=torch.float32) -> int:
    """Device bytes of the atlas of these sources."""
    _, _, _, total_rows = _atlas_tables(_atlas_layers(background, stack))
    return total_rows * 128 * _itemsize(dtype)


# Building an atlas past this many bytes raises (a configuration error
# found at build time rather than as an out-of-memory mid-frame); the
# environment variable raises it for bigger cards.
ATLAS_MAX_BYTES = int(float(os.environ.get("SCHW_ATLAS_MAX_BYTES", 4e9)))


def _check_atlas_bytes(nbytes: int):
    if nbytes > ATLAS_MAX_BYTES:
        raise ValueError(
            f"fetch atlas would be {nbytes / 1e9:.2f} GB "
            f"(> SCHW_ATLAS_MAX_BYTES={ATLAS_MAX_BYTES / 1e9:.2f} GB); "
            "use dtype=torch.bfloat16 (halves it; <=0.4% texel error on "
            "8-bit sources) or smaller textures")


def build_atlas(background: Texture, stack: Optional[TextureStack] = None,
                dtype=torch.float32) -> FetchAtlas:
    """The merged fetch atlas of (background, stack) on the background's
    device (see :class:`FetchAtlas`), built with torch ops (roll, cat,
    pad, reshape): differentiable in the texels when they require grad."""
    layers = _atlas_layers(background, stack)
    wrap, base, gpr, total_rows = _atlas_tables(layers)
    _check_atlas_bytes(total_rows * 128 * _itemsize(dtype))
    dev = background.data.device
    sheets = [_quad_rows(src.to(torch.float32), h, w).to(dtype)
              for src, h, w in layers]
    return FetchAtlas(data=torch.cat(sheets, dim=0),
                      wrap=torch.as_tensor(wrap, device=dev),
                      base=torch.as_tensor(base, device=dev),
                      gpr=torch.as_tensor(gpr, device=dev))


_ATLAS_CACHE = []  # (background data, stack data, versions, dtype, atlas)
_ATLAS_CACHE_MAX = 4


def build_atlas_cached(background: Texture,
                       stack: Optional[TextureStack] = None,
                       dtype=torch.float32) -> FetchAtlas:
    """:func:`build_atlas`, kept for the source tensors' identity and their
    version counters: a frame of the textures seen before reuses their
    atlas, and an in-place write to a texture (which bumps its version)
    builds a new one.  Sources that require grad bypass the cache and
    build a differentiable atlas.  The last four atlases are kept."""
    bg_d = background.data
    st_d = stack.data if stack is not None else None
    if bg_d.requires_grad or (st_d is not None and st_d.requires_grad):
        return build_atlas(background, stack, dtype)
    versions = (bg_d._version, None if st_d is None else st_d._version)
    for i, (b, s, vers, dt, atlas) in enumerate(_ATLAS_CACHE):
        if b is bg_d and s is st_d and dt == dtype:
            del _ATLAS_CACHE[i]
            if vers == versions:
                _ATLAS_CACHE.insert(0, (b, s, vers, dt, atlas))
                return atlas
            break  # a stale atlas of these sources: rebuild
    with torch.no_grad():
        atlas = build_atlas(background, stack, dtype)
    _ATLAS_CACHE.insert(0, (bg_d, st_d, versions, dtype, atlas))
    del _ATLAS_CACHE[_ATLAS_CACHE_MAX:]
    return atlas


def _take(table, idx):
    """Per-lane rows of a small per-layer table."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def _fetch_parts(atlas: FetchAtlas, layer, u, v):
    """The bilinear footprint of each lane: the corners c00, c10, c01, c11
    (float32, (..., 4) each), the fractions fx, fy ((..., 1)) and the
    layer's wrap (w, h), with :func:`_bilinear`'s arithmetic."""
    layer = torch.clamp(torch.broadcast_to(layer, u.shape).to(torch.int64),
                        0, atlas.wrap.shape[0] - 1)
    wh = _take(atlas.wrap, layer)
    w, h = wh[..., 0], wh[..., 1]
    base = _take(atlas.base, layer).to(torch.int64)
    gpr = _take(atlas.gpr, layer).to(torch.int64)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w.to(torch.int64))
    y0i = torch.remainder(y0.to(torch.int64), h.to(torch.int64))
    # One 64-byte quad a lane: row g * 8 + q of the (G * 8, 16) view.
    quad = (base + y0i * gpr + (x0i >> 3)) * 8 + (x0i & 7)
    c = atlas.data.view(-1, 16).index_select(0, quad.reshape(-1))
    c = c.to(torch.float32).reshape(u.shape + (4, 4))
    return c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :], fx, fy, w, h


def atlas_fetch(atlas: FetchAtlas, layer, u, v):
    """Bilinear GL_REPEAT sample of atlas layer ``layer`` at (u, v), one
    indexed load of a quad a lane.  With a float32 atlas, bit-equal per
    lane to :func:`sample_texture` (layer 0) and :func:`sample_stack`
    (layer i + 1, at the same rescaled uv).  Differentiable in (u, v) and,
    through the atlas, in the texels it was built from."""
    c00, c10, c01, c11, fx, fy, _, _ = _fetch_parts(atlas, layer, u, v)
    top = c00 + fx * (c10 - c00)
    bot = c01 + fx * (c11 - c01)
    return top + fy * (bot - top)


class _AtlasFetchFrozen(torch.autograd.Function):
    """:func:`atlas_fetch` with the texels held constant: the backward
    reaches (u, v) only, through the two lerp-derivative planes saved by
    the forward (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, data, wrap, base, gpr, layer, u, v):
        atlas = FetchAtlas(data, wrap, base, gpr)
        c00, c10, c01, c11, fx, fy, w, h = _fetch_parts(atlas, layer, u, v)
        top = c00 + fx * (c10 - c00)
        bot = c01 + fx * (c11 - c01)
        d_dfx = (c10 - c00) + fy * ((c11 - c01) - (c10 - c00))
        ctx.save_for_backward(d_dfx, bot - top, w, h)
        return top + fy * (bot - top)

    @staticmethod
    def backward(ctx, ct):
        d_dfx, d_dfy, w, h = ctx.saved_tensors
        d_u = torch.sum(ct * d_dfx, dim=-1) * w
        d_v = torch.sum(ct * d_dfy, dim=-1) * h
        return None, None, None, None, None, d_u, d_v


def atlas_fetch_frozen(atlas: FetchAtlas, layer, u, v):
    """:func:`atlas_fetch` whose gradient reaches (u, v) only, the texels
    treated as constants: no gather in the backward.  Right whenever the
    atlas does not depend on what is differentiated (composition picks it
    for an atlas that does not require grad)."""
    return _AtlasFetchFrozen.apply(atlas.data, atlas.wrap, atlas.base,
                                   atlas.gpr, layer, u, v)


def atlas_fetch_compact(atlas: FetchAtlas, layer, u, v, want, cap: int):
    """:func:`atlas_fetch` on the ``want`` lanes only, packed into ``cap``
    rows (zeros elsewhere; see :func:`sample_stack_compact`)."""

    def rows_of(rows, ok):
        return atlas_fetch(atlas,
                           torch.where(ok, rows[:, 0].to(torch.int64), 0),
                           torch.where(ok, rows[:, 1], 0.0),
                           torch.where(ok, rows[:, 2], 0.0))

    return _compacted(rows_of, [torch.broadcast_to(layer, u.shape), u, v],
                      want, cap, lambda: atlas_fetch(atlas, layer, u, v))


# ---------------------------------------------------------------------------
# Texel storage precision.
# ---------------------------------------------------------------------------


def with_dtype(tex: Texture, dtype=torch.bfloat16) -> Texture:
    """The texture's texels (and mips) stored as ``dtype``: bfloat16 halves
    their bytes at <= 0.4% error on 8-bit sources.  The samplers lerp in
    float32, so an alpha of exactly 1.0 (representable in bfloat16) stays
    1.0 and the first-opaque cut is unchanged.  float32 stays the default
    (the parity target)."""
    return tex._replace(data=tex.data.to(dtype),
                        mips=tuple(m.to(dtype) for m in tex.mips))


def stack_with_dtype(stack: TextureStack,
                     dtype=torch.bfloat16) -> TextureStack:
    """:func:`with_dtype` for a stack (its sizes stay float32)."""
    return stack._replace(data=stack.data.to(dtype),
                          mips=tuple(m.to(dtype) for m in stack.mips))


# ---------------------------------------------------------------------------
# Mip pyramids and trilinear sampling.
# ---------------------------------------------------------------------------


def downsample2(data):
    """One mip step of (..., H, W, 4): a 2 x 2 box filter with floor
    halving (an odd last row or column is dropped, as GL sizes its levels
    floor(size / 2)); a side of 1 stays 1.  Differentiable in ``data``."""
    h, w = data.shape[-3], data.shape[-2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    if h < 2 or w < 2:
        return data[..., :h2, :w2, :]
    d = data[..., :h2 * 2, :w2 * 2, :]
    d = d.reshape(d.shape[:-3] + (h2, 2, w2, 2, 4))
    return d.mean(dim=(-4, -2))


def build_mips(data, max_levels: int = 16) -> tuple:
    """The mip chain below the base level, (half, quarter, ...) down to
    1 x 1; plain torch, so the pyramid stays differentiable in the base
    texels."""
    mips = []
    cur = data
    while (cur.shape[-3] > 1 or cur.shape[-2] > 1) and len(mips) < max_levels:
        cur = downsample2(cur)
        mips.append(cur)
    return tuple(mips)


def with_mips(tex: Texture) -> Texture:
    return tex._replace(mips=build_mips(tex.data))


def stack_with_mips(stack: TextureStack) -> TextureStack:
    return stack._replace(mips=build_mips(stack.data))


def ensure_mips(background: Texture, tex: Optional[TextureStack] = None):
    """(background, tex) with their mips, built where a texture carries
    none (what a trilinear frame samples)."""
    if not background.mips:
        background = with_mips(background)
    if tex is not None and not tex.mips:
        tex = stack_with_mips(tex)
    return background, tex


def _flat_pyramid(levels):
    """The levels (each (..., h, w, 4)) as one buffer (..., sum h*w, 4) and
    per-level int64 tables of offset, width and height.  With the level
    chosen per lane, a sample is then one gather of four corners per level
    (the plainest form that picks a level per lane; a gather per level and
    a select would fetch every level for every lane)."""
    dev = levels[0].device
    dims = [(lv.shape[-3], lv.shape[-2]) for lv in levels]
    offsets = np.cumsum([0] + [h * w for h, w in dims[:-1]])
    buf = torch.cat([lv.reshape(lv.shape[:-3] + (h * w, 4))
                     for lv, (h, w) in zip(levels, dims)], dim=-2)

    def table(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    return (buf, table(offsets), table([w for _, w in dims]),
            table([h for h, _ in dims]))


def _bilinear_flat(buf, off, w, h, u, v, layer=None):
    """GL_LINEAR + GL_REPEAT sample of one level of a flat pyramid:
    ``off``, ``w``, ``h`` are each lane's level's entries; ``layer``
    indexes the stack when ``buf`` is (T, N, 4).  The arithmetic of
    :func:`_bilinear`."""
    x = u * w.to(torch.float32) - 0.5
    y = v * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    y1i = torch.remainder(y0i + 1, h)

    n = buf.shape[-2]
    flat = buf.reshape(-1, buf.shape[-1])
    base = off if layer is None else layer.to(torch.int64) * n + off

    def at(idx):
        # index_select: its backward is index_add_ (atomic adds on the
        # card), where flat[idx]'s sorts the indices and walks each run of
        # equal ones in one thread: a coarse level gathers one texel for
        # many lanes.
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + flat.shape[-1:]).to(torch.float32)

    c00 = at(base + y0i * w + x0i)
    c10 = at(base + y0i * w + x1i)
    c01 = at(base + y1i * w + x0i)
    c11 = at(base + y1i * w + x1i)
    top = c00 + fx * (c10 - c00)
    bot = c01 + fx * (c11 - c01)
    return top + fy * (bot - top)


def _trilinear(levels, u, v, lod, layer=None):
    """The two levels around ``lod`` (0 = base), clipped to the pyramid,
    blended by its fraction.  The clip is a max then a min, as jnp.clip is,
    so a tie splits its gradient the same way."""
    n = len(levels)
    buf, offs, ws, hs = _flat_pyramid(levels)
    lod = torch.minimum(torch.maximum(lod, lod.new_tensor(0.0)),
                        lod.new_tensor(float(n - 1)))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp_max(l0 + 1, n - 1)
    f = (lod - l0.to(torch.float32))[..., None]
    a = _bilinear_flat(buf, offs[l0], ws[l0], hs[l0], u, v, layer)
    b = _bilinear_flat(buf, offs[l1], ws[l1], hs[l1], u, v, layer)
    return a + f * (b - a)


def sample_texture_trilinear(tex: Texture, u, v, lod):
    """LOD-aware sample; equals :func:`sample_texture` at lod 0 or without
    mips."""
    if not tex.mips:
        return sample_texture(tex, u, v)
    return _trilinear((tex.data,) + tuple(tex.mips), u, v, lod)


def sample_stack_trilinear(stack: TextureStack, index, u, v, lod):
    """LOD-aware stack sample; equals :func:`sample_stack` at lod 0 or
    without mips."""
    if not stack.mips:
        return sample_stack(stack, index, u, v)
    idx = torch.clamp(index, 0, stack.data.shape[0] - 1)
    return _trilinear((stack.data,) + tuple(stack.mips), u, v, lod,
                      layer=torch.broadcast_to(idx, u.shape))


def screen_space_lod(tx, ty, valid=None, key=None):
    """GL-style implicit LOD from screen-space derivatives of the texel
    coordinates ``tx``, ``ty`` (level-0 texels, (H, W) over the image grid).
    Per screen axis the footprint is the L1 texel step to the nearer usable
    neighbour, forward or backward (robust across REPEAT seams); the LOD is
    log2 of the larger axis footprint, at least 0.  Neighbours come from
    ``torch.roll``, which wraps at the image's edges as ``jnp.roll`` does.

    ``valid``, ``key``: optional (H, W) masks; a neighbour is usable only
    where both lanes are valid and carry the same key (the same object),
    the analogue of GL's quad derivatives.  An axis with no usable
    neighbour has footprint 0 (the base level)."""
    inf = torch.tensor(float("inf"), device=tx.device)

    def step(dim, shift):
        d = (torch.abs(torch.roll(tx, shift, dim) - tx)
             + torch.abs(torch.roll(ty, shift, dim) - ty))
        if valid is not None:
            ok = valid & torch.roll(valid, shift, dim)
            if key is not None:
                ok = ok & (key == torch.roll(key, shift, dim))
            d = torch.where(ok, d, inf)
        return d

    def axis_footprint(dim):
        d = torch.minimum(step(dim, -1), step(dim, 1))
        return torch.where(torch.isinf(d), 0.0, d)

    footprint = torch.maximum(axis_footprint(0), axis_footprint(1))
    lod = torch.log2(torch.maximum(footprint, footprint.new_tensor(1e-8)))
    return torch.maximum(lod, lod.new_tensor(0.0))
