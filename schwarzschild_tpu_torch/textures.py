"""Textures, GL_LINEAR + GL_REPEAT sampling and mip pyramids (counterpart
of the loader, the bilinear samplers and the mip functions of
``schwarzschild_tpu.textures``).

Same conventions as the JAX package: images are flipped on load so row 0
is the BOTTOM row, a stack pads every image to the largest size with
(0, 0, 0, 0) texels, and per-texture true sizes rescale UVs.

Sampling is a plain four-corner gather per lane: on the GPU an indexed load
costs the same whatever its pattern, so none of the JAX package's gather
layouts (channel-major patches, the merged fetch atlas) is needed.

Mips are opt-in, beyond the reference: its min filter is GL_LINEAR, so GL
never samples the mipmaps it generates, and bilinear level 0 is the parity
target.  ``RenderConfig(texture_filter="trilinear")`` samples the pyramid
at a screen-space LOD (:func:`screen_space_lod`); the renderers build the
pyramid with :func:`build_mips` when a texture carries none.
"""

from __future__ import annotations

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
    depends on (``torch.lerp`` rounds differently)."""
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
    c00 = flat[base + y0i * w + x0i]
    c10 = flat[base + y0i * w + x1i]
    c01 = flat[base + y1i * w + x0i]
    c11 = flat[base + y1i * w + x1i]
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
            idx.shape + flat.shape[-1:])

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
