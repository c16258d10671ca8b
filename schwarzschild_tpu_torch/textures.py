"""Textures and GL_LINEAR + GL_REPEAT sampling (counterpart of the loader
and bilinear samplers of ``schwarzschild_tpu.textures``).

Same conventions as the JAX package: images are flipped on load so row 0
is the BOTTOM row, a stack pads every image to the largest size with
(0, 0, 0, 0) texels, and per-texture true sizes rescale UVs.

Sampling is a plain four-corner gather per lane: on the GPU an indexed load
costs the same whatever its pattern, so none of the JAX package's gather
layouts (channel-major patches, the merged fetch atlas) is needed.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .config import resolve_device


class Texture(NamedTuple):
    """One RGBA texture: data (H, W, 4) float32 in [0, 1], row 0 = bottom."""

    data: torch.Tensor


class TextureStack(NamedTuple):
    """Padded texture array + per-texture true sizes."""

    data: torch.Tensor  # (T, Hmax, Wmax, 4) float32
    sizes: torch.Tensor  # (T, 2) float32 — (width, height)
    max_size: torch.Tensor  # (2,) float32 — (Wmax, Hmax)


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
