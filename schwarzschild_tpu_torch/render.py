"""Noise fields and image output (counterpart of the parts of
``schwarzschild_tpu.render`` the fast renderers use).

PNG files are written by :func:`encode_png`, on the standard library's
zlib alone, so no frame writer needs an imaging package.

The integer hashes are bit-equal to the JAX package's uint32 lowbias32
pipeline.  torch has no full uint32 arithmetic, so the hash runs in int64
with every product reduced mod 2^32; a product of two 32-bit values would
overflow int64, so :func:`_mul32` splits the constant into 16-bit halves.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .config import resolve_device

_M32 = 0xFFFFFFFF
_INV_2_32 = 2.3283064365386963e-10  # 1 / 2^32


def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a 32-bit constant."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _lowbias32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * _INV_2_32


def _seed_term(seed: int) -> int:
    return ((seed & _M32) * 0x9E3779B9) & _M32


def glsl_rand(co):
    """fract(sin(dot(co, (12.9898, 78.233))) * 43758.5453) in f32
    (black_hole.frag:839-841).  Not portable across backends: 1-ulp sin()
    differences change the mask (the JAX package documents the same)."""
    s = torch.sin(co[..., 0] * 12.9898 + co[..., 1] * 78.233)
    x = s * 43758.5453
    return x - torch.floor(x)


def pixel_hash_rand(width, height, seed=0, device=None):
    """Per-pixel uniform in [0, 1) from the lowbias32 hash of the pixel
    index mixed with the seed; bit-equal to the JAX package's."""
    device = resolve_device(device)
    y = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    x = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    h = (y * width + x + _seed_term(seed)) & _M32
    return _lowbias32(h)


def tile_hash_rand(width, height, seed=0, tile=(8, 128), device=None):
    """Tile-coherent uniform in [0, 1): every pixel of one (tile_h, tile_w)
    tile carries the same hash; bit-equal to the JAX package's."""
    device = resolve_device(device)
    th, tw = tile
    ty = torch.arange(height, dtype=torch.int64, device=device)[:, None] // th
    tx = torch.arange(width, dtype=torch.int64, device=device)[None, :] // tw
    n_tx = -(-width // tw)
    h = (ty * n_tx + tx + _seed_term(seed)) & _M32
    return _lowbias32(h)


def to_uint8(img):
    """Clamp and quantize like the display framebuffer."""
    return (torch.clamp(img[..., :3], 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(rgb_uint8, compress_level: int = 6) -> bytes:
    """An (H, W, 3) uint8 image (numpy or a tensor) as the bytes of an 8-bit
    RGB PNG file: every row with filter 0 (none), one zlib stream at
    ``compress_level`` (0-9; zlib releases the GIL while it compresses)."""
    if isinstance(rgb_uint8, torch.Tensor):
        rgb_uint8 = rgb_uint8.cpu().numpy()
    img = np.ascontiguousarray(rgb_uint8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: the filter byte
    raw[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(),
                                                compress_level))
            + _png_chunk(b"IEND", b""))


def save_png(img, path, compress_level: int = 6):
    """Write an (H, W, 3+) float image, quantized by :func:`to_uint8`, as a
    PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img), compress_level))
