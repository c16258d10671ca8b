"""The per-pixel random fields behind the noise-skip mask (counterpart of
the noise functions of ``schwarzschild_tpu.render``).

The integer hashes are bit-equal to the JAX package's uint32 lowbias32
pipeline.  torch has no full uint32 arithmetic, so the hash runs in int64
with every product reduced mod 2^32; a product of two 32-bit values would
overflow int64, so :func:`_mul32` splits the constant into 16-bit halves.
"""

from __future__ import annotations

import torch

from .config import RenderConfig, resolve_device

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


def noise_field(cfg: RenderConfig, u_ndc, v_ndc):
    """The per-pixel random field behind the noise-skip mask
    (frag:879-881) for cfg's ``noise_mode``; zeros when noise is off."""
    dev = u_ndc.device
    if cfg.percent_black >= 0.0 and cfg.noise_mode != "none":
        if cfg.noise_mode == "glsl":
            uv_vec = torch.stack(
                [u_ndc, v_ndc * (cfg.height / cfg.width)], dim=-1)
            return glsl_rand(uv_vec)
        if cfg.noise_mode == "hash":
            return pixel_hash_rand(cfg.width, cfg.height, cfg.noise_seed,
                                   device=dev)
        if cfg.noise_mode == "tile":
            return tile_hash_rand(cfg.width, cfg.height, cfg.noise_seed,
                                  cfg.noise_tile, device=dev)
        if cfg.noise_mode == "prng":
            raise ValueError(
                "noise_mode='prng' draws from JAX's threefry generator, whose "
                "bits torch cannot reproduce; use 'hash', 'tile' or 'glsl'")
        raise ValueError(f"unknown noise_mode {cfg.noise_mode!r}")
    return torch.zeros(u_ndc.shape, device=dev)
