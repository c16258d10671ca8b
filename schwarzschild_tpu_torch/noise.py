"""The per-pixel random fields behind the noise-skip mask (counterpart of
the noise functions of ``schwarzschild_tpu.render``).

The integer hashes are bit-equal to the JAX package's uint32 lowbias32
pipeline, and :func:`prng_uniform` to ``jax.random.uniform`` of a
threefry key.  torch has no full uint32 arithmetic, so the hashes run in
int64 with every sum and product reduced mod 2^32; a product of two 32-bit
values would overflow int64, so :func:`_mul32` splits the constant into
16-bit halves.
"""

from __future__ import annotations

import numpy as np
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


def _lowbias32_np(h):
    """The lowbias32 pipeline on uint32 numpy arrays (wrapping)."""
    u32 = np.uint32
    with np.errstate(over="ignore"):
        h = h ^ (h >> u32(16))
        h = h * u32(0x7FEB352D)
        h = h ^ (h >> u32(15))
        h = h * u32(0x846CA68B)
        h = h ^ (h >> u32(16))
    return h.astype(np.float32) * np.float32(_INV_2_32)


def pixel_hash_rand_np(width, height, seed=0):
    """Numpy twin of :func:`pixel_hash_rand`, bit-equal: the field on the
    host, with no tensor made."""
    u32 = np.uint32
    y = np.broadcast_to(np.arange(height, dtype=np.int64)[:, None],
                        (height, width)).astype(u32)
    x = np.broadcast_to(np.arange(width, dtype=np.int64)[None, :],
                        (height, width)).astype(u32)
    with np.errstate(over="ignore"):
        h = y * u32(width) + x + u32(_seed_term(seed))
    return _lowbias32_np(h)


def tile_hash_rand_np(width, height, seed=0, tile=(16, 128)):
    """Numpy twin of :func:`tile_hash_rand`, bit-equal."""
    u32 = np.uint32
    th, tw = tile
    ty = np.broadcast_to(
        (np.arange(height, dtype=np.int64)[:, None] // th).astype(u32),
        (height, width))
    tx = np.broadcast_to(
        (np.arange(width, dtype=np.int64)[None, :] // tw).astype(u32),
        (height, width))
    n_tx = u32(-(-width // tw))
    with np.errstate(over="ignore"):
        h = ty * n_tx + tx + u32(_seed_term(seed))
    return _lowbias32_np(h)


# Threefry-2x32 (Salmon et al. 2011), 20 rounds, as jax._src.prng's
# _threefry2x32_lowering: rotations, the key-schedule parity constant.
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl32(x, d: int):
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 block function of the key (k1, k2) on the counter
    pairs (x1, x2), int64 tensors holding uint32 values; returns the two
    output words likewise."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ _THREEFRY_PARITY) & _M32)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl32(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_uniform(seed: int, shape, device=None):
    """``jax.random.uniform(jax.random.key(seed), shape)``, bit for bit:
    the key is (seed >> 32, seed & 0xFFFFFFFF) (prng.threefry_seed); each
    element's counter is its flat index as (hi, lo) words (iota_2x32_shape),
    its 32 bits the xor of the two output words (the partitionable
    layout, a function of the index alone, so any strip or tile of the
    field equals that part of the whole); the float keeps 23 of them as a
    mantissa in [1, 2), minus 1."""
    device = resolve_device(device)
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(seed >> 32, seed, idx >> 32, idx & _M32)
    mant = ((b1 ^ b2) >> 9) | 0x3F800000
    return (mant.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


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
            return prng_uniform(cfg.noise_seed, (cfg.height, cfg.width),
                                device=dev)
        raise ValueError(f"unknown noise_mode {cfg.noise_mode!r}")
    return torch.zeros(u_ndc.shape, device=dev)
