"""State carried over from the JAX package.

Each function takes one of the JAX package's objects with its array leaves
already turned into numpy arrays by the caller (for example
``jax.tree.map(np.asarray, scene)``) and returns this package's twin, field
by field, with the same shapes and dtypes, on ``device`` (default: the
card).  Nothing here imports jax: the
objects are read by attribute name only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import Camera
from .config import RenderConfig, resolve_device
from .geometry import Transform
from .intersect import TestRay
from .scene import (
    BoxesSoA,
    CylindersSoA,
    DisksSoA,
    HollowDisksSoA,
    LightsSoA,
    MaterialsSoA,
    PlanesSoA,
    RectanglesSoA,
    Scene,
    SpheresSoA,
)
from .textures import FetchAtlas, Texture, TextureStack

_SCENE_PARTS = (MaterialsSoA, LightsSoA, SpheresSoA, PlanesSoA, DisksSoA,
                HollowDisksSoA, CylindersSoA, RectanglesSoA, BoxesSoA)


def _tensor(x, device):
    x = np.array(x)
    if x.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(x.astype(np.float32)).to(
            resolve_device(device), torch.bfloat16)
    return torch.from_numpy(x).to(resolve_device(device))


def _fields(cls, src, device):
    return cls(*(_tensor(getattr(src, f), device) for f in cls._fields))


def scene(src, device=None) -> Scene:
    return Scene(*(_fields(cls, getattr(src, name), device)
                   for name, cls in zip(Scene._fields, _SCENE_PARTS)))


def camera(src, device=None) -> Camera:
    return _fields(Camera, src, device)


def transform(src, device=None) -> Transform:
    return _fields(Transform, src, device)


def viewer_state(src):
    """A JAX ``viewer.ViewerState`` as this package's, its camera on the
    CPU as the viewer keeps it."""
    from .viewer import ViewerState

    return ViewerState(cam=camera(src.cam, device="cpu"),
                       raytrace_type=int(src.raytrace_type),
                       test_ray=bool(src.test_ray), flyby_t=src.flyby_t,
                       quit=bool(src.quit))


def _with_mip_levels(cls, src, device):
    """A texture or stack: its arrays, and its mip levels (a tuple)."""
    arrays = cls(*(_tensor(getattr(src, f), device)
                   for f in cls._fields if f != "mips"))
    return arrays._replace(mips=tuple(
        _tensor(m, device) for m in getattr(src, "mips", ())))


def texture(src, device=None) -> Texture:
    return _with_mip_levels(Texture, src, device)


def texture_stack(src, device=None) -> TextureStack:
    return _with_mip_levels(TextureStack, src, device)


def fetch_atlas(src, device=None) -> FetchAtlas:
    """A JAX ``textures.FetchAtlas`` (data (G, 128) float32 or bfloat16,
    wrap, base, gpr) as this package's: the same storage, copied."""
    return _fields(FetchAtlas, src, device)


def render_config(src) -> RenderConfig:
    return RenderConfig(**{f.name: getattr(src, f.name)
                           for f in dataclasses.fields(RenderConfig)})


def test_ray(src, device=None) -> TestRay:
    """A JAX ``intersect.TestRay`` (points, num_points int32, flat_origin,
    flat_dir) as this package's."""
    return _fields(TestRay, src, device)
