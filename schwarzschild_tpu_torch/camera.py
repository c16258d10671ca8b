"""Pinhole camera and the hyperbolic flyby (counterpart of
``schwarzschild_tpu.camera``).

A :class:`Camera` is a NamedTuple of tensors (pos (3,), axes (3, 3) with
columns (right, up, forward), fov in degrees).  Rays come back in the JAX
package's layout: origin and direction as (H, W, 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import geometry as geo
from .config import CURVED, FLAT, HALF_HEIGHT, HALF_WIDTH  # noqa: F401
from .config import resolve_device

DEFAULT_FOV = 90.0  # degrees, camera.h:7
HYPERBOLIC_TRAJECTORY_DURATION = 5.0  # seconds, camera.h:10
# In-plane basis of the flyby conic (camera.h:11-12).
HYPERBOLIC_BASE_X = (0.0, 0.0, -1.0)
HYPERBOLIC_BASE_Y = (math.cos(math.pi / 10.0), math.sin(math.pi / 10.0), 0.0)


class Camera(NamedTuple):
    pos: torch.Tensor
    axes: torch.Tensor
    fov: torch.Tensor

    @property
    def right(self):
        return self.axes[..., :, 0]

    @property
    def up(self):
        return self.axes[..., :, 1]

    @property
    def forward(self):
        return self.axes[..., :, 2]


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_camera(pos, forward=None, right=None, fov=DEFAULT_FOV, device=None):
    """Build a camera like Camera(pos, forward, right) (camera.cpp:7-11):
    right and forward normalized, up = cross(right, forward); on ``device``
    (default: the card)."""
    pos = _f32(pos, resolve_device(device))
    if forward is None:
        axes = torch.eye(3, dtype=torch.float32, device=pos.device)
    else:
        f = geo.normalize(_f32(forward, pos.device))
        r = geo.normalize(_f32(right, pos.device))
        u = geo.normalize(geo.cross(r, f))
        axes = torch.stack([r, u, f], dim=-1)
    return Camera(pos=pos, axes=axes, fov=_f32(fov, pos.device))


def look_at(cam: Camera, point=(0.0, 0.0, 0.0)) -> Camera:
    """Face ``point`` with the world-up reference (camera.cpp:35-39)."""
    point = _f32(point, cam.pos.device)
    world_up = _f32([0.0, 1.0, 0.0], cam.pos.device)
    f = geo.normalize(point - cam.pos)
    r = geo.normalize(geo.cross(f, world_up))
    u = geo.normalize(geo.cross(r, f))
    return cam._replace(axes=torch.stack([r, u, f], dim=-1))


def hyperbolic_trajectory(cam: Camera, initial_distance, closest_distance,
                          time) -> Camera:
    """Conic-section flyby pose at normalized ``time`` in [0, 1]
    (camera.cpp:20-33), facing the origin.  f32 on the camera's device and
    differentiable in every argument."""
    dev = cam.pos.device
    initial_distance = _f32(initial_distance, dev)
    closest_distance = _f32(closest_distance, dev)
    time = _f32(time, dev)

    closest_sq = closest_distance**2
    a = -closest_sq / (-initial_distance + 2.0 * closest_distance)
    c = closest_distance + a
    b = torch.sqrt(closest_sq + 2.0 * a * closest_distance)

    eased = geo.true_div(1.0 - torch.cos(time * math.pi), 2.0)
    x = -initial_distance + 2.0 * eased * initial_distance
    y = c - a * torch.sqrt(1.0 + (x / b) ** 2)

    pos = (x * _f32(HYPERBOLIC_BASE_X, dev)
           + y * _f32(HYPERBOLIC_BASE_Y, dev))
    return look_at(cam._replace(pos=pos))


def pixel_grid(width: int, height: int, device=None):
    """NDC of pixel centres: (u, v), each (height, width), row 0 = top, on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    u = geo.true_div(2.0 * (xs + 0.5), float(width)) - 1.0
    v = 1.0 - geo.true_div(2.0 * (ys + 0.5), float(height))
    return (u[None, :].expand(height, width).contiguous(),
            v[:, None].expand(height, width).contiguous())


def generate_rays(cam: Camera, u, v, width, height):
    """Pinhole rays from NDC (black_hole.frag:859-863); returns
    (origin, direction), each (..., 3) on the device of ``u``."""
    fov = cam.fov.to(u.device)
    forward_len = 1.0 / torch.tan(geo.true_div(fov, 360.0) * math.pi)
    uv_vec = torch.stack(
        [u, v * (height / width), forward_len.expand(u.shape)], dim=-1)
    direction = geo.normalize(geo.mat_vec(cam.axes.to(u.device), uv_vec))
    origin = cam.pos.to(u.device).expand(direction.shape).contiguous()
    return origin, direction
