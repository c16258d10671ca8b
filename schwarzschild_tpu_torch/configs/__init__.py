"""Checked-in scenes and render configurations (counterpart of
``schwarzschild_tpu.configs``).

Texture assets are read from the reference app's asset directory named by
``$SCHWARZSCHILD_ASSETS``; without them the procedural fallbacks below run
the same numpy steps as the JAX package's, so both packages get bit-equal
textures.  (The JAX package also looks in a default directory when the
variable is unset; set it to give both packages the same assets.)  Every
function takes an optional ``device``; by default the tensors go to the card
(``config.DEFAULT_DEVICE``).
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional

import numpy as np

from .. import camera as cam_mod
from ..config import RenderConfig
from ..geometry import angle_axis, quat_to_axes
from ..scene import (
    Box,
    Disk,
    HollowDisk,
    LateralCylinder,
    Light,
    Material,
    Rectangle,
    Sphere,
    build_scene,
)
from ..textures import (
    Texture,
    TextureStack,
    from_array,
    load_image,
    load_texture,
    stack_textures,
)


def asset_dir() -> Optional[Path]:
    root = os.environ.get("SCHWARZSCHILD_ASSETS")
    return Path(root) if root else None


def _asset(*parts) -> Optional[Path]:
    """An asset file if the asset directory holds it, else None."""
    root = asset_dir()
    p = None if root is None else root.joinpath(*parts)
    return p if p is not None and p.exists() else None


def _procedural_checker(size=600, tiles=10) -> np.ndarray:
    """uv_checker stand-in: (H, W, 3) uint8, row 0 = top."""
    y, x = np.mgrid[0:size, 0:size]
    c = (((x * tiles // size) + (y * tiles // size)) % 2).astype(np.uint8)
    img = np.stack([c * 200 + 55, 255 - c * 200, np.full_like(c, 128)], -1)
    return img.astype(np.uint8)


def _procedural_sky(h=512, w=1024) -> np.ndarray:
    """Equirect gradient + star-ish dots stand-in for the Milky Way."""
    v = np.linspace(0, 1, h)[:, None]
    u = np.linspace(0, 1, w)[None, :]
    base = (20 + 60 * np.exp(-((v - 0.5) ** 2) / 0.02)) * np.ones((h, w))
    rng = np.random.default_rng(0)
    stars = (rng.random((h, w)) > 0.999).astype(np.float64) * 200.0
    g = np.clip(base + stars + 10 * np.sin(12 * math.pi * u), 0, 255)
    return np.stack([g, g, np.clip(g * 1.2, 0, 255)], -1).astype(np.uint8)


def background_texture(quality: str = "2k", device=None) -> Texture:
    path = _asset("textures", "background", f"{quality}.jpg")
    if path is not None:
        return load_texture(path, device=device)
    return from_array(_procedural_sky().astype(np.float64) / 255.0,
                      device=device)


def demo_texture_stack(device=None) -> TextureStack:
    """uv_checker + cubemap (main.cpp:210-218)."""
    raws = []
    for name in ("uv_checker.jpg", "cubemap.png"):
        p = _asset("textures", name)
        raws.append(load_image(p) if p is not None else _procedural_checker())
    return stack_textures(raws, device=device)


def planet_texture_stack(device=None) -> TextureStack:
    """Planet textures for config 3: earth day, earth night, earth normal,
    moon, sun, saturn ring."""
    names = ["2k_earth_daymap.jpg", "2k_earth_nightmap.jpg",
             "2k_earth_normal_map.jpg", "2k_moon.jpg", "2k_sun.jpg",
             "2k_saturn_ring_alpha.png"]
    raws = []
    for n in names:
        p = _asset("textures", n)
        raws.append(load_image(p) if p is not None
                    else _procedural_checker(512, 8))
    return stack_textures(raws, device=device)


def demo_camera(device=None) -> cam_mod.Camera:
    """Camera at (0, 2, 15) looking at the origin (main.cpp:222)."""
    pos = np.array([0.0, 2.0, 15.0])
    return cam_mod.make_camera(pos, forward=-pos / np.linalg.norm(pos),
                               right=(1.0, 0.0, 0.0), device=device)


def demo_scene(device=None):
    """The reference demo scene (main.cpp:221-268): textured sphere, tilted
    disk, accretion disk, cylinder, rectangle, cubemapped box, one light."""
    mat1 = Material(texture_index=0)
    mat2 = Material(texture_index=1)
    disk_axes = quat_to_axes(angle_axis(
        math.pi / 4.0, np.array([1.0, 1.0, 1.0]) / math.sqrt(3.0))).numpy()
    objects = [
        Sphere(pos=(-10.0, 0.0, 0.0), material=mat1),
        Disk(pos=(0.0, 0.0, -10.0), axes=disk_axes, radius=2.0, material=mat1),
        HollowDisk(material=mat1),
        LateralCylinder(pos=(0.0, 10.0, 0.0), height=5.0, radius=2.0,
                        material=mat1),
        Rectangle(pos=(0.0, 0.0, 10.0), width=3.0, height=2.0, material=mat1),
        Box(pos=(10.0, 0.0, 0.0), material=mat2),
    ]
    return build_scene(objects, [Light(intensity=8.0)], device=device)


def config1_flat(device=None):
    """Flat-space 256x256: BH sphere + equirect sky, single frame."""
    cfg = RenderConfig(width=256, height=256, raytrace_type=cam_mod.FLAT,
                       percent_black=-1.0)
    sc = build_scene([], [Light(intensity=8.0)], device=device)
    return dict(scene=sc, camera=demo_camera(device), cfg=cfg,
                background=background_texture(device=device), tex=None)


def config2_curved(device=None):
    """Curved 512x512 RK4 march: horizon + sky, fixed camera."""
    cfg = RenderConfig(width=512, height=512, percent_black=-1.0)
    sc = build_scene([], [Light(intensity=8.0)], device=device)
    return dict(scene=sc, camera=demo_camera(device), cfg=cfg,
                background=background_texture(device=device), tex=None)


def _orbiting_planets_scene(device=None):
    """Config 3 scene: accretion disk + textured planets around the hole."""
    earth = Material(texture_index=0, normal_map_index=2)
    moon = Material(texture_index=3)
    sun = Material(texture_index=4, ambient=1.0, diffuse=0.0, specular=0.0)
    disk_mat = Material(texture_index=5, double_sided_normals=True)
    objects = [
        HollowDisk(material=disk_mat),
        Sphere(pos=(8.0, 0.5, -6.0), radius=1.2, material=earth),
        Sphere(pos=(-7.0, -0.5, 7.0), radius=0.6, material=moon),
        Sphere(pos=(0.0, 4.0, -14.0), radius=2.0, material=sun),
    ]
    return build_scene(objects, [Light(pos=(0.0, 12.0, 8.0), intensity=8.0)],
                       device=device)


def config3_full_scene(device=None):
    """Full scene 1024x1024 with lensing + planet textures."""
    cfg = RenderConfig(width=1024, height=1024, percent_black=-1.0)
    return dict(scene=_orbiting_planets_scene(device),
                camera=demo_camera(device), cfg=cfg,
                background=background_texture(device=device),
                tex=planet_texture_stack(device))


def config4_animation(n_frames=16, device=None):
    """Animated hyperbolic trajectory, 1920x1080, split-screen flat/curved:
    ``times`` are the frames' normalized trajectory times and
    ``trajectory`` the conic's distances (animation.render_trajectory's
    arguments)."""
    cfg = RenderConfig(width=1920, height=1080,
                       raytrace_type=cam_mod.HALF_WIDTH,
                       curved_percentage=0.5, percent_black=-1.0)
    times = np.linspace(0.0, 1.0, n_frames)
    return dict(scene=demo_scene(device), cfg=cfg,
                background=background_texture(device=device),
                tex=demo_texture_stack(device), times=times,
                trajectory=dict(initial_distance=30.0, closest_distance=10.0))


def config5_inverse(device=None):
    """Inverse rendering at 128x128: optimize r_s + camera pose + the disk
    texture (slot 5 of the planet stack, the hollow disk's ring)."""
    cfg = RenderConfig(width=128, height=128, percent_black=-1.0,
                       checkpoint_every=10)
    return dict(scene=_orbiting_planets_scene(device),
                camera=demo_camera(device), cfg=cfg,
                background=background_texture(device=device),
                tex=planet_texture_stack(device))
