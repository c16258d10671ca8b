"""Frozen render configuration (counterpart of ``schwarzschild_tpu.config``).

Same fields and defaults as the JAX package, so a configuration converts
field by field (``convert.render_config``).  The raytrace-mode constants live
here and are re-exported by ``camera``.

``DEFAULT_DEVICE`` is where the package's builders (configs, scenes,
cameras, textures, pixel grids, noise fields, ``convert``) put their tensors
when no ``device`` is given: the CUDA card.  Pass ``device="cpu"`` for the
plain versions on the CPU; nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import dataclasses
import math

import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device``, or :data:`DEFAULT_DEVICE` when it is None."""
    return DEFAULT_DEVICE if device is None else torch.device(device)

# Raytrace modes (black_hole.frag:32-35, camera.h:14-19).
CURVED = 0
FLAT = 1
HALF_WIDTH = 2
HALF_HEIGHT = 3


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280  # main.cpp:25
    height: int = 720  # main.cpp:26
    max_steps: int = 100  # main.cpp:68
    max_revolutions: int = 2  # main.cpp:69
    u_f: float = 0.01  # black_hole.frag:22
    # Stochastic pixel skip (frag:39,879-881); < 0 disables skipping.
    percent_black: float = 0.75  # main.cpp:66
    # "hash" | "tile" | "glsl" | "prng" (jax.random's threefry field) | "none"
    noise_mode: str = "hash"
    noise_seed: int = 0
    noise_tile: tuple = (16, 128)
    raytrace_type: int = CURVED  # frag:36
    curved_percentage: float = 0.5  # frag:37
    crosshair: bool = False  # frag:24
    # Kept for field parity with the JAX package; only its gradient path
    # reads it.
    checkpoint_every: int = 10
    # > 0 smooths the shadow silhouette (see kernel_scene.render_fast).
    horizon_softness: float = 0.0
    # "bilinear" (level-0 GL_LINEAR, the reference's behaviour) or
    # "trilinear" (mips at a screen-space LOD; the renderers build the mips
    # of a texture that carries none).
    texture_filter: str = "bilinear"
    test_ray_capacity: int = 101

    @property
    def max_angle(self) -> float:
        return 2.0 * float(self.max_revolutions) * math.pi
