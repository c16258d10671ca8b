"""schwarzschild_tpu_torch — the Schwarzschild raytracer on PyTorch + CUDA.

The PyTorch counterpart of the JAX package ``schwarzschild_tpu``, module
for module, with the three Pallas kernels (the two geodesic marches and
the scene march's adjoint) written by hand in CUDA C++ for Hopper
(csrc/).  ``render`` is the dense differentiable renderer, plain PyTorch,
as the JAX package's is plain jnp.  Tensors keep the JAX package's layouts; every
function works on the device its inputs are on.  On a CPU tensor the march
wrappers run their plain PyTorch versions; on a CUDA tensor they launch the
kernels, which are built with nvcc at first use.
"""

from .config import CURVED, FLAT, HALF_HEIGHT, HALF_WIDTH, RenderConfig
from .camera import Camera, hyperbolic_trajectory, look_at, make_camera
from .scene import (
    Box,
    Disk,
    HollowDisk,
    LateralCylinder,
    Light,
    Material,
    Plane,
    Rectangle,
    Scene,
    Sphere,
    build_scene,
    empty_scene,
    to_device,
)
from .intersect import Hit, TestRay, intersect_scene
from .render import encode_png, render, save_png, to_uint8
from .geometry import Transform, make_transform
from .shading import get_background, shade
from .textures import (
    Texture,
    TextureStack,
    build_mips,
    from_array,
    load_texture,
    load_texture_array,
    solid_color_texture,
    stack_textures,
    stack_with_dtype,
    stack_with_mips,
    with_dtype,
    with_mips,
)
from .kernel import render_horizon_sky
from .kernel_scene import render_fast, render_fast_auto
from .animation import render_trajectory, write_video

__version__ = "0.1.0"
