"""Scene description packed into struct-of-arrays tensors (counterpart of
``schwarzschild_tpu.scene``).

The user-facing dataclasses and their defaults are the JAX package's; the
``*SoA`` NamedTuples hold torch tensors with the same field names, shapes
and dtypes (float32, int32, bool), so a JAX scene converts field by field
(``convert.scene``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import resolve_device

# Object type codes (black_hole.frag:162-171).
OBJECT_TYPE_TEST_RAY_CURVED = -99
OBJECT_TYPE_TEST_RAY_FLAT = -98
OBJECT_TYPE_SPECIAL = -42  # the black-hole horizon sphere
OBJECT_TYPE_SPHERE = 0
OBJECT_TYPE_PLANE = 1
OBJECT_TYPE_DISK = 2
OBJECT_TYPE_HOLLOW_DISK = 3
OBJECT_TYPE_CYLINDER = 4
OBJECT_TYPE_RECTANGLE = 5
OBJECT_TYPE_BOX = 6

_IDENTITY = np.eye(3, dtype=np.float32)


def _axes(value) -> np.ndarray:
    a = np.asarray(value, np.float32)
    if a.shape != (3, 3):
        raise ValueError(f"axes must be (3,3) column frame, got {a.shape}")
    return a


def to_device(tree, device):
    """Move every tensor of a NamedTuple tree (Scene, Camera, Texture, ...)
    to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, tuple):
        return tuple(to_device(x, device) for x in tree)
    return tree


@dataclass(eq=False)
class Material:
    """Phong material (material.h:53-64)."""

    color: Tuple[float, float, float, float] = (0.5, 0.0, 0.5, 1.0)
    ambient: float = 0.1
    diffuse: float = 0.9
    specular: float = 0.5
    shininess: float = 32.0
    texture_index: int = -1
    normal_map_index: int = -1
    invert_uv_x: bool = False
    invert_uv_y: bool = False
    swap_uvs: bool = False
    double_sided_normals: bool = True
    flip_normals: bool = False


DEFAULT_MATERIAL = Material()


@dataclass(eq=False)
class Light:
    """Point light (light.h:11-13, light.cpp:4)."""

    pos: Tuple[float, float, float] = (10.0, 10.0, 10.0)
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 2.5
    attenuation_constant: float = 1.0
    attenuation_linear: float = 0.09
    attenuation_quadratic: float = 0.032


@dataclass(eq=False)
class _Primitive:
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axes: np.ndarray = field(default_factory=lambda: _IDENTITY.copy())
    material: Optional[Material] = None


@dataclass(eq=False)
class Sphere(_Primitive):
    radius: float = 1.0


@dataclass(eq=False)
class Plane(_Primitive):
    texture_offset: Tuple[float, float] = (0.0, 0.0)
    texture_size: Tuple[float, float] = (1.0, 1.0)
    repeat_texture: bool = True


@dataclass(eq=False)
class Disk(Plane):
    radius: float = 1.0


@dataclass(eq=False)
class HollowDisk(Plane):
    inner_radius: float = 2.5
    outer_radius: float = 5.0


@dataclass(eq=False)
class LateralCylinder(_Primitive):
    height: float = 5.0
    radius: float = 1.0


@dataclass(eq=False)
class Rectangle(Plane):
    width: float = 1.0
    height: float = 1.0


@dataclass(eq=False)
class Box(_Primitive):
    width: float = 1.0
    depth: float = 1.0
    height: float = 1.0


class MaterialsSoA(NamedTuple):
    color: torch.Tensor  # (M, 4)
    ambient: torch.Tensor  # (M,)
    diffuse: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor
    texture_index: torch.Tensor  # (M,) int32
    normal_map_index: torch.Tensor  # (M,) int32
    invert_uv_x: torch.Tensor  # (M,) bool
    invert_uv_y: torch.Tensor
    swap_uvs: torch.Tensor
    double_sided_normals: torch.Tensor
    flip_normals: torch.Tensor


class LightsSoA(NamedTuple):
    pos: torch.Tensor  # (L, 3)
    color: torch.Tensor  # (L, 3)
    intensity: torch.Tensor  # (L,)
    attenuation_constant: torch.Tensor
    attenuation_linear: torch.Tensor
    attenuation_quadratic: torch.Tensor


class SpheresSoA(NamedTuple):
    pos: torch.Tensor  # (N, 3)
    axes: torch.Tensor  # (N, 3, 3)
    radius: torch.Tensor  # (N,)
    mat_idx: torch.Tensor  # (N,) int32


class PlanesSoA(NamedTuple):
    pos: torch.Tensor
    axes: torch.Tensor
    texture_offset: torch.Tensor  # (N, 2)
    texture_size: torch.Tensor  # (N, 2)
    repeat_texture: torch.Tensor  # (N,) bool
    mat_idx: torch.Tensor


class DisksSoA(NamedTuple):
    pos: torch.Tensor
    axes: torch.Tensor
    radius: torch.Tensor
    mat_idx: torch.Tensor


class HollowDisksSoA(NamedTuple):
    pos: torch.Tensor
    axes: torch.Tensor
    inner_radius: torch.Tensor
    outer_radius: torch.Tensor
    mat_idx: torch.Tensor


class CylindersSoA(NamedTuple):
    pos: torch.Tensor
    axes: torch.Tensor
    height: torch.Tensor
    radius: torch.Tensor
    mat_idx: torch.Tensor


class RectanglesSoA(NamedTuple):
    pos: torch.Tensor
    axes: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    mat_idx: torch.Tensor


class BoxesSoA(NamedTuple):
    """Boxes as their 6 face rectangles (bot, top, front, back, left,
    right) plus the 4x3 cube-map atlas offsets (black_hole.frag:586-692)."""

    face_pos: torch.Tensor  # (N, 6, 3)
    face_axes: torch.Tensor  # (N, 6, 3, 3)
    face_width: torch.Tensor  # (N, 6)
    face_height: torch.Tensor  # (N, 6)
    atlas_offset: torch.Tensor  # (6, 2)
    mat_idx: torch.Tensor  # (N,) int32


class Scene(NamedTuple):
    materials: MaterialsSoA
    lights: LightsSoA
    spheres: SpheresSoA
    planes: PlanesSoA
    disks: DisksSoA
    hollow_disks: HollowDisksSoA
    cylinders: CylindersSoA
    rectangles: RectanglesSoA
    boxes: BoxesSoA


_BOX_ATLAS_OFFSETS = np.array(
    [[1.0, 0.0], [1.0, 2.0], [1.0, 1.0], [3.0, 1.0], [0.0, 1.0], [2.0, 1.0]],
    np.float32,
)


def box_faces(pos, axes, width, depth, height):
    """The 6 face rectangles of a box (black_hole.frag:587-649), in numpy:
    (face_pos (6,3), face_axes (6,3,3), face_width (6,), face_height (6,))."""
    pos = np.asarray(pos, np.float32)
    axes = np.asarray(axes, np.float32)
    ax, ay, az = axes[:, 0], axes[:, 1], axes[:, 2]

    def frame(c0, c1, c2):
        return np.stack([c0, c1, c2], axis=-1)

    faces = [
        (pos + az * depth, frame(ax, -ay, -az), width, depth),  # bot
        (pos + ay * height, axes, width, depth),  # top
        (pos + ax * 0.0 + ay * height + az * depth, frame(ax, az, -ay),
         width, height),  # front
        (pos + ax * width + ay * height, frame(-ax, -az, -ay),
         width, height),  # back
        (pos + ay * height, frame(az, -ax, -ay), depth, height),  # left
        (pos + ax * width + ay * height + az * depth, frame(-az, ax, -ay),
         depth, height),  # right
    ]
    fp = np.stack([f[0] for f in faces])
    fa = np.stack([f[1] for f in faces])
    fw = np.array([f[2] for f in faces], np.float32)
    fh = np.array([f[3] for f in faces], np.float32)
    return fp, fa, fw, fh


def build_scene(objects: Sequence[_Primitive] = (),
                lights: Sequence[Light] = (), device=None) -> Scene:
    """Pack dataclass objects into a :class:`Scene` of tensors on
    ``device`` (default: the card; materials deduplicated by identity,
    objectLoader.cpp:83-92)."""
    device = resolve_device(device)
    materials: list[Material] = []
    mat_ids: dict[int, int] = {}

    def mat_index(m: Optional[Material]) -> int:
        m = m if m is not None else DEFAULT_MATERIAL
        if id(m) not in mat_ids:
            mat_ids[id(m)] = len(materials)
            materials.append(m)
        return mat_ids[id(m)]

    by_type: dict[type, list] = {cls: [] for cls in (
        Sphere, Plane, Disk, HollowDisk, LateralCylinder, Rectangle, Box)}
    for obj in objects:
        for cls in (Sphere, Disk, HollowDisk, Rectangle, Plane,
                    LateralCylinder, Box):
            if isinstance(obj, cls):
                by_type[cls].append(obj)
                break
        else:
            raise TypeError(f"unsupported object {type(obj)}")

    def f32(rows, shape):
        a = np.array(rows, np.float32).reshape((len(rows),) + shape)
        return torch.as_tensor(a, device=device)

    def i32(rows):
        return torch.as_tensor(np.array(rows, np.int32).reshape(len(rows)),
                               device=device)

    def b8(rows):
        return torch.as_tensor(np.array(rows, bool).reshape(len(rows)),
                               device=device)

    def common(objs):
        return (f32([o.pos for o in objs], (3,)),
                f32([_axes(o.axes) for o in objs], (3, 3)),
                i32([mat_index(o.material) for o in objs]))

    sp = by_type[Sphere]
    s_pos, s_axes, s_mi = common(sp)
    spheres = SpheresSoA(s_pos, s_axes, f32([o.radius for o in sp], ()), s_mi)

    pl = by_type[Plane]
    p_pos, p_axes, p_mi = common(pl)
    planes = PlanesSoA(p_pos, p_axes,
                       f32([o.texture_offset for o in pl], (2,)),
                       f32([o.texture_size for o in pl], (2,)),
                       b8([o.repeat_texture for o in pl]), p_mi)

    dk = by_type[Disk]
    d_pos, d_axes, d_mi = common(dk)
    disks = DisksSoA(d_pos, d_axes, f32([o.radius for o in dk], ()), d_mi)

    hd = by_type[HollowDisk]
    h_pos, h_axes, h_mi = common(hd)
    hollow_disks = HollowDisksSoA(h_pos, h_axes,
                                  f32([o.inner_radius for o in hd], ()),
                                  f32([o.outer_radius for o in hd], ()), h_mi)

    cy = by_type[LateralCylinder]
    c_pos, c_axes, c_mi = common(cy)
    cylinders = CylindersSoA(c_pos, c_axes, f32([o.height for o in cy], ()),
                             f32([o.radius for o in cy], ()), c_mi)

    rc = by_type[Rectangle]
    r_pos, r_axes, r_mi = common(rc)
    rectangles = RectanglesSoA(r_pos, r_axes, f32([o.width for o in rc], ()),
                               f32([o.height for o in rc], ()), r_mi)

    bx = by_type[Box]
    faces = [box_faces(o.pos, _axes(o.axes), o.width, o.depth, o.height)
             for o in bx]
    boxes = BoxesSoA(
        face_pos=f32([fd[0] for fd in faces], (6, 3)),
        face_axes=f32([fd[1] for fd in faces], (6, 3, 3)),
        face_width=f32([fd[2] for fd in faces], (6,)),
        face_height=f32([fd[3] for fd in faces], (6,)),
        atlas_offset=torch.as_tensor(_BOX_ATLAS_OFFSETS, device=device),
        mat_idx=i32([mat_index(o.material) for o in bx]),
    )

    if not materials:
        mat_index(DEFAULT_MATERIAL)
    mats = MaterialsSoA(
        color=f32([m.color for m in materials], (4,)),
        ambient=f32([m.ambient for m in materials], ()),
        diffuse=f32([m.diffuse for m in materials], ()),
        specular=f32([m.specular for m in materials], ()),
        shininess=f32([m.shininess for m in materials], ()),
        texture_index=i32([m.texture_index for m in materials]),
        normal_map_index=i32([m.normal_map_index for m in materials]),
        invert_uv_x=b8([m.invert_uv_x for m in materials]),
        invert_uv_y=b8([m.invert_uv_y for m in materials]),
        swap_uvs=b8([m.swap_uvs for m in materials]),
        double_sided_normals=b8([m.double_sided_normals for m in materials]),
        flip_normals=b8([m.flip_normals for m in materials]),
    )

    lt = list(lights)
    lights_soa = LightsSoA(
        pos=f32([l.pos for l in lt], (3,)),
        color=f32([l.color for l in lt], (3,)),
        intensity=f32([l.intensity for l in lt], ()),
        attenuation_constant=f32([l.attenuation_constant for l in lt], ()),
        attenuation_linear=f32([l.attenuation_linear for l in lt], ()),
        attenuation_quadratic=f32([l.attenuation_quadratic for l in lt], ()),
    )
    return Scene(materials=mats, lights=lights_soa, spheres=spheres,
                 planes=planes, disks=disks, hollow_disks=hollow_disks,
                 cylinders=cylinders, rectangles=rectangles, boxes=boxes)


def empty_scene(device=None) -> Scene:
    return build_scene([], [], device=device)
