"""Vector and frame math (counterpart of ``schwarzschild_tpu.geometry``).

Conventions match the JAX package: right-handed, y-up world; a frame
("axes") is a 3x3 matrix whose COLUMNS are (right, up, forward).  Every
function broadcasts over leading batch dimensions of torch tensors.

Three-component sums are written out left to right, ``(a0 + a1) + a2``,
which is the order XLA's reduction takes, so results do not depend on how
torch vectorises a reduction over a dimension of three.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import resolve_device

EPSILON = 1e-7  # black_hole.frag:30

# numpy, as in the JAX package: a constant that lives on no device.
IDENTITY_AXES = np.eye(3, dtype=np.float32)


def _sum3(x):
    return x[..., 0] + x[..., 1] + x[..., 2]


def true_div(a, b):
    """``a / b`` rounded once on every device.  Given a Python number as the
    divisor, torch's CUDA kernel multiplies by the number's rounded
    reciprocal instead, which moves results by an ulp."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a / b


class Transform(NamedTuple):
    """Position and column frame (the reference's Transform class,
    src/lib/Objects/Transform/transform.h:9-50): ``pos`` (3,), ``axes``
    (3, 3) with columns (right, up, forward)."""

    pos: torch.Tensor
    axes: torch.Tensor

    @property
    def right(self):
        return self.axes[..., :, 0]

    @property
    def up(self):
        return self.axes[..., :, 1]

    @property
    def forward(self):
        return self.axes[..., :, 2]

    def with_forward_from_right_up(self) -> "Transform":
        f = normalize(cross(self.right, self.up))
        return self._replace(axes=torch.stack([self.right, self.up, f], -1))

    def with_right_from_up_forward(self) -> "Transform":
        r = normalize(cross(self.up, self.forward))
        return self._replace(
            axes=torch.stack([r, self.up, self.forward], -1))

    def with_up_from_forward_right(self) -> "Transform":
        u = normalize(cross(self.forward, self.right))
        return self._replace(
            axes=torch.stack([self.right, u, self.forward], -1))


def make_transform(pos=(0.0, 0.0, 0.0), axes=None, device=None) -> Transform:
    """A :class:`Transform` of float32 tensors on ``device`` (default: the
    card); ``axes`` defaults to the identity frame."""
    device = resolve_device(device)
    axes = IDENTITY_AXES if axes is None else axes
    return Transform(
        pos=torch.tensor(np.asarray(pos, np.float32), device=device),
        axes=torch.tensor(np.asarray(axes, np.float32), device=device))


def mat_vec(m, v):
    """``m @ v`` batched: m (..., 3, 3), v (..., 3) -> (..., 3)."""
    return _sum3(m * v[..., None, :])


def mat_tvec(m, v):
    """``m.T @ v`` batched: m (..., 3, 3), v (..., 3) -> (..., 3)."""
    p = m * v[..., :, None]
    return p[..., 0, :] + p[..., 1, :] + p[..., 2, :]


def dot(a, b):
    p = a * b
    if p.shape[-1] == 3:
        return _sum3(p)
    return p.sum(-1)


def cross(a, b):
    """``jnp.cross`` component order: (a1 b2 - a2 b1, a2 b0 - a0 b2,
    a0 b1 - a1 b0)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / length(v)[..., None]


def safe_length(v, eps=1e-24):
    """|v| as sqrt(max(v.v, eps)) (geometry.py:102-117 of the JAX package)."""
    return torch.sqrt(torch.clamp_min(dot(v, v), eps))


def safe_normalize(v, eps=1e-24):
    """``v * rsqrt(max(v.v, eps))``; the reciprocal is ``1 / sqrt`` because
    an approximate rsqrt would move the result by an ulp."""
    return v * (1.0 / torch.sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]


def square_vector(v):
    return dot(v, v)


def distance(a, b):
    return length(a - b)


def reflect(incident, normal):
    """GLSL ``reflect``: I - 2*dot(N, I)*N."""
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def project(v, target):
    """Project v onto target (black_hole.frag:739-741)."""
    return (dot(v, target) / square_vector(target))[..., None] * target


def gram_schmidt(m):
    """Orthonormalize a column frame keeping the direction of column 1 (up)
    fixed (black_hole.frag:744-753)."""
    c0, c1, c2 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    c0 = c0 - project(c0, c1)
    c2 = c2 - project(c2, c1) - project(c2, c0)
    return torch.stack([normalize(c0), normalize(c1), normalize(c2)], dim=-1)


def rotate_vector(angle, v, axis=None):
    """Rotate ``v`` by ``angle`` (radians) about ``axis`` (default world
    up): the Rodrigues rotation that replaces the reference's mouse-look
    helper (src/lib/utils/utils.cpp:6-18).  ``angle`` is rounded to
    float32 first, as the JAX package rounds a Python number."""
    if axis is None:
        axis = torch.tensor([0.0, 1.0, 0.0], device=v.device)
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32,
                                     device=v.device))
    # cos and sin in float64, rounded once: the correctly rounded float32
    # values, which XLA's float32 cos gives where torch's can miss by an
    # ulp (the viewer's states stay equal to the JAX package's).
    angle = torch.as_tensor(angle, dtype=torch.float32, device=v.device)
    c = torch.cos(angle.double()).float()
    s = torch.sin(angle.double()).float()
    return v * c + cross(axis, v) * s + axis * dot(axis, v)[..., None] * (
        1.0 - c)


def quat_to_axes(q):
    """Unit quaternion (w, x, y, z) -> column frame (``glm::toMat3``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def angle_axis(angle, axis):
    """Quaternion (w, x, y, z) from angle and axis (``glm::angleAxis``)."""
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    half = torch.as_tensor(angle / 2.0, dtype=torch.float32)
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def min_positive(n1, n2):
    """Smallest positive of two numbers, -1 if neither is positive
    (black_hole.frag:441-454)."""
    both = (n1 > 0) & (n2 > 0)
    return torch.where(both, torch.minimum(n1, n2),
                       torch.where(n1 > 0, n1, torch.where(n2 > 0, n2, -1.0)))
