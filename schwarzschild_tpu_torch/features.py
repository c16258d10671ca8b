"""Interactive-feature replacements: the debug test ray (counterpart of
``schwarzschild_tpu.features``).

The reference integrates one geodesic on the CPU when key R is pressed
(main.cpp:94-124) and uploads the polyline; the shader draws it as a chain
of red cylinders next to the green un-deflected ray (black_hole.frag:
760-803).  Here the integration is a host-side float32 numpy function, the
JAX package's operation for operation, producing a :class:`TestRay` that
the renderers take as ``test_ray=``.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import Camera
from .config import resolve_device
from .intersect import TestRay

TEST_RAY_OFFSET = 1.0  # main.cpp:71
MAX_STEPS = 100  # main.cpp:68
MAX_REVOLUTIONS = 2  # main.cpp:69


def calculate_test_ray(cam: Camera, capacity: int = MAX_STEPS + 1,
                       max_steps: int = MAX_STEPS,
                       max_revolutions: int = MAX_REVOLUTIONS,
                       r_s: float = 1.0, device=None) -> TestRay:
    """Float32 RK4 test-ray integration on the host (main.cpp:94-124), as a
    fixed-capacity :class:`TestRay` on ``device`` (default: the card).

    Stops when u < 0 (escape) or u r_s > 1 (fell through the horizon;
    main.cpp:117 tests u > 1 with r_s fixed at 1).  A ray that starts
    radial gives two points, the origin and one unit along the ray."""
    f32 = np.float32

    def host(x):
        # Contiguous, as the JAX package's arrays are: numpy's dot takes
        # another summation path on a strided view (cam.forward is a column
        # of cam.axes), which moves the integration by ulps.
        return np.ascontiguousarray(x.detach().cpu().numpy(), f32)

    direction = host(cam.forward)
    origin = host(cam.pos) + direction * f32(TEST_RAY_OFFSET)

    normal_vec = origin / np.linalg.norm(origin).astype(f32)
    max_angle = f32(2.0 * max_revolutions * np.pi)

    if abs(np.dot(direction, normal_vec)) >= 1.0 - 1e-6:  # main.cpp:104
        pts = [origin, origin + direction]
    else:
        tangent_vec = np.cross(np.cross(normal_vec, direction), normal_vec)
        tangent_vec = (tangent_vec / np.linalg.norm(tangent_vec)).astype(f32)
        u = f32(1.0) / np.linalg.norm(origin).astype(f32)
        du = (-u * f32(np.dot(direction, normal_vec))
              / f32(np.dot(direction, tangent_vec)))
        pts = [origin]
        phi = f32(0.0)
        for i in range(max_steps):
            h = (max_angle - phi) / f32(max_steps - i)
            phi = phi + h
            d_u, d_du = _rk4(u, du, h, f32(r_s))
            u = u + d_u
            if u < 0.0 or u * f32(r_s) > 1.0:  # main.cpp:117
                break
            du = du + d_du
            pts.append(((np.cos(phi) * normal_vec + np.sin(phi) * tangent_vec)
                        / u).astype(f32))

    n = min(len(pts), capacity)
    buf = np.zeros((capacity, 3), f32)
    buf[:n] = np.stack(pts[:n])
    buf[n:] = buf[n - 1]  # padding repeats the last point: zero-length
    dev = resolve_device(device)
    return TestRay(points=torch.from_numpy(buf).to(dev),
                   num_points=torch.tensor(n, dtype=torch.int32, device=dev),
                   flat_origin=torch.from_numpy(origin).to(dev),
                   flat_dir=torch.from_numpy(direction).to(dev))


def _rk4(u, du, h, r_s):
    f32 = np.float32

    def ddu(x):
        return -x * (f32(1.0) - f32(1.5) * r_s * x)

    k1 = du
    l1 = ddu(u)
    k2 = du + f32(0.5) * l1 * h
    l2 = ddu(u + f32(0.5) * k1 * h)
    k3 = du + f32(0.5) * l2 * h
    l3 = ddu(u + f32(0.5) * k2 * h)
    k4 = du + l3 * h
    l4 = ddu(u + k3 * h)
    return (h / f32(6.0) * (k1 + 2 * k2 + 2 * k3 + k4),
            h / f32(6.0) * (l1 + 2 * l2 + 2 * l3 + l4))
