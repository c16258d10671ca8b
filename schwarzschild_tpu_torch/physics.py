"""Null-geodesic physics in Binet form (counterpart of
``schwarzschild_tpu.physics``): u''(phi) = -u (1 - 1.5 r_s u).

``rk4_step`` keeps the JAX package's operation order term by term; the
march kernel (csrc/march_common.cuh) repeats it in CUDA.
"""

from __future__ import annotations

import torch

from . import geometry as geo


def ddu(u, r_s=1.0):
    """Second derivative u''(phi) (black_hole.frag:336-338)."""
    return -u * (1.0 - 1.5 * r_s * u)


def rk4_step(u, du, delta_phi, r_s=1.0):
    """One classical RK4 step; returns (delta_u, delta_du)
    (black_hole.frag:341-355)."""
    k1 = du
    l1 = ddu(u, r_s)

    k2 = du + 0.5 * l1 * delta_phi
    l2 = ddu(u + 0.5 * k1 * delta_phi, r_s)

    k3 = du + 0.5 * l2 * delta_phi
    l3 = ddu(u + 0.5 * k2 * delta_phi, r_s)

    k4 = du + l3 * delta_phi
    l4 = ddu(u + k3 * delta_phi, r_s)

    h6 = geo.true_div(delta_phi, 6.0)
    return (
        h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4),
        h6 * (l1 + 2.0 * l2 + 2.0 * l3 + l4),
    )


def orbital_plane(origin, direction):
    """(normal_vec, tangent_vec) of the orbital plane through ``origin``
    with tangent ``direction``: normalize(origin) and
    normalize(cross(cross(n, dir), n)) (black_hole.frag:865, 883)."""
    n = geo.normalize(origin)
    t = geo.normalize(geo.cross(geo.cross(n, direction), n))
    return n, t


def initial_conditions(origin, direction, normal_vec, tangent_vec):
    """Initial (u, du) of the Binet ODE (black_hole.frag:886-887)."""
    u = 1.0 / geo.length(origin)
    du = -u * geo.dot(direction, normal_vec) / geo.dot(direction, tangent_vec)
    return u, du


def step_size(phi, i, max_angle, max_steps):
    """Uniform step in phi: the remaining angle over the remaining steps
    (black_hole.frag:914)."""
    return (max_angle - phi) / (max_steps - i)


def reconstruct_position(phi, u, normal_vec, tangent_vec):
    """Cartesian position of the polar state (black_hole.frag:925)."""
    return (torch.cos(phi)[..., None] * normal_vec
            + torch.sin(phi)[..., None] * tangent_vec) / u[..., None]


def is_radial(direction, normal_vec, epsilon=geo.EPSILON):
    """Radial-trajectory degeneracy test (black_hole.frag:872,902)."""
    return torch.abs(geo.dot(direction, normal_vec)) >= 1.0 - epsilon


def binet_energy(u, du, r_s=1.0):
    """Conserved quantity of the Binet equation: E = du^2 + u^2 (1 - r_s u),
    whose derivative in phi vanishes along exact solutions; the tests bound
    the integrator's drift with it."""
    return du * du + u * u * (1.0 - r_s * u)
