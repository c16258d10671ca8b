"""The inputs of a cell, made from its configuration file and the seed: the
raw textures, the camera poses, and the same inputs in the program's form
and in the reference's.

The textures are the configurations' procedural stand-ins (a checker and a
sky of gradients and stars, the numpy steps of
``schwarzschild_tpu_torch.configs``, frozen here): nothing is downloaded.
The program gets them through its own builders (``stack_textures``,
``from_array``, ``build_scene``, ``make_camera``); the reference builds its
own tensors from the same raw arrays and numbers.
"""

from __future__ import annotations

import json
import math

import numpy as np


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Raw textures.
# ---------------------------------------------------------------------------


def checker(size=600, tiles=10) -> np.ndarray:
    """(H, W, 3) uint8 checker, row 0 = top."""
    y, x = np.mgrid[0:size, 0:size]
    c = (((x * tiles // size) + (y * tiles // size)) % 2).astype(np.uint8)
    img = np.stack([c * 200 + 55, 255 - c * 200, np.full_like(c, 128)], -1)
    return img.astype(np.uint8)


def sky(h=512, w=1024) -> np.ndarray:
    """(H, W, 3) uint8 equirect gradient with star dots, row 0 = top."""
    v = np.linspace(0, 1, h)[:, None]
    u = np.linspace(0, 1, w)[None, :]
    base = (20 + 60 * np.exp(-((v - 0.5) ** 2) / 0.02)) * np.ones((h, w))
    rng = np.random.default_rng(0)
    stars = (rng.random((h, w)) > 0.999).astype(np.float64) * 200.0
    g = np.clip(base + stars + 10 * np.sin(12 * math.pi * u), 0, 255)
    return np.stack([g, g, np.clip(g * 1.2, 0, 255)], -1).astype(np.uint8)


def raw_textures(cfg: dict):
    """(sky, [stack layers]) as top-down uint8 arrays."""
    t = cfg["textures"]
    makers = {"checker": lambda d: checker(d["size"], d["tiles"]),
              "sky": lambda d: sky(d["height"], d["width"])}
    return makers[t["sky"]["kind"]](t["sky"]), [
        makers[d["kind"]](d) for d in t["stack"]]


# ---------------------------------------------------------------------------
# Poses.
# ---------------------------------------------------------------------------


def camera_vectors(cam: dict, yaw_deg: float = 0.0, offset=(0.0, 0.0, 0.0)):
    """(pos, forward, right) in float64 numpy: the configuration's camera
    turned by ``yaw_deg`` about the world's up axis through its target,
    then moved by ``offset`` (its forward and right unchanged)."""
    a = math.radians(yaw_deg)
    rot = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                    [-math.sin(a), 0.0, math.cos(a)]])
    target = np.asarray(cam["target"], np.float64)
    pos = target + rot @ (np.asarray(cam["pos"], np.float64) - target)
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = rot @ np.asarray(cam["right"], np.float64)
    return pos + np.asarray(offset, np.float64), fwd, right


def orbit_yaws(traffic: dict, seed: int) -> list:
    """The frames' yaws in degrees: ``poses`` angles spread evenly over
    [-orbit_deg, orbit_deg], all moved by one seeded jitter and visited in
    a seeded order.  Every seed gets the same spread of poses, so runs do
    the same work."""
    n = int(traffic["poses"])
    rng = np.random.default_rng(seed)
    span = float(traffic["orbit_deg"])
    base = np.linspace(-span, span, n) if n > 1 else np.zeros(1)
    jitter = rng.uniform(-1.0, 1.0) * float(traffic["jitter_deg"])
    return [float(x) for x in (base + jitter)[rng.permutation(n)]]


def pose_offset(radius: float, seed: int) -> np.ndarray:
    """A seeded offset of length ``radius`` in a uniform direction."""
    v = np.random.default_rng(seed).standard_normal(3)
    return radius * v / np.linalg.norm(v)


# ---------------------------------------------------------------------------
# The two sides' inputs.
# ---------------------------------------------------------------------------


def render_fields(cfg: dict, traffic: dict) -> dict:
    """The configuration's render block with the traffic's overrides."""
    return {**cfg["render"], **traffic.get("render", {})}


def program_inputs(cfg: dict, traffic: dict, raws, device, scale=None):
    """(scene, RenderConfig, background, stack, n_slots) in the program's
    form.  ``scale`` (tests only) renders at (width, height) instead."""
    import schwarzschild_tpu_torch as st

    fields = render_fields(cfg, traffic)
    n_slots = int(fields.pop("n_slots", 4))
    if scale is not None:
        fields["width"], fields["height"] = scale
    rc = st.RenderConfig(**fields)
    objs = []
    for o in cfg["scene"]["objects"]:
        mat = st.Material(**o.get("material", {}))
        kw = {k: v for k, v in o.items() if k not in ("type", "material")}
        if "pos" in kw:
            kw["pos"] = tuple(kw["pos"])
        # "hollow_disk" names the program's HollowDisk, and so on.
        cls = getattr(st, "".join(w.capitalize()
                                  for w in o["type"].split("_")))
        objs.append(cls(material=mat, **kw))
    lights = [st.Light(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in lt.items()})
              for lt in cfg["scene"]["lights"]]
    sc = st.build_scene(objs, lights, device=device)
    sky_raw, stack_raws = raws
    bg = st.from_array(sky_raw.astype(np.float64) / 255.0, device=device)
    tex = st.stack_textures(stack_raws, device=device)
    return sc, rc, bg, tex, n_slots


def program_camera(cam: dict, yaw_deg=0.0, offset=(0.0, 0.0, 0.0),
                   device=None):
    import schwarzschild_tpu_torch as st

    pos, fwd, right = camera_vectors(cam, yaw_deg, offset)
    return st.make_camera(pos, forward=fwd, right=right, fov=cam["fov"],
                          device=device)


def reference_inputs(cfg: dict, traffic: dict, raws, device, dtype=None,
                     scale=None):
    import torch

    from .reference import render as ref

    desc = dict(cfg["scene"])
    desc["render"] = render_fields(cfg, traffic)
    if scale is not None:
        desc["render"]["width"], desc["render"]["height"] = scale
    return ref.build_inputs(desc, raws[0], raws[1],
                            dtype=dtype or torch.float32, device=device)


def reference_pose(cam: dict, yaw_deg=0.0, offset=(0.0, 0.0, 0.0),
                   device="cpu", dtype=None):
    import torch

    from .reference import render as ref

    pos, fwd, right = camera_vectors(cam, yaw_deg, offset)
    return ref.make_pose(pos, fwd, right, cam["fov"],
                         dtype=dtype or torch.float32, device=device)
