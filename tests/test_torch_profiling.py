"""The port's profiling module held against the JAX package's on the CPU:
``validate_scene`` raises the same errors on tests/test_aux.py's cases,
``device_time`` is positive, ``trace`` writes a trace, ``debug_mode``
catches a non-finite value and an anomalous backward."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu.profiling import validate_scene as jvalidate
from schwarzschild_tpu_torch import convert, profiling


def _port(sc):
    return convert.scene(jax.tree.map(np.asarray, sc), device="cpu")


def _scenes():
    demo = jconfigs.demo_scene()
    bad_axes = demo._replace(spheres=demo.spheres._replace(
        axes=demo.spheres.axes * 2.0))
    bad_disk = st.build_scene([st.HollowDisk(inner_radius=5.0,
                                             outer_radius=2.0)])
    bad_mat = demo._replace(spheres=demo.spheres._replace(
        mat_idx=demo.spheres.mat_idx + 100))
    bad_radius = demo._replace(spheres=demo.spheres._replace(
        radius=-demo.spheres.radius))
    return dict(demo=demo, bad_axes=bad_axes, bad_disk=bad_disk,
                bad_mat=bad_mat, bad_radius=bad_radius)


@pytest.mark.parametrize("name", ["demo", "bad_axes", "bad_disk", "bad_mat",
                                  "bad_radius"])
def test_validate_scene_matches_jax(name):
    sc = _scenes()[name]
    try:
        ref = jvalidate(sc)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            profiling.validate_scene(_port(sc))
        assert str(got.value) == str(exc)
        assert name != "demo"
    else:
        assert ref is True and name == "demo"
        assert profiling.validate_scene(_port(sc)) is True


def test_device_time_positive_on_cpu():
    x = torch.ones(256, 256)
    t = profiling.device_time(lambda r: (x * r).sum(), chains=(2, 32),
                              device="cpu")
    assert 0.0 < t < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        (torch.ones(64) * 2.0).sum()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert profiling.host_callbacks_supported() is True


def test_debug_mode_flags_non_finite():
    with profiling.debug_mode() as check:
        assert torch.is_anomaly_enabled()
        img = sp.solid_color_texture((0.5, 0.5, 0.5, 1.0), device="cpu").data
        assert check(img) is img
        with pytest.raises(FloatingPointError):
            check({"a": (img, img / 0.0 * 0.0)})
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    assert not torch.is_anomaly_enabled()
