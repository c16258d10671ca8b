"""The port's binding of the native float64 oracle (``oracle/native.py``) held
against the JAX package's (the same scene tables and frames), the port's
plain frames against the oracle at 32 x 24 (tests/test_native_oracle.py's
golden rule: at least 99.5% of pixels within 2e-3, median under 5e-4), and
tools/parity_oracle.py's classification and probe on a small frame."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu.oracle import OracleScene as JOracleScene
from schwarzschild_tpu.oracle import native as jnative
from schwarzschild_tpu_torch import configs as tconfigs
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch.oracle import native as oracle


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def demo():
    j = dict(scene=jconfigs.demo_scene(), cam=jconfigs.demo_camera(),
             bg=jconfigs.background_texture(),
             tex=jconfigs.demo_texture_stack())
    t = dict(scene=convert.scene(_np(j["scene"]), device="cpu"),
             cam=convert.camera(_np(j["cam"]), device="cpu"),
             bg=convert.texture(_np(j["bg"]), device="cpu"),
             tex=convert.texture_stack(_np(j["tex"]), device="cpu"))
    return j, t


def test_oracle_scene_matches_jax(demo):
    j, t = demo
    ref = JOracleScene.from_scene(j["scene"], background=j["bg"],
                                  tex=j["tex"], r_s=0.8)
    got = oracle.OracleScene.from_scene(t["scene"], t["bg"], t["tex"], 0.8)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), f.name
            for k in a:
                assert a[k].dtype == b[k].dtype, (f.name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_native_binding_matches_jax_binding(demo):
    j, t = demo
    josc = JOracleScene.from_scene(j["scene"], background=j["bg"],
                                   tex=j["tex"])
    tosc = oracle.OracleScene.from_scene(t["scene"], t["bg"], t["tex"])
    cam = j["cam"]
    for kw in (dict(percent_black=-1.0),
               dict(percent_black=-1.0, raytrace_type=2,
                    curved_percentage=0.3),
               dict(percent_black=0.75, noise_mode="hash", noise_seed=5),
               dict(percent_black=-1.0, crosshair=True)):
        ref = jnative.render_image(josc, np.asarray(cam.pos),
                                   np.asarray(cam.axes), float(cam.fov), 24,
                                   16, **kw)
        got = oracle.render_image(tosc, t["cam"].pos, t["cam"].axes,
                                  t["cam"].fov, 24, 16, **kw)
        # The same source; the JAX package builds it with -march=native
        # (FMA contraction), this package without: round-off apart.
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10,
                                   err_msg=str(kw))
    with pytest.raises(ValueError, match="noise_mode"):
        oracle.render_image(tosc, t["cam"].pos, t["cam"].axes, t["cam"].fov,
                            8, 8, percent_black=0.5, noise_mode="prng")


def _golden(gold, img):
    d = np.abs(gold - np.asarray(img)).max(-1)
    assert (d < 2e-3).mean() >= 0.995, ((d < 2e-3).mean(), d.max())
    assert np.median(d) < 5e-4


@pytest.mark.parametrize("frame", ["render_fast", "render", "sky"])
def test_port_frames_match_oracle(demo, frame):
    _, t = demo
    cfg = sp.RenderConfig(width=32, height=24, percent_black=-1.0)
    if frame == "sky":
        c2 = tconfigs.config2_curved(device="cpu")
        osc = oracle.OracleScene.from_scene(c2["scene"], c2["background"])
        cam = c2["camera"]
        img = sp.render_horizon_sky(cam, cfg, c2["background"], 1.0)
    else:
        osc = oracle.OracleScene.from_scene(t["scene"], t["bg"], t["tex"])
        cam = t["cam"]
        render = sp.render_fast if frame == "render_fast" else sp.render
        img = render(t["scene"], cam, cfg, t["bg"], t["tex"], 1.0)
    gold = oracle.render_image(osc, cam.pos, cam.axes, cam.fov, 32, 24)
    _golden(gold, img)


def _tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "parity_oracle.py"
    spec = importlib.util.spec_from_file_location("parity_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_tool_classifies_and_probes():
    """The tool's pieces on config 2 at 32 x 32: every renderer within the
    golden rule, the gate's count present; and the classifier and probe on
    a planted offender: a flat region off by 0.01 is non-boundary at r0,
    and a pixel no perturbation moves is not marginal."""
    tool = _tool()
    c2 = tconfigs.config2_curved(device="cpu")
    c2["cfg"] = dataclasses.replace(c2["cfg"], width=32, height=32)
    res = tool.run_config("config2_32", c2, torch.device("cpu"))
    for name in ("render_horizon_sky", "render_fast", "render"):
        assert res[name]["frac_within_tol"] >= 0.995, name
        assert res[name]["nonboundary_gt_display_r0_nonmarginal"] == 0
    gold = np.zeros((16, 16, 4), np.float32)
    img = gold.copy()
    img[8, 8, 0] = 0.01
    summary, offenders = oracle.classify(gold, img)
    assert summary["nonboundary_gt_display_r0"] == 1
    assert offenders == [(8, 8, pytest.approx(0.01))]
    report = oracle.probe(lambda **kw: img, offenders, img)
    assert report[0]["marginal"] is False
