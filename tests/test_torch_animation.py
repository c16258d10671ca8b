"""The PyTorch port's flyby path held against the JAX package on the CPU:
the hyperbolic trajectory and its gradient, the Binet energy, the frame
slabs of each process, the metrics records, the PNG encoder, and the
animation module's frames, resume, prefetch and encode workers.  Inputs come
from a numpy seed or from both packages' configs."""

import dataclasses
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import animation as janim
from schwarzschild_tpu import camera as jcam
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import kernel_scene as jks
from schwarzschild_tpu import metrics as jmetrics
from schwarzschild_tpu import physics as jphys
from schwarzschild_tpu import sharding as jshard
from schwarzschild_tpu_torch import animation as tanim
from schwarzschild_tpu_torch import camera as tcam
from schwarzschild_tpu_torch import configs as tconfigs
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import metrics as tmetrics
from schwarzschild_tpu_torch import physics as tphys
from schwarzschild_tpu_torch import sharding as tshard

# The package exports the dense renderer ``render``, which hides the module.
trender = importlib.import_module("schwarzschild_tpu_torch.render")

BASE = (0.0, 2.0, 15.0)


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_hyperbolic_trajectory_matches(t):
    ref = jcam.hyperbolic_trajectory(jcam.make_camera(BASE), 30.0, 10.0, t)
    got = tcam.hyperbolic_trajectory(tcam.make_camera(BASE, device="cpu"),
                                     30.0, 10.0, t)
    for field in ("pos", "axes"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)), rtol=0,
                                   atol=1e-5, err_msg=field)


@pytest.mark.parametrize("t", [0.1, 0.5, 0.8])
def test_hyperbolic_trajectory_gradient_matches(t):
    w = np.random.default_rng(11).normal(size=(4, 3)).astype(np.float32)

    def j_loss(closest, time):
        cam = jcam.hyperbolic_trajectory(jcam.make_camera(BASE), 30.0,
                                         closest, time)
        return jnp.sum(cam.pos * w[0]) + jnp.sum(cam.axes * w[1:])

    ref = jax.grad(j_loss, argnums=(0, 1))(np.float32(10.0), np.float32(t))
    closest = torch.tensor(10.0, requires_grad=True)
    time = torch.tensor(t, requires_grad=True)
    cam = tcam.hyperbolic_trajectory(tcam.make_camera(BASE, device="cpu"),
                                     30.0, closest, time)
    wt = torch.from_numpy(w)
    loss = (cam.pos * wt[0]).sum() + (cam.axes * wt[1:]).sum()
    got = torch.autograd.grad(loss, [closest, time])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-4)


def test_binet_energy_matches():
    rng = np.random.default_rng(5)
    u = rng.uniform(0.0, 0.6, 1000).astype(np.float32)
    du = rng.normal(size=1000).astype(np.float32)
    for r_s in (1.0, 0.7):
        ref = np.asarray(jphys.binet_energy(u, du, r_s))
        got = tphys.binet_energy(torch.from_numpy(u), torch.from_numpy(du),
                                 r_s).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_processes", [1, 2, 3, 4])
@pytest.mark.parametrize("n_frames", [1, 5, 16, 17])
def test_frame_range_for_process_matches(n_frames, n_processes):
    slabs = [tshard.frame_range_for_process(n_frames, pid, n_processes)
             for pid in range(n_processes)]
    assert slabs == [jshard.frame_range_for_process(n_frames, pid,
                                                    n_processes)
                     for pid in range(n_processes)]
    assert [i for s in slabs for i in s] == list(range(n_frames))
    # One process without torch.distributed renders every frame.
    assert tshard.frame_range_for_process(n_frames) == range(n_frames)


def _log_both(tmp_path, pkg, name):
    log = pkg.MetricsLogger(tmp_path / f"{name}.jsonl")
    log.log("frame", frame=0, seconds=0.5)
    with pkg.FrameTimer(log, frame=1, n_rays=100, max_steps=10) as ft:
        ft.add_fields(host_fetch_ms=1.5)
    log.to_csv(tmp_path / f"{name}.csv")
    return log, tmp_path / name


def test_metrics_records_match(tmp_path):
    jlog, jpath = _log_both(tmp_path, jmetrics, "jax")
    tlog, tpath = _log_both(tmp_path, tmetrics, "torch")
    assert ([sorted(r) for r in tlog.records]
            == [sorted(r) for r in jlog.records])
    lines = [json.loads(x) for x in
             jpath.with_suffix(".jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in
           tpath.with_suffix(".jsonl").read_text().splitlines()]
    assert [sorted(r) for r in got] == [sorted(r) for r in lines]
    assert got[1]["rk4_steps_nominal"] == 1000
    assert got[1]["host_fetch_ms"] == 1.5
    assert (tpath.with_suffix(".csv").read_text().splitlines()[0]
            == jpath.with_suffix(".csv").read_text().splitlines()[0])


@pytest.mark.parametrize("shape,level", [((1, 1), 6), ((17, 23), 0),
                                         ((64, 48), 1), ((5, 300), 9)])
def test_encode_png_decodes_exactly(shape, level):
    Image = pytest.importorskip("PIL.Image")
    rgb = np.random.default_rng(level).integers(0, 256, shape + (3,),
                                                dtype=np.uint8)
    data = trender.encode_png(rgb, level)
    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back, rgb)
    assert trender.encode_png(torch.from_numpy(rgb), level) == data


def test_save_png_writes_to_uint8(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.2, 1.2, (9, 14, 4)).astype(np.float32))
    sp.save_png(img, tmp_path / "x.png")
    back = np.asarray(Image.open(tmp_path / "x.png"))
    np.testing.assert_array_equal(back, sp.to_uint8(img).numpy())


def _flyby_cfg():
    return dict(width=32, height=18, max_steps=10, percent_black=-1.0,
                raytrace_type=jcam.HALF_WIDTH, checkpoint_every=0)


@pytest.fixture(scope="module")
def port_flyby():
    """The demo scene's flyby inputs for the port, on the CPU."""
    cfg = convert.render_config(st.RenderConfig(**_flyby_cfg()))
    return dict(sc=tconfigs.demo_scene(device="cpu"), cfg=cfg,
                bg=tconfigs.background_texture(device="cpu"),
                tex=tconfigs.demo_texture_stack(device="cpu"))


def _frames(paths):
    Image = pytest.importorskip("PIL.Image")
    return [np.asarray(Image.open(p)).astype(np.int16) for _, p in paths]


@pytest.fixture(scope="module")
def jax_flyby_frames():
    """The JAX package's demo-scene flyby at the port test's size, 2 frames:
    its fast renderer (interpret mode, as its animation driver runs it off
    the TPU, without the driver's texture atlas) at the cameras its driver
    poses, quantized by its to_uint8.  One compile serves both frames, with
    XLA's backend optimisation off, which halves the CPU compile of the
    interpret-mode kernel (the comparison's tolerance is the JAX suite's)."""
    sc, bg = jconfigs.demo_scene(), jconfigs.background_texture()
    tex = jconfigs.demo_texture_stack()
    cfg = st.RenderConfig(**_flyby_cfg())

    def frame(cam):
        return st.to_uint8(jks.render_fast(sc, cam, cfg, bg, tex, 1.0,
                                           interpret=True,
                                           overflow="ignore"))

    cams = [jcam.hyperbolic_trajectory(jcam.make_camera(BASE), 30.0, 10.0,
                                       float(t))
            for t in np.linspace(0.0, 1.0, 2)]
    render = jax.jit(frame).lower(cams[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return [np.asarray(render(cam)).astype(np.int16) for cam in cams]


def _within_one_level(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (18, 32, 3)
        share = (np.abs(a - b).max(-1) <= 1).mean()
        assert share >= 0.995, share


def test_render_trajectory_matches_jax(tmp_path, port_flyby,
                                       jax_flyby_frames):
    f = port_flyby
    log = tmetrics.MetricsLogger()
    got = tanim.render_trajectory(f["sc"], f["cfg"], f["bg"], f["tex"],
                                  n_frames=2, out_dir=tmp_path / "torch",
                                  logger=log, all_frames_local=True,
                                  renderer="fast")
    assert [i for i, _ in got] == [0, 1]
    _within_one_level(_frames(got), jax_flyby_frames)
    events = [r["event"] for r in log.records]
    assert events.count("frame") == 2 and events.count("png") == 2
    assert all("host_fetch_ms" in r for r in log.records
               if r["event"] == "frame")


def test_render_trajectory_matches_jax_driver(tmp_path):
    """Both drivers end to end (poses, times, quantization, PNG files) on
    the empty scene, whose interpret-mode kernel compiles in seconds: the
    black hole lenses the sky in the curved half."""
    bg = jconfigs.background_texture()
    ref = janim.render_trajectory(
        st.empty_scene(), st.RenderConfig(**_flyby_cfg()), bg, n_frames=2,
        out_dir=tmp_path / "jax", all_frames_local=True, renderer="fast")
    got = tanim.render_trajectory(
        sp.empty_scene(device="cpu"),
        convert.render_config(st.RenderConfig(**_flyby_cfg())),
        convert.texture(bg, device="cpu"), n_frames=2,
        out_dir=tmp_path / "torch", all_frames_local=True, renderer="fast")
    assert [i for i, _ in got] == [i for i, _ in ref] == [0, 1]
    frames = _frames(got)
    assert not np.array_equal(frames[0], frames[1])
    _within_one_level(frames, _frames(ref))


def test_render_trajectory_jnp_matches_jax(tmp_path):
    """renderer="jnp" (the dense renderers, the default of both packages'
    render_trajectory) end to end on the empty scene, within 1 level on
    99.5% of pixels."""
    bg = jconfigs.background_texture()
    ref = janim.render_trajectory(
        st.empty_scene(), st.RenderConfig(**_flyby_cfg()), bg, n_frames=2,
        out_dir=tmp_path / "jax", all_frames_local=True, renderer="jnp")
    got = tanim.render_trajectory(
        sp.empty_scene(device="cpu"),
        convert.render_config(st.RenderConfig(**_flyby_cfg())),
        convert.texture(bg, device="cpu"), n_frames=2,
        out_dir=tmp_path / "torch", all_frames_local=True, renderer="jnp")
    assert [i for i, _ in got] == [i for i, _ in ref] == [0, 1]
    _within_one_level(_frames(got), _frames(ref))


def _bytes(paths):
    return [open(p, "rb").read() for _, p in paths]


def test_render_trajectory_resume_prefetch_and_workers(tmp_path, port_flyby):
    """Prefetch and encode workers change scheduling only: the files are
    byte for byte those of the serial loop, also when a resumed run
    re-renders a hole between skipped frames."""
    f = port_flyby

    def run(name, logger=None, **kw):
        return tanim.render_trajectory(
            f["sc"], f["cfg"], f["bg"], f["tex"], n_frames=4,
            out_dir=tmp_path / name, all_frames_local=True, logger=logger,
            renderer="fast", **kw)

    serial = run("serial", prefetch=0, encode_workers=0)
    ahead = run("ahead", prefetch=3, encode_workers=2)
    assert [i for i, _ in serial] == [i for i, _ in ahead] == [0, 1, 2, 3]
    assert _bytes(serial) == _bytes(ahead)
    (tmp_path / "ahead" / "frame_00001.png").unlink()
    log = tmetrics.MetricsLogger()
    again = run("ahead", logger=log, prefetch=3, encode_workers=2)
    assert [i for i, _ in again] == [0, 1, 2, 3]
    events = [r["event"] for r in log.records]
    assert events.count("frame_skipped") == 3 and events.count("frame") == 1
    assert [r["frame"] for r in log.records if r["event"] == "frame"] == [1]
    assert _bytes(again) == _bytes(serial)
    assert not list((tmp_path / "ahead").glob("*.part"))


def test_render_trajectory_in_memory_and_options(port_flyby):
    f = port_flyby
    out = tanim.render_trajectory(f["sc"], f["cfg"], f["bg"], f["tex"],
                                  times=[0.3], all_frames_local=True,
                                  renderer="fast")
    cam = tcam.hyperbolic_trajectory(tcam.make_camera(BASE, device="cpu"),
                                     30.0, 10.0, 0.3)
    direct = sp.render_fast(f["sc"], cam, f["cfg"], f["bg"], f["tex"],
                            overflow="ignore")
    assert out[0][0] == 0 and torch.equal(out[0][1], direct)
    # renderer="jnp", the default, ported since: the dense renderer's frame.
    dense = sp.render(f["sc"], cam, f["cfg"], f["bg"], f["tex"])
    for kw in (dict(renderer="jnp"), {}):
        out = tanim.render_trajectory(f["sc"], f["cfg"], f["bg"], f["tex"],
                                      times=[0.3], all_frames_local=True,
                                      **kw)
        assert torch.equal(out[0][1], dense)
    with pytest.raises(ValueError, match="unknown renderer"):
        tanim.render_trajectory(f["sc"], f["cfg"], f["bg"], renderer="nope")
    with pytest.raises(ValueError, match="measure_device_ms"):
        tanim.render_trajectory(f["sc"], f["cfg"], f["bg"], n_frames=1,
                                measure_device_ms=True)


def test_write_video_gif(tmp_path, port_flyby):
    pytest.importorskip("imageio")
    f = port_flyby
    paths = tanim.render_trajectory(
        f["sc"], dataclasses.replace(f["cfg"], max_steps=4), f["bg"],
        n_frames=2, out_dir=tmp_path, all_frames_local=True,
        renderer="fast")
    tanim.write_video([p for _, p in paths], str(tmp_path / "fly.gif"),
                      fps=4, loop=0)
    assert (tmp_path / "fly.gif").stat().st_size > 0
