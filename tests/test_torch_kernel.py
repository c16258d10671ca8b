"""The port's horizon + sky march and frame held against the JAX package on
the CPU: ``march_bh_torch`` (the plain version of the CUDA kernel) against
the Pallas ``march_bh`` in interpret mode, and ``render_horizon_sky``
against its JAX twin.  The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import camera as jcam
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import geometry as jgeo
from schwarzschild_tpu import kernel as jkernel
from schwarzschild_tpu import physics as jphys
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import kernel as tkernel


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def frac_close(a, b, name, tol=1e-4, frac=0.995):
    """tests/test_kernel_scene.py's rule: near-total agreement, relative to
    1 + |b|; lanes on a capture/escape boundary may flip."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.abs(a - b) < tol * (1.0 + np.abs(b))
    while ok.ndim > 2:
        ok = ok.all(-1)
    assert ok.mean() > frac, f"{name}: only {ok.mean():.4f} lanes within {tol}"


def frame_close(ref, got, frac=0.995):
    """tests/test_kernel_scene.py's _check rule for frames."""
    d = np.abs(np.asarray(ref) - np.asarray(got)).max(-1)
    ok = (d < 2e-3).mean()
    assert ok > frac, f"only {ok:.4f} within tol, max {d.max():.3g}"


@pytest.fixture(scope="module")
def bh_case():
    """32x24 demo-camera rays with a quarter of the lanes inactive, marched
    once by the JAX kernel in interpret mode."""
    W, H = 32, 24
    cfg = st.RenderConfig(width=W, height=H, percent_black=-1.0)
    u, v = jcam.pixel_grid(W, H)
    o, d = jcam.generate_rays(jconfigs.demo_camera(), u, v, W, H)
    active = (~jphys.is_radial(d, jgeo.safe_normalize(o))
              & (jax.numpy.asarray(np.random.default_rng(0).random((H, W)))
                 > 0.25))
    fdir, status = jkernel.march_bh(o, d, active, 1.0, cfg, interpret=True)
    return dict(cfg=cfg, o=np.asarray(o), d=np.asarray(d),
                active=np.asarray(active), fdir=np.asarray(fdir),
                status=np.asarray(status))


def test_march_bh_torch_matches_pallas(bh_case):
    c = bh_case
    fdir, status = tkernel.march_bh_torch(
        _t(c["o"]), _t(c["d"]), _t(c["active"]), 1.0,
        convert.render_config(c["cfg"]))
    frac_close(fdir.numpy(), c["fdir"], "fdir")
    frac_close(status.numpy(), c["status"], "status")
    s = status.numpy()
    assert (s == tkernel.STATUS_CAPTURED).any()
    assert (s[~c["active"]] == tkernel.STATUS_ESCAPED).all()
    np.testing.assert_array_equal(fdir.numpy()[~c["active"]],
                                  c["d"][~c["active"]])


def test_march_bh_wrapper_runs_plain_version_on_cpu(bh_case):
    c = bh_case
    cfg = convert.render_config(c["cfg"])
    args = (_t(c["o"]), _t(c["d"]), _t(c["active"]), 1.0, cfg)
    before = tkernel.march_bh.launches
    fd0, s0 = tkernel.march_bh(*args)
    fd1, s1 = tkernel.march_bh_torch(*args)
    assert tkernel.march_bh.launches == before  # no kernel on the CPU
    assert torch.equal(fd0, fd1) and torch.equal(s0, s1)


def test_bigger_hole_captures_more(bh_case):
    c = bh_case
    cfg = convert.render_config(c["cfg"])
    args = (_t(c["o"]), _t(c["d"]), _t(c["active"]))
    _, s1 = tkernel.march_bh(*args, 1.0, cfg)
    _, s2 = tkernel.march_bh(*args, 1.5, cfg)
    assert (s2 == 1.0).sum() > (s1 == 1.0).sum()


@pytest.mark.parametrize("bad", ["dtype", "active_dtype", "shape",
                                 "contiguity"])
def test_march_wrappers_check_inputs(bh_case, bad):
    c = bh_case
    o, d, a = _t(c["o"]), _t(c["d"]), _t(c["active"])
    if bad == "dtype":
        o = o.double()
    elif bad == "active_dtype":
        a = a.float()
    elif bad == "shape":
        a = a[:-1]
    else:
        o = o.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        tkernel.march_bh(o, d, a, 1.0, convert.render_config(c["cfg"]))


SKY_CASES = {
    "config2": (st.RenderConfig(width=32, height=32, percent_black=-1.0),
                1.0),
    "soft_split_crosshair": (st.RenderConfig(
        width=24, height=24, raytrace_type=st.HALF_WIDTH, crosshair=True,
        percent_black=0.5, horizon_softness=0.05), 0.8),
}


@pytest.fixture(scope="module", params=sorted(SKY_CASES))
def sky_frame(request):
    """JAX render_horizon_sky in interpret mode, once per case: config 2 at
    32x32, and a 24x24 split screen with hash noise, the crosshair, a soft
    horizon and r_s = 0.8."""
    cfg, r_s = SKY_CASES[request.param]
    cam, bg = jconfigs.demo_camera(), jconfigs.background_texture()
    ref = np.asarray(jkernel.render_horizon_sky(cam, cfg, bg, r_s,
                                                interpret=True))
    return cfg, r_s, cam, bg, ref


def test_render_horizon_sky_matches_pallas(sky_frame):
    cfg, r_s, cam, bg, ref = sky_frame
    got = tkernel.render_horizon_sky(convert.camera(_np(cam), device="cpu"),
                                     convert.render_config(cfg),
                                     convert.texture(_np(bg), device="cpu"), r_s)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    frame_close(ref, got.numpy())


def test_render_horizon_sky_rejects_unported_options(tmp_path):
    """Every option of the JAX package's render_horizon_sky is ported now:
    differentiable= gives the same frame with a graph, and mesh= (here a
    one-rank gloo group's mesh) the same frame, marched tile by tile
    (tests/test_torch_sharding.py holds it on four ranks)."""
    import torch.distributed as dist

    from schwarzschild_tpu_torch import sharding

    cfg = st.RenderConfig(width=8, height=8)
    cam, bg = jconfigs.demo_camera(), jconfigs.background_texture()
    args = (convert.camera(_np(cam), device="cpu"), convert.render_config(cfg),
            convert.texture(_np(bg), device="cpu"))
    img = tkernel.render_horizon_sky(*args, differentiable=True)
    assert torch.equal(img, tkernel.render_horizon_sky(*args))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        meshed = tkernel.render_horizon_sky(*args,
                                            mesh=sharding.make_mesh())
    finally:
        dist.destroy_process_group()
    assert torch.equal(meshed, img)


@pytest.mark.parametrize("seed,shape", [(0, (8, 8)), (7, (13, 5)),
                                        (12345, (1, 31)),
                                        (2 ** 31 - 1, (24, 17))])
def test_prng_noise_matches_jax_bits(seed, shape):
    """noise_mode="prng" is jax.random.uniform(jax.random.key(seed),
    (H, W)) bit for bit."""
    H, W = shape
    cfg = sp.RenderConfig(width=W, height=H, noise_mode="prng",
                          noise_seed=seed)
    u = torch.zeros(H, W)
    got = tkernel.noise_field(cfg, u, u).numpy()
    ref = np.asarray(jax.random.uniform(jax.random.key(seed), (H, W)))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
