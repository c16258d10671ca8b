"""The port's gradient frame and inverse fit held against the JAX package on
the CPU: ``render_fast(differentiable=True)`` gradients, one config-5
training step (init_params, realize, loss, gradients, optimizer update),
the optimizer chain against optax, and fit's checkpoint/resume.  The JAX
references run once per module, at small sizes (an interpret-mode gradient
frame costs seconds)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import inverse as jinv
from schwarzschild_tpu import kernel_scene as jks
from schwarzschild_tpu_torch import configs as tconfigs
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import inverse as tinv
from schwarzschild_tpu_torch import kernel_scene as tks


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


# The JAX reference is one interpret-mode value-and-gradient of the config-5
# loss, shared by the tests below: its compilation costs about a minute on
# one core whatever the size, so the module computes it once, at 24x16 and
# 40 steps.
CFG = st.RenderConfig(width=24, height=16, max_steps=40, percent_black=-1.0)
DISK = 5  # the hollow disk's ring in the planet texture stack


@pytest.fixture(scope="module")
def config5():
    """Config 5 cut to CFG: the JAX setup, the port's from the same arrays,
    and a target the port renders at r_s = 1 (the same array for both)."""
    j = jconfigs.config5_inverse()
    j["cfg"] = CFG
    t = dict(scene=convert.scene(_np(j["scene"]), device="cpu"),
             camera=convert.camera(_np(j["camera"]), device="cpu"),
             background=convert.texture(_np(j["background"]), device="cpu"),
             tex=convert.texture_stack(_np(j["tex"]), device="cpu"),
             cfg=convert.render_config(CFG))
    target = tks.render_fast(t["scene"], t["camera"], t["cfg"],
                             t["background"], t["tex"], 1.0,
                             overflow="ignore").numpy()
    return j, t, target


@pytest.fixture(scope="module")
def jax_step(config5):
    """From r_s 0.7 with the disk texels free: the JAX loss, its gradients
    with respect to the parameters and the background texels, and the
    parameters after one default_optimizer step."""
    j, _, target = config5
    jp = jinv.init_params(j["camera"], 0.7, j["tex"], DISK)

    def jloss(params, bg_data):
        cam, r_s, tex_p = jinv.realize(params, j["tex"], DISK)
        img = jks.render_fast(j["scene"], cam, CFG,
                              j["background"]._replace(data=bg_data), tex_p,
                              r_s, interpret=True, overflow="ignore",
                              differentiable=True)
        return jnp.mean((img - target) ** 2)

    loss, (grads, g_bg) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, j["background"].data)
    opt = jinv.default_optimizer()
    updates, _ = opt.update(grads, opt.init(jp), jp)
    return dict(params=jp, loss=float(loss), grads=_np(grads),
                g_bg=np.asarray(g_bg),
                after=_np(optax.apply_updates(jp, updates)))


def _port_loss_grads(t, target, params):
    """The port's loss and its gradients with respect to the parameters
    and the background texels, through render_fast(differentiable=True)."""
    leaves = [x.clone().requires_grad_(True) for x in params]
    bg = t["background"].data.clone().requires_grad_(True)
    cam, r_s, tex_p = tinv.realize(tinv.InverseParams(*leaves), t["tex"],
                                   DISK)
    img = tks.render_fast(t["scene"], cam, t["cfg"], sp.Texture(bg), tex_p,
                          r_s, overflow="ignore", differentiable=True)
    loss = torch.mean((img - torch.from_numpy(target)) ** 2)
    grads = torch.autograd.grad(loss, leaves + [bg])
    return loss.item(), grads[:-1], grads[-1]


def test_render_fast_gradients_match_jax(config5, jax_step):
    """Gradients of the config-5 image loss through
    render_fast(differentiable=True) with respect to r_s (through its
    softplus parameter), cam.pos and the background texels; r_s and pos with
    tests/test_kernel_scene.py's rule (rtol 2e-2, atol 1e-3), the texels
    within 2e-2 of the largest."""
    _, t, target = config5
    ref = jax_step
    tp = tinv.init_params(t["camera"], 0.7, t["tex"], DISK)
    _, grads, g_bg = _port_loss_grads(t, target, tp)
    np.testing.assert_allclose(float(grads[0]), float(ref["grads"].r_s_raw),
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(grads[1].numpy(), ref["grads"].cam_pos,
                               rtol=2e-2, atol=1e-3)
    assert float(grads[0]) != 0 and (grads[1] != 0).any()
    g_bg = g_bg.numpy()
    assert np.isfinite(g_bg).all() and (g_bg != 0).any()
    np.testing.assert_allclose(g_bg, ref["g_bg"], rtol=0,
                               atol=2e-2 * np.abs(ref["g_bg"]).max())


def test_config5_bundle_equals_port_build():
    port = tconfigs.config5_inverse(device="cpu")
    ref = jconfigs.config5_inverse()
    assert dataclasses.asdict(port["cfg"]) == dataclasses.asdict(ref["cfg"])
    np.testing.assert_array_equal(port["tex"].data.numpy(),
                                  np.asarray(ref["tex"].data))
    np.testing.assert_array_equal(port["camera"].pos.numpy(),
                                  np.asarray(ref["camera"].pos))


def test_train_step_matches_jax(config5, jax_step):
    """init_params, realize and one make_train_step step from r_s 0.7 with
    the disk texture (slot 5) optimized: loss within 1e-4 relative, each
    gradient leaf within 2e-2 of its largest entry, parameters after the
    step within 1e-4."""
    j, t, target = config5
    ref = jax_step
    tp = tinv.init_params(t["camera"], 0.7, t["tex"], DISK)
    for a, b in zip(tp, ref["params"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jcam, jrs, _ = jinv.realize(ref["params"], j["tex"], DISK)
    tcam, trs, ttex = tinv.realize(tp, t["tex"], DISK)
    np.testing.assert_allclose(tcam.axes.numpy(), np.asarray(jcam.axes),
                               atol=1e-7)
    np.testing.assert_allclose(float(trs), float(jrs), rtol=1e-7)
    assert torch.equal(ttex.data, t["tex"].data)

    loss_fn = tinv.make_loss(t["scene"], t["cfg"], t["background"], t["tex"],
                             DISK, target, renderer="fast")
    leaves = [x.clone().requires_grad_(True) for x in tp]
    tloss = loss_fn(tinv.InverseParams(*leaves))
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), ref["loss"], rtol=1e-4)
    for name, a, b in zip(tinv.InverseParams._fields, tgrads, ref["grads"]):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-2,
                                   atol=2e-2 * np.abs(b).max(), err_msg=name)
    assert (tgrads[-1] != 0).any()  # the disk texels get a gradient

    topt = tinv.default_optimizer()
    step = tinv.make_train_step(loss_fn, topt)
    tp1, state, loss = step(tp, topt.init(tp))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4)
    for name, a, b in zip(tinv.InverseParams._fields, tp1, ref["after"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4,
                                   err_msg=name)
    assert tinv.nonfinite_fired(state) == 0


def test_loss_options_not_ported(config5):
    """Every option is ported since: pass_atlas (held to the loss without
    it in test_pass_atlas_matches_built_atlas) raises the JAX package's
    ValueErrors for optimized texels and the dense renderer, and runs;
    renderer="jnp" and backward="twin" (held to JAX in
    test_make_loss_jnp_matches_jax and tests/test_torch_adjoint.py) build
    and run."""
    _, t, target = config5
    args = (t["scene"], t["cfg"], t["background"], t["tex"], 5, target)
    with pytest.raises(ValueError, match="disk_slot=None"):
        tinv.make_loss(*args, renderer="fast", pass_atlas=True)
    with pytest.raises(ValueError, match="renderer='fast'"):
        tinv.make_loss(*args, pass_atlas=True)
    with pytest.raises(ValueError):
        tinv.make_loss(*args, renderer="nope")
    from schwarzschild_tpu_torch import textures

    tiny = dataclasses.replace(t["cfg"], width=8, height=6, max_steps=10)
    atlas_loss = tinv.make_loss(t["scene"], tiny, t["background"], t["tex"],
                                None, np.zeros((6, 8, 4), np.float32),
                                renderer="fast", pass_atlas=True)
    atlas = textures.build_atlas_cached(t["background"], t["tex"])
    assert np.isfinite(float(atlas_loss(tinv.init_params(t["camera"], 0.7),
                                        atlas)))
    small = dataclasses.replace(t["cfg"], width=8, height=6, max_steps=10)
    params = tinv.init_params(t["camera"], 0.7)
    loss = tinv.make_loss(t["scene"], small, t["background"], t["tex"], None,
                          np.zeros((6, 8, 4), np.float32), renderer="jnp")
    assert np.isfinite(float(loss(params)))
    from schwarzschild_tpu_torch import adjoint

    f = adjoint.make_diff_horizon_sky(small, backward="twin")
    assert f(t["camera"], t["background"].data, 1.0).shape == (6, 8, 4)
    with pytest.raises(ValueError):
        adjoint.make_diff_horizon_sky(small, backward="nope")


def test_pass_atlas_matches_built_atlas(config5):
    """make_loss(pass_atlas=True) with the atlas built once outside gives
    the loss and the gradients of the loss that builds it inside, and
    make_train_step carries the atlas through as its extra argument."""
    _, t, _ = config5
    from schwarzschild_tpu_torch import textures

    small = dataclasses.replace(t["cfg"], width=16, height=12, max_steps=20)
    target = np.random.default_rng(3).random((12, 16, 4)).astype(np.float32)
    args = (t["scene"], small, t["background"], t["tex"], None, target)
    built = tinv.make_loss(*args, renderer="fast")
    passed = tinv.make_loss(*args, renderer="fast", pass_atlas=True)
    atlas = textures.build_atlas_cached(t["background"], t["tex"])
    params = tinv.init_params(t["camera"], 0.7)

    def value_and_grads(loss_fn, *aux):
        leaves = [x.clone().requires_grad_(True) for x in params
                  if x is not None]
        loss = loss_fn(tinv.InverseParams(*leaves, None), *aux)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    l0, g0 = value_and_grads(built)
    l1, g1 = value_and_grads(passed, atlas)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)
    opt = tinv.default_optimizer()
    _, _, loss = tinv.make_train_step(passed, opt)(params, opt.init(params),
                                                   atlas)
    np.testing.assert_allclose(float(loss), float(l0), rtol=1e-6)


@pytest.mark.parametrize("decay_steps", [None, 3])
def test_optimizer_chain_matches_optax(decay_steps):
    """zero_nonfinite -> clip_by_global_norm(1) -> adam over 5 steps of
    seeded gradients, some above the clip norm and one with non-finite
    entries."""
    rng = np.random.default_rng(0)
    shapes = [(), (3,), (4, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jopt = jinv.default_optimizer(0.05, decay_steps=decay_steps)
    topt = tinv.default_optimizer(0.05, decay_steps=decay_steps)
    jp = [jnp.asarray(x) for x in params]
    tp = [_t(x) for x in params]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for k in range(5):
        scale = [0.1, 3.0, 0.5, 10.0, 0.2][k]
        grads = [scale * rng.standard_normal(s).astype(np.float32)
                 for s in shapes]
        if k == 2:
            grads[2][1, 1] = np.nan
            grads[1][0] = np.inf
        jup, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        tup, tstate = topt.update([_t(g) for g in grads], tstate)
        jp = optax.apply_updates(jp, jup)
        tp = [x + u for x, u in zip(tp, tup)]
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    assert tinv.nonfinite_fired(tstate) == jinv.nonfinite_fired(jstate) == 2


def test_fit_resume_gives_the_same_history(tmp_path):
    c = tconfigs.config5_inverse(device="cpu")
    cfg = sp.RenderConfig(width=16, height=8, max_steps=20,
                          percent_black=-1.0)
    target = sp.render_fast(c["scene"], c["camera"], cfg, c["background"],
                            c["tex"], 1.0, overflow="ignore")
    args = (c["scene"], cfg, c["background"], c["tex"], 5, target,
            c["camera"])
    kw = dict(r_s0=0.7, log_fn=lambda s: None, renderer="fast")
    _, full = tinv.fit(*args, n_steps=4, **kw)
    _, first = tinv.fit(*args, n_steps=2, checkpoint_dir=tmp_path,
                        checkpoint_every=1, **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001.pt", "step_00000002.pt"]
    messages = []
    params, resumed = tinv.fit(*args, n_steps=4, checkpoint_dir=tmp_path,
                               checkpoint_every=1, log_fn=messages.append,
                               r_s0=0.7, renderer="fast")
    assert messages[0] == "resumed from step 2"
    assert resumed[:2] == first
    np.testing.assert_allclose(resumed, full, rtol=1e-6)
    assert np.isfinite(full).all() and float(tinv._softplus(
        params.r_s_raw)) != pytest.approx(0.7)


# ---------------------------------------------------------------------------
# The dense renderer's loss, the multiview loss, the blur and the CEM search.
# ---------------------------------------------------------------------------


def test_make_loss_jnp_matches_jax(config5):
    """make_loss(renderer="jnp"), the default, against the JAX package's:
    the config-5 loss from r_s 0.7 with the disk texels free, its value
    within 1e-4 relative and its gradients with tests/test_kernel_scene.py's
    rule (rtol 2e-2, atol 1e-3) for r_s and the camera, the texels within
    2e-2 of their largest; fit(renderer="jnp") takes the same first step."""
    j, t, target = config5
    jp = jinv.init_params(j["camera"], 0.7, j["tex"], DISK)
    jloss = jinv.make_loss(j["scene"], CFG, j["background"], j["tex"], DISK,
                           target)
    value, grads = jax.jit(jax.value_and_grad(jloss))(jp)
    loss_fn = tinv.make_loss(t["scene"], t["cfg"], t["background"], t["tex"],
                             DISK, target)
    tp = tinv.init_params(t["camera"], 0.7, t["tex"], DISK)
    leaves = [x.clone().requires_grad_(True) for x in tp]
    tloss = loss_fn(tinv.InverseParams(*leaves))
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(value), rtol=1e-4)
    for name, a, b in zip(tinv.InverseParams._fields, tgrads, _np(grads)):
        assert np.isfinite(a.numpy()).all(), name
        atol = 2e-2 * np.abs(b).max() if name == "disk_texture" else 1e-3
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-2, atol=atol,
                                   err_msg=name)
    assert float(tgrads[0]) != 0 and (tgrads[-1] != 0).any()

    _, history = tinv.fit(t["scene"], t["cfg"], t["background"], t["tex"],
                          DISK, target, t["camera"], r_s0=0.7, n_steps=1,
                          log_fn=lambda s: None)
    np.testing.assert_allclose(history, [tloss.item()], rtol=1e-6)


@pytest.mark.parametrize("sigma", [0.0, 2.0, 8.0])
def test_gaussian_blur_matches_jax(sigma):
    """gaussian_blur against the JAX package's within 1e-6 (numpy's
    convolve(mode="same") on each axis).  A side shorter than the kernel
    (2 int(3 sigma) + 1 taps) fails in both: the JAX package's reshape of
    the longer convolution raises, the port raises ValueError."""
    img = np.random.default_rng(3).random((60, 52, 4)).astype(np.float32)
    ref = np.asarray(jinv.gaussian_blur(jnp.asarray(img), sigma))
    got = tinv.gaussian_blur(torch.from_numpy(img), sigma).numpy()
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if sigma > 0:
        short = img[:, : 2 * int(3 * sigma)]
        with pytest.raises(TypeError):
            jinv.gaussian_blur(jnp.asarray(short), sigma)
        with pytest.raises(ValueError, match="shorter than"):
            tinv.gaussian_blur(torch.from_numpy(short), sigma)


def _small_scene(pkg, **kw):
    """A hollow disk and a sphere, untextured: the multiview loss's scene
    (the JAX dense frame of a small scene compiles in seconds)."""
    return pkg.build_scene([pkg.HollowDisk(material=pkg.Material()),
                            pkg.Sphere(pos=(-7.0, -0.5, 7.0), radius=0.6,
                                       material=pkg.Material())], [], **kw)


def test_make_multiview_loss_matches_jax():
    """make_multiview_loss (renderer="jnp") against the JAX package's on a
    two-view rig: blur levels (2, 1) with weight maps, and pool levels
    (1, 2) without; values within 1e-4 relative; a zero weight map gives 0.
    Both JAX losses are one compile."""
    cfg = st.RenderConfig(width=24, height=16, max_steps=20,
                          percent_black=-1.0, checkpoint_every=10)
    jsc = _small_scene(st)
    cam = jconfigs.demo_camera()
    bg = jconfigs.background_texture()
    rng = np.random.default_rng(11)
    targets = [rng.random((16, 24, 4)).astype(np.float32) for _ in range(2)]
    offs = [np.zeros(3, np.float32), np.array([0.5, 0.0, 0.0], np.float32)]
    weights = [rng.random((16, 24)).astype(np.float32) for _ in range(2)]
    kws = [dict(blur_sigmas=(2.0, 1.0), view_weights=weights),
           dict(pyramid=(1, 2))]
    jp = jinv.init_params(cam, 0.8)

    def jlosses(p):
        return [jinv.make_multiview_loss(jsc, cfg, bg, None, None, targets,
                                         offs, renderer="jnp", **kw)(p)
                for kw in kws]

    ref = [float(x) for x in jax.jit(jlosses)(jp)]
    tsc = _small_scene(sp, device="cpu")
    tcfg = convert.render_config(cfg)
    tbg = convert.texture(_np(bg), device="cpu")
    tp = tinv.init_params(convert.camera(_np(cam), device="cpu"), 0.8)
    for kw, r in zip(kws, ref):
        got = tinv.make_multiview_loss(tsc, tcfg, tbg, None, None, targets,
                                       offs, renderer="jnp", **kw)(tp)
        np.testing.assert_allclose(got.item(), r, rtol=1e-4)
    zero = tinv.make_multiview_loss(
        tsc, tcfg, tbg, None, None, targets, offs, renderer="jnp",
        view_weights=[np.zeros((16, 24), np.float32)] * 2)
    assert zero(tp).item() == 0.0
    with pytest.raises(ValueError):
        tinv.make_multiview_loss(tsc, tcfg, tbg, None, None, targets, offs,
                                 view_weights=[])


def test_pack_unpack_pose_round_trip(config5):
    """pack_pose equals the JAX package's vector; unpack_pose puts it back
    into the same parameters, leaving the texels alone."""
    j, t, _ = config5
    jp = jinv.init_params(j["camera"], 0.7, j["tex"], DISK)
    tp = tinv.init_params(t["camera"], 0.7, t["tex"], DISK)
    v = tinv.pack_pose(tp)
    assert v.dtype == np.float32 and v.shape == (11,)
    np.testing.assert_array_equal(v, jinv.pack_pose(jp))
    back = tinv.unpack_pose(v + 1.0, tp)
    np.testing.assert_array_equal(tinv.pack_pose(back), v + 1.0)
    assert back.disk_texture is tp.disk_texture
    np.testing.assert_array_equal(tinv.CEM_DEFAULT_STD, jinv.CEM_DEFAULT_STD)


def test_cem_fit_pose_matches_jax():
    """cem_fit_pose on the JAX suite's synthetic quadratic
    (tests/test_inverse.py::test_cem_fit_pose_finds_known_minimum): the
    same draws, so the history equals JAX's within 1e-5 relative and the
    final pose within 1e-5; it finds the optimum."""
    cam = jconfigs.demo_camera()
    p_start = jinv.init_params(cam, 0.7)
    p_true = jinv.init_params(
        cam._replace(pos=jnp.asarray(cam.pos) + jnp.asarray(
            [0.2, -0.1, 0.15], jnp.float32)), 1.0)
    v_true = jinv.pack_pose(p_true)

    def jloss(p):
        v = jnp.concatenate([jnp.ravel(x) for x in (
            p.r_s_raw[None], p.cam_pos, p.cam_fwd_raw, p.cam_right_raw,
            p.fov[None])])
        return jnp.sum((v - v_true) ** 2)

    def tloss(p):
        v = torch.cat([x.reshape(-1) for x in (
            p.r_s_raw, p.cam_pos, p.cam_fwd_raw, p.cam_right_raw, p.fov)])
        return torch.sum((v - torch.from_numpy(v_true)) ** 2)

    kw = dict(n_iters=25, pop=48, elite=12, seed=1)
    jfit, jinfo = jinv.cem_fit_pose(jloss, p_start, **kw)
    tfit, tinfo = tinv.cem_fit_pose(
        tloss, tinv.init_params(convert.camera(_np(cam), device="cpu"), 0.7),
        **kw)
    np.testing.assert_allclose(tinfo["history"], jinfo["history"], rtol=1e-5)
    np.testing.assert_allclose(tinv.pack_pose(tfit), jinv.pack_pose(jfit),
                               rtol=0, atol=1e-5)
    assert tinfo["best_loss"] < 1e-3
    np.testing.assert_allclose(tinv.pack_pose(tfit), v_true, atol=0.05)
