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
                             DISK, target)
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
    _, t, target = config5
    args = (t["scene"], t["cfg"], t["background"], t["tex"], 5, target)
    with pytest.raises(NotImplementedError):
        tinv.make_loss(*args, renderer="jnp")
    with pytest.raises(NotImplementedError):
        tinv.make_loss(*args, pass_atlas=True)
    from schwarzschild_tpu_torch import adjoint

    with pytest.raises(NotImplementedError):
        adjoint.make_diff_horizon_sky(t["cfg"], backward="twin")


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
    kw = dict(r_s0=0.7, log_fn=lambda s: None)
    _, full = tinv.fit(*args, n_steps=4, **kw)
    _, first = tinv.fit(*args, n_steps=2, checkpoint_dir=tmp_path,
                        checkpoint_every=1, **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001.pt", "step_00000002.pt"]
    messages = []
    params, resumed = tinv.fit(*args, n_steps=4, checkpoint_dir=tmp_path,
                               checkpoint_every=1, log_fn=messages.append,
                               r_s0=0.7)
    assert messages[0] == "resumed from step 2"
    assert resumed[:2] == first
    np.testing.assert_allclose(resumed, full, rtol=1e-6)
    assert np.isfinite(full).all() and float(tinv._softplus(
        params.r_s_raw)) != pytest.approx(0.7)
