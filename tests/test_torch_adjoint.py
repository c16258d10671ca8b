"""The port's gradient path through the march held against the JAX package
on the CPU: the forward's event planes, the hand-written VJP of one step
(``diff_step_vjp_torch``) against torch autograd and ``jax.vjp``, the plain
version of the adjoint kernel (``march_scene_bwd_torch``) against the Pallas
``march_scene_bwd`` in interpret mode, the differentiable marches against
JAX's gradients, and the ``backward="twin"`` renderers against the JAX
twin's gradients.  Each JAX reference runs once per module."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarzschild_tpu as st
import schwarzschild_tpu_torch as sp
from schwarzschild_tpu import camera as jcam
from schwarzschild_tpu import configs as jconfigs
from schwarzschild_tpu import geometry as jgeo
from schwarzschild_tpu import kernel as jkernel
from schwarzschild_tpu import kernel_scene as jks
from schwarzschild_tpu import physics as jphys
from schwarzschild_tpu_torch import convert
from schwarzschild_tpu_torch import kernel as tkernel
from schwarzschild_tpu_torch import kernel_scene as tks


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rays(cam, W, H):
    u, v = jcam.pixel_grid(W, H)
    o, d = jcam.generate_rays(cam, u, v, W, H)
    active = ~jphys.is_radial(d, jgeo.safe_normalize(o))
    return np.array(o), np.array(d), np.array(active)


@pytest.fixture(scope="module")
def demo():
    j = dict(scene=jconfigs.demo_scene(), cam=jconfigs.demo_camera(),
             tex=jconfigs.demo_texture_stack())
    t = dict(scene=convert.scene(_np(j["scene"]), device="cpu"),
             tex=convert.texture_stack(_np(j["tex"]), device="cpu"))
    return j, t


# ---------------------------------------------------------------------------
# Event planes of the forward march.
# ---------------------------------------------------------------------------


def _check_events(got, ref, active, max_steps):
    """Port events exact on the lanes whose status and nhits agree with the
    JAX kernel's, and those are at least 99.5% of the lanes."""
    same = ((got[2].numpy() == np.asarray(ref[2]))
            & (got[4].numpy() == np.asarray(ref[4])))
    assert same.mean() >= 0.995, same.mean()
    ev, ref_ev = got[5], ref[5]
    np.testing.assert_array_equal(ev["t_end"].numpy()[same],
                                  np.asarray(ref_ev["t_end"])[same])
    for a, b in zip(ev["ssteps"], ref_ev["ssteps"]):
        np.testing.assert_array_equal(a.numpy()[same], np.asarray(b)[same])
    te = ev["t_end"].numpy()
    assert (te[~active] == -1).all() and (te[active] >= 0).all()
    assert (ev["ssteps"][0].numpy() >= 0).any()
    # Executed lane-steps: every ray's loop iterations.
    assert int(got[6]) == int(np.minimum(te + 1, max_steps).sum()) > 0


def test_march_scene_events_match_pallas(demo):
    """t_end and sstep_k of march_scene_torch against the Pallas kernel's
    (interpret mode) at 32x24, a quarter of the lanes inactive, with the
    opaque stop on."""
    j, t = demo
    W, H = 32, 24
    o, d, active = _rays(j["cam"], W, H)
    active &= np.random.default_rng(0).random((H, W)) > 0.25
    cfg = st.RenderConfig(width=W, height=H, max_steps=20,
                          percent_black=-1.0)
    ref = jks.march_scene(o, d, active, 1.0, j["scene"], cfg, n_slots=3,
                          tex=j["tex"], interpret=True, events=True)
    got = tks.march_scene(_t(o), _t(d), _t(active), 1.0, t["scene"],
                          convert.render_config(cfg), n_slots=3,
                          tex=t["tex"], events=True, count_steps=True)
    _check_events(got, ref, active, cfg.max_steps)


def test_march_scene_events_match_pallas_recording_all(bwd_case):
    """The same at 64x16 with 4 slots and no opaque stop (every hit
    recorded): the forward of the adjoint tests below."""
    c = bwd_case
    _check_events(c["port_fwd"], c["fwd"], c["active"],
                  c["cfg"].max_steps)


# ---------------------------------------------------------------------------
# One step's VJP.
# ---------------------------------------------------------------------------


def _random_cores(n=96, seed=0):
    """Cores of four kinds: near the hole (r in [3, 20]); beyond the
    re-entry sphere and heading in (u < u_f: the far-field re-init); along
    the radius (the tangent vanishes and the re-init's dt guard would
    take over); and so far out (u = 1e-7) that the step ends past r = 1e6,
    where max(u1, 1e-6) takes over.  Plus live_in and moved masks with
    some lanes off, among them every far-out one."""
    rng = np.random.default_rng(seed)
    k = n // 3
    m = k + k + (n - 2 * k) // 2  # radial lanes: [2k, m), far out: [m, n)
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = np.concatenate([rng.uniform(3, 20, k), rng.uniform(110, 200, k),
                        rng.uniform(3, 20, m - 2 * k), np.full(n - m, 1e7)])
    p = dirs * r[:, None]
    d = rng.standard_normal((n, 3))
    d[k:2 * k] = -p[k:2 * k] / r[k:2 * k, None] + 0.2 * d[k:2 * k]
    d[2 * k:m] = -dirs[2 * k:m]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    core = list(tks._init_core_torch(_t(p.astype(np.float32)),
                                     _t(d.astype(np.float32))))
    du = core[13].numpy().copy()
    du += rng.uniform(-0.02, 0.02, n)
    du[2 * k:m] = rng.uniform(-0.05, 0.05, m - 2 * k)  # not -u nd / 1e-12
    du[m:] = -1e-4
    core[13] = _t(du.astype(np.float32))
    core[14] = _t(rng.uniform(0.0, 3.0, n).astype(np.float32))
    live_in = rng.random(n) > 0.1
    live_in[m:] = False
    live_in = _t(live_in)
    moved = _t(rng.random(n) > 0.2)
    return tuple(core), live_in, moved


@pytest.fixture(scope="module")
def vjp_case():
    cfg = sp.RenderConfig(width=8, height=8, max_steps=40,
                          percent_black=-1.0)
    core, live_in, moved = _random_cores()
    rng = np.random.default_rng(1)
    ct = tuple(_t(rng.standard_normal(96).astype(np.float32))
               for _ in range(15))
    ct_slot = tuple(_t(rng.standard_normal(96).astype(np.float32))
                    for _ in range(7))
    return dict(cfg=cfg, core=core, live_in=live_in, moved=moved, ct=ct,
                ct_slot=ct_slot, i=7, r_s=torch.tensor(1.1))


def _assert_grads_close(got, ref, names, tol=1e-4):
    for name, a, b in zip(names, got, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.isfinite(a).all(), name
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                                   err_msg=name)


def test_diff_step_vjp_matches_autograd(vjp_case):
    c = vjp_case
    core = tuple(x.clone().requires_grad_(True) for x in c["core"])
    r_s = c["r_s"].clone().requires_grad_(True)
    out, slot = tks.diff_step_torch(c["i"], core, c["live_in"], c["moved"],
                                    r_s, c["cfg"])
    total = sum((a * b).sum() for a, b in zip(out, c["ct"])) + sum(
        (a * b).sum() for a, b in zip(slot, c["ct_slot"]))
    ref = torch.autograd.grad(total, core + (r_s,))
    got, g_rs = tks.diff_step_vjp_torch(c["i"], c["core"], c["ct"],
                                        c["ct_slot"], c["live_in"],
                                        c["moved"], c["r_s"], c["cfg"])
    _assert_grads_close(list(got) + [g_rs.sum()], ref,
                        list(tks._CORE) + ["r_s"])
    # Each kind of lane is present: re-init, masked off, and a guard hit.
    max_angle, u_f, far_r2 = tkernel.march_scalars(c["cfg"])
    s = dict(zip(tks._CORE, c["core"]), live=c["live_in"])
    finish = tkernel._far_field(dict(s), u_f, far_r2)
    reinit = c["live_in"] & (c["core"][12] < u_f) & ~finish
    assert reinit.sum() >= 10 and (~c["live_in"]).any()
    n = torch.stack(c["core"][6:9], -1)
    d = torch.stack(c["core"][3:6], -1)
    assert ((n * d).sum(-1).abs() > 1 - 1e-6).sum() >= 10
    u1 = tkernel._rk4_segment(s, c["i"], c["r_s"], c["cfg"].max_steps,
                              max_angle)[0]["u"]
    assert (u1 < 1e-6).sum() >= 10


def test_diff_step_vjp_matches_jax(vjp_case):
    c = vjp_case
    cfg = c["cfg"]
    step = jks._make_diff_step(cfg.max_steps, float(cfg.max_angle),
                               float(cfg.u_f))
    core = tuple(jnp.asarray(x.numpy()) for x in c["core"])
    masks = (jnp.asarray(c["live_in"].numpy()), jnp.asarray(c["moved"].numpy()))
    rs = jnp.full(core[0].shape, 1.1, jnp.float32)
    _, vjp = jax.vjp(lambda cr, r: step(jnp.int32(c["i"]), cr, masks, r),
                     core, rs)
    ref_core, ref_rs = vjp((tuple(jnp.asarray(x.numpy()) for x in c["ct"]),
                            tuple(jnp.asarray(x.numpy())
                                  for x in c["ct_slot"])))
    got, g_rs = tks.diff_step_vjp_torch(c["i"], c["core"], c["ct"],
                                        c["ct_slot"], c["live_in"],
                                        c["moved"], c["r_s"], c["cfg"])
    _assert_grads_close([x.numpy() for x in got] + [g_rs.numpy()],
                        list(ref_core) + [ref_rs],
                        list(tks._CORE) + ["r_s"], tol=2e-4)


# ---------------------------------------------------------------------------
# The adjoint of the whole march.
# ---------------------------------------------------------------------------


def _masked_weights(agree, shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return w * agree.reshape(agree.shape + (1,) * (len(shape) - agree.ndim))


@pytest.fixture(scope="module")
def bwd_case(demo):
    """The tests/test_adjoint.py setup: 64x16 demo rays, 40 steps, 4 slots.
    The JAX kernel's forward with its events, the port's forward, random
    cotangents for every differentiable output, zero on the lanes where the
    two forwards part (tests/test_adjoint.py's masking), and the Pallas
    adjoint (interpret mode) on them: the gradient JAX's march_scene_diff
    returns for the functional sum(cotangent * output)."""
    j, t = demo
    W, H = 64, 16
    o, d, active = _rays(j["cam"], W, H)
    cfg = st.RenderConfig(width=W, height=H, max_steps=40,
                          percent_black=-1.0, checkpoint_every=0)
    fwd = jks.march_scene(o, d, active, 1.0, j["scene"], cfg, interpret=True,
                          events=True)
    port_fwd = tks.march_scene(_t(o), _t(d), _t(active), 1.0, t["scene"],
                               convert.render_config(cfg), events=True,
                               count_steps=True)
    agree = ((port_fwd[2].numpy() == np.asarray(fwd[2]))
             & (port_fwd[4].numpy() == np.asarray(fwd[4]))
             & (np.abs(port_fwd[0].numpy() - np.asarray(fwd[0]))
                < 1e-4).all(-1))
    assert agree.mean() > 0.99
    ct_fdir = _masked_weights(agree, (H, W, 3), 0)
    ct_fpos = _masked_weights(agree, (H, W, 3), 1)
    ct_slots = [(_masked_weights(agree, (H, W, 3), 2 + 3 * k),
                 _masked_weights(agree, (H, W, 3), 3 + 3 * k),
                 _masked_weights(agree, (H, W), 4 + 3 * k))
                for k in range(4)]
    ref = jks.march_scene_bwd(o, d, 1.0, cfg, (ct_fdir, ct_fpos, ct_slots),
                              fwd[2], fwd[5], n_slots=4, interpret=True)
    return dict(o=o, d=d, active=active, cfg=cfg, fwd=_np(fwd),
                port_fwd=port_fwd, status=np.asarray(fwd[2]),
                events=_np(fwd[5]), ct=(ct_fdir, ct_fpos, ct_slots),
                ref=_np(ref))


def _check_adjoint(got, ref):
    """tests/test_adjoint.py's rule: per output max |diff| <= 2e-3 of the
    reference's max |value|; g_r_s within 2e-3 relative."""
    for a, b in zip(got[:2], ref[:2]):
        a = a.numpy()
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * np.abs(b).max())
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=2e-3)


def test_march_scene_bwd_torch_matches_pallas(bwd_case):
    """march_scene_bwd_torch fed the JAX forward's status and events."""
    c = bwd_case
    ct_fdir, ct_fpos, ct_slots = c["ct"]
    ev = dict(t_end=_t(c["events"]["t_end"]),
              ssteps=[_t(x) for x in c["events"]["ssteps"]])
    got = tks.march_scene_bwd_torch(
        _t(c["o"]), _t(c["d"]), 1.0, convert.render_config(c["cfg"]),
        (_t(ct_fdir), _t(ct_fpos),
         [tuple(_t(x) for x in s) for s in ct_slots]),
        _t(c["status"]), ev, n_slots=4)
    _check_adjoint(got, c["ref"])


def test_march_scene_bwd_wrapper_runs_plain_version_on_cpu(bwd_case):
    c = bwd_case
    ct_fdir, ct_fpos, _ = c["ct"]
    ev = dict(t_end=_t(c["events"]["t_end"]), ssteps=[])
    args = (_t(c["o"]), _t(c["d"]), 1.0, convert.render_config(c["cfg"]),
            (_t(ct_fdir), _t(ct_fpos), []), _t(c["status"]), ev)
    before = tks.march_scene_bwd.launches
    a = tks.march_scene_bwd(*args, n_slots=0)
    b = tks.march_scene_bwd_torch(*args, n_slots=0)
    assert tks.march_scene_bwd.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_march_scene_diff_grads_match_jax(demo, bwd_case):
    """torch autograd through march_scene_diff (the port's forward, its own
    events, the plain adjoint) against JAX's march_scene_diff gradient of
    the same masked functional of every march output, with respect to
    origin, direction and r_s."""
    _, t = demo
    c = bwd_case
    ct_fdir, ct_fpos, ct_slots = c["ct"]
    leaves = [_t(c["o"]).requires_grad_(True),
              _t(c["d"]).requires_grad_(True),
              torch.tensor(1.0, requires_grad=True)]
    fdir, fpos, _, slots, _ = tks.march_scene_diff(
        leaves[0], leaves[1], _t(c["active"]), leaves[2], t["scene"],
        convert.render_config(c["cfg"]))
    total = (fdir * _t(ct_fdir)).sum() + (fpos * _t(ct_fpos)).sum()
    for (s0, d0, l0), (w0, w1, w2) in zip(slots, ct_slots):
        total = (total + (s0 * _t(w0)).sum() + (d0 * _t(w1)).sum()
                 + (l0 * _t(w2)).sum())
    _check_adjoint(torch.autograd.grad(total, leaves), c["ref"])


def test_march_bh_diff_grads_match_jax(demo):
    """The horizon + sky march's gradients with respect to origin,
    direction and r_s on the masked functional of
    tests/test_adjoint.py::test_horizon_sky_kernel_backward_grads (JAX's
    backward there is jax.vjp of its jnp replay; the port's is the adjoint
    kernel's plain version fed the forward's record)."""
    j, _ = demo
    W, H = 24, 16
    cfg = st.RenderConfig(width=W, height=H, max_steps=20,
                          percent_black=-1.0, checkpoint_every=10)
    tcfg = convert.render_config(cfg)
    o, d, _ = _rays(j["cam"], W, H)
    active = np.ones((H, W), bool)
    (jfd, jst), vjp = jax.vjp(
        lambda o_, d_, r: jkernel.march_bh_diff(o_, d_, active, r, cfg,
                                                interpret=True),
        jnp.asarray(o), jnp.asarray(d), jnp.float32(1.0))
    tfd, tst = tkernel.march_bh(_t(o), _t(d), _t(active), 1.0, tcfg)
    agree = ((tst.numpy() == np.asarray(jst))
             & (np.abs(tfd.numpy() - np.asarray(jfd)) < 1e-4).all(-1))
    assert agree.mean() > 0.99
    w = _masked_weights(agree, (H, W, 3), 0)
    ref = _np(vjp((jnp.asarray(w), jnp.zeros_like(jst))))
    leaves = [_t(o).requires_grad_(True), _t(d).requires_grad_(True),
              torch.tensor(1.0, requires_grad=True)]
    fd, _ = tkernel.march_bh_diff(leaves[0], leaves[1], _t(active),
                                  leaves[2], tcfg)
    got = torch.autograd.grad((fd * _t(w)).sum(), leaves)
    _check_adjoint(got, ref)


def test_flat_finish_capture_is_not_a_move():
    """A horizon + sky ray that finishes flat (far field, radial) and is
    then captured by the unbounded horizon test did not move at its end
    step: its direction passes its cotangent straight through.  Reading
    "moved" from its captured status, as for the scene march, would give
    another gradient."""
    cfg = sp.RenderConfig(width=2, height=1, max_steps=20,
                          percent_black=-1.0)
    d = np.array([[1e-5, 0.0, -1.0], [0.3, 0.1, -1.0]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.tensor([[[0.0, 0.0, 150.0], [0.0, 0.0, 12.0]]])
    d = torch.from_numpy(d)[None]
    active = torch.ones((1, 2), dtype=torch.bool)
    fdir, status, ev = tkernel.march_bh(o, d, active, 1.0, cfg, events=True)
    assert status[0, 0] == tkernel.STATUS_CAPTURED
    assert ev["t_end"][0, 0] == 0 and not ev["died_moving"][0, 0]
    assert torch.equal(fdir[0, 0], d[0, 0])

    w = torch.tensor([[[0.5, -2.0, 1.5], [1.0, 1.0, 1.0]]])
    leaves = [o.clone().requires_grad_(True), d.clone().requires_grad_(True),
              torch.tensor(1.0, requires_grad=True)]
    fd, _ = tkernel.march_bh_diff(leaves[0], leaves[1], active, leaves[2],
                                  cfg)
    g_o, g_d, _ = torch.autograd.grad((fd * w).sum(), leaves)
    assert torch.equal(g_d[0, 0], w[0, 0])
    assert torch.equal(g_o[0, 0], torch.zeros(3))
    moved = tks.march_scene_bwd_torch(
        o, d, 1.0, cfg, (w, torch.zeros_like(o), []), status,
        dict(t_end=ev["t_end"], ssteps=[]), n_slots=0)
    assert not torch.allclose(moved[1][0, 0], w[0, 0])


# ---------------------------------------------------------------------------
# backward="twin": the kernel frame forward, the dense renderer's VJP back.
# ---------------------------------------------------------------------------

TWIN_CFG = st.RenderConfig(width=24, height=16, max_steps=20,
                           percent_black=-1.0, checkpoint_every=10)


def _twin_scene(pkg, **kw):
    """A hollow disk and a sphere, untextured (the JAX dense gradient of a
    small scene compiles in seconds)."""
    return pkg.build_scene([pkg.HollowDisk(material=pkg.Material()),
                            pkg.Sphere(pos=(-7.0, -0.5, 7.0), radius=0.6,
                                       material=pkg.Material())], [], **kw)


@pytest.fixture(scope="module")
def twin_case():
    """jax.vjp of the JAX dense renderer, which is what its twin backward
    returns, on the empty scene (the horizon twin) and on _twin_scene, with
    respect to r_s, cam.pos, cam.fov and the background texels, for the
    cotangent w."""
    jrender = importlib.import_module("schwarzschild_tpu.render")
    cam = jconfigs.demo_camera()
    bg = jconfigs.background_texture()
    w = np.random.default_rng(7).random((16, 24, 4)).astype(np.float32)
    scenes = {"horizon": st.empty_scene(), "scene": _twin_scene(st)}

    def grads(r_s, pos, fov, bg_data):
        out = []
        for sc in scenes.values():
            def loss(r_s, pos, fov, bg_data, sc=sc):
                img = jrender.render(sc, cam._replace(pos=pos, fov=fov),
                                     TWIN_CFG, bg._replace(data=bg_data),
                                     None, r_s)
                return jnp.sum(img * w)

            out.append(jax.grad(loss, argnums=range(4))(r_s, pos, fov,
                                                        bg_data))
        return out

    ref = jax.jit(grads)(jnp.float32(1.0), cam.pos, cam.fov, bg.data)
    return dict(cam=cam, bg=bg, w=w,
                ref=dict(zip(scenes, ([np.asarray(g) for g in r]
                                      for r in ref))))


@pytest.mark.parametrize("kind", ["horizon", "scene"])
def test_twin_backward_matches_jax(twin_case, kind):
    """adjoint.make_diff_horizon_sky / make_diff_scene_renderer with
    backward="twin": the image is the kernel frame's (here its plain
    version), bit for bit, and the gradients in r_s, cam.pos, cam.fov and
    the background texels are the JAX twin's (tests/test_kernel_scene.py's
    rule, rtol 2e-2, atol 1e-3)."""
    from schwarzschild_tpu_torch import adjoint

    c = twin_case
    cfg = convert.render_config(TWIN_CFG)
    cam = convert.camera(_np(c["cam"]), device="cpu")
    bg = convert.texture(_np(c["bg"]), device="cpu")
    if kind == "horizon":
        f = adjoint.make_diff_horizon_sky(cfg, backward="twin")
        plain = tkernel.render_horizon_sky(cam, cfg, bg, 1.0)
    else:
        sc = _twin_scene(sp, device="cpu")
        f = adjoint.make_diff_scene_renderer(cfg, sc, None, backward="twin")
        plain = tks.render_fast(sc, cam, cfg, bg, None, 1.0,
                                overflow="ignore")
    leaves = [torch.tensor(1.0), cam.pos.clone(), cam.fov.clone(),
              bg.data.clone()]
    for x in leaves:
        x.requires_grad_(True)
    r_s, pos, fov, bg_data = leaves
    img = f(cam._replace(pos=pos, fov=fov), bg_data, r_s)
    assert torch.equal(img.detach(), plain)
    grads = torch.autograd.grad((img * torch.from_numpy(c["w"])).sum(),
                                leaves)
    for name, g, ref in zip(("r_s", "cam.pos", "cam.fov", "background"),
                            grads, c["ref"][kind]):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-2, atol=1e-3,
                                   err_msg=name)
    assert float(grads[0]) != 0.0 and (grads[3] != 0).any()
