"""Inverse rendering (counterpart of ``schwarzschild_tpu.inverse``): fit
the black hole's r_s, the camera pose and a disk texture to target images
(BASELINE config 5).

Parameters live in :class:`InverseParams`, a NamedTuple of tensors; the
camera's forward and right vectors are free and Gram-Schmidt-orthonormalized
inside the loss, and r_s goes through softplus so it stays positive.  A
loss renders with the dense differentiable renderer (``renderer="jnp"``,
``render.render``) or through ``render_fast(differentiable=True)``
(``renderer="fast"``: the march kernel forward, the adjoint kernel
backward).  :func:`make_multiview_loss` sums Gaussian-blurred or pooled
MSEs over views from a calibrated rig, and :func:`cem_fit_pose` searches
the 11 pose and mass scalars without gradients, as the JAX package's
config-5 harness drives them before Adam.

The optimizer is optax's chain in the JAX package, rewritten here on
tensors with optax's arithmetic and step numbering: zero the non-finite
gradient entries (and count them), clip by global norm, then Adam, with an
optional cosine-decay schedule.  Checkpoints are ``torch.save`` files
``<dir>/step_<N>.pt``.

``make_loss(pass_atlas=True)`` takes the fetch atlas as an argument of the
loss, built once by the caller (``textures.build_atlas_cached``) and
carried through ``make_train_step``'s extra arguments.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import geometry as geo
from .camera import Camera
from .kernel_scene import render_fast
from .render import render
from .textures import TextureStack


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y):
    y = np.asarray(y, np.float64)
    return np.log(np.expm1(y)).astype(np.float32)


class InverseParams(NamedTuple):
    r_s_raw: torch.Tensor  # () softplus^-1 of the Schwarzschild radius
    cam_pos: torch.Tensor  # (3,)
    cam_fwd_raw: torch.Tensor  # (3,) free forward vector
    cam_right_raw: torch.Tensor  # (3,) free right vector
    fov: torch.Tensor  # ()
    disk_texture: Optional[torch.Tensor]  # (Hmax, Wmax, 4) stack-slot texels


def init_params(cam: Camera, r_s: float = 1.0,
                tex: Optional[TextureStack] = None,
                disk_slot: Optional[int] = None) -> InverseParams:
    """Parameters on the device of ``cam``, copied from it (and from slot
    ``disk_slot`` of ``tex``)."""
    disk = None
    if tex is not None and disk_slot is not None:
        disk = tex.data[disk_slot].detach().clone()
    dev = cam.pos.device
    return InverseParams(
        r_s_raw=torch.as_tensor(_inv_softplus(r_s), device=dev),
        cam_pos=cam.pos.detach().clone().float(),
        cam_fwd_raw=cam.forward.detach().clone().float(),
        cam_right_raw=cam.right.detach().clone().float(),
        fov=torch.as_tensor(cam.fov, dtype=torch.float32,
                            device=dev).detach().clone(),
        disk_texture=disk,
    )


def realize(params: InverseParams, tex: Optional[TextureStack],
            disk_slot: Optional[int]):
    """Params -> (camera, r_s, texture stack) with orthonormalized axes."""
    f = geo.safe_normalize(params.cam_fwd_raw)
    r = geo.safe_normalize(params.cam_right_raw
                           - f * geo.dot(params.cam_right_raw, f))
    u = geo.cross(r, f)  # camera.cpp:10 convention
    cam = Camera(pos=params.cam_pos, axes=torch.stack([r, u, f], dim=-1),
                 fov=params.fov)
    r_s = _softplus(params.r_s_raw)
    if (tex is not None and disk_slot is not None
            and params.disk_texture is not None):
        data = torch.cat([tex.data[:disk_slot], params.disk_texture[None],
                          tex.data[disk_slot + 1:]])
        tex = tex._replace(data=data)
    return cam, r_s, tex


def _renderer(name: str):
    """f(sc, cam, cfg, background, tex, r_s) -> image for a loss:
    "jnp" the dense differentiable renderer, "fast" render_fast with the
    adjoint kernel."""
    if name == "jnp":
        return render
    if name == "fast":
        def fast(sc, cam, cfg, background, tex, r_s, atlas=None):
            return render_fast(sc, cam, cfg, background, tex, r_s,
                               overflow="ignore", differentiable=True,
                               atlas=atlas)

        return fast
    raise ValueError(f"unknown renderer {name!r}")


def _image(x, device):
    """An image (tensor, numpy array or array-like) as float32 on device."""
    if not isinstance(x, torch.Tensor):
        x = np.array(x, np.float32)  # a writable copy
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_loss(sc, cfg, background, tex: Optional[TextureStack],
              disk_slot: Optional[int], target, renderer: str = "jnp",
              pass_atlas: bool = False):
    """Mean-squared pixel error of the rendered image against ``target``
    (H, W, 4): ``loss_fn(params) -> scalar tensor``.

    ``renderer="jnp"`` renders with the dense differentiable renderer
    (``render.render``), ``"fast"`` with ``render_fast(differentiable=True)``.
    ``pass_atlas`` ("fast" only): the loss is ``loss_fn(params, atlas)``,
    the fetch atlas (``textures.build_atlas_cached(background, tex)``)
    built once by the caller and passed to every step
    (``make_train_step``'s extra arguments); the texels are then
    constants, so it needs ``disk_slot=None``."""
    if pass_atlas and renderer == "fast" and disk_slot is not None:
        raise ValueError(
            "pass_atlas requires disk_slot=None: optimizing texels needs "
            "the atlas rebuilt from the optimized stack each step")
    if pass_atlas and renderer == "jnp":
        raise ValueError("pass_atlas only applies to renderer='fast'")
    render_any = _renderer(renderer)
    target = _image(target, background.data.device)

    if pass_atlas:
        def loss_fn(params: InverseParams, atlas):
            cam, r_s, tex_p = realize(params, tex, disk_slot)
            img = render_any(sc, cam, cfg, background, tex_p, r_s,
                             atlas=atlas)
            return torch.mean((img - target) ** 2)
    else:
        def loss_fn(params: InverseParams):
            cam, r_s, tex_p = realize(params, tex, disk_slot)
            img = render_any(sc, cam, cfg, background, tex_p, r_s)
            return torch.mean((img - target) ** 2)

    return loss_fn


def _avg_pool(img, k):
    h, w, c = img.shape
    return img[: h // k * k, : w // k * k].reshape(
        h // k, k, w // k, k, c).mean(dim=(1, 3))


def gaussian_blur(img, sigma):
    """Separable Gaussian blur of an (H, W, C) image, zero-padded (the edge
    effect is shared by render and target, so it cancels in an MSE).

    Each axis is ``numpy.convolve(mode="same")`` with the normalized kernel
    of radius int(3 sigma), as the JAX package computes it.  A side shorter
    than the kernel raises ValueError (the JAX package's reshape fails
    there).  Unlike pooling, blur keeps subpixel localization (see
    :func:`make_multiview_loss`)."""
    if sigma <= 0:
        return img
    r = int(3.0 * sigma)
    if min(img.shape[0], img.shape[1]) < 2 * r + 1:
        raise ValueError(f"gaussian_blur: image {tuple(img.shape)} has a "
                         f"side shorter than the sigma={sigma} kernel "
                         f"({2 * r + 1} taps)")
    x = np.arange(-r, r + 1)
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    # conv1d correlates: the kernel reversed convolves (a no-op here, the
    # kernel being symmetric).
    k = torch.as_tensor((k / k.sum())[::-1].copy(), dtype=torch.float32,
                        device=img.device)

    def conv_axis(a, axis):
        a2 = torch.movedim(a, axis, -1)
        out = torch.nn.functional.conv1d(a2.reshape(-1, 1, a2.shape[-1]),
                                         k[None, None], padding=r)
        return torch.movedim(out.reshape(a2.shape), -1, axis)

    return conv_axis(conv_axis(img, 0), 1)


def make_multiview_loss(sc, cfg, background, tex: Optional[TextureStack],
                        disk_slot: Optional[int], targets, cam_offsets,
                        renderer: str = "fast", pyramid=(1,),
                        blur_sigmas=None, view_weights=None):
    """Mean MSE over V views; view i renders from the optimized camera
    translated by the known world-space offset ``cam_offsets[i]``: a
    calibrated rig whose baseline pins the camera's distance, and with it
    r_s, which one view cannot separate (the shadow's angular size goes as
    r_s / |cam|).  Orientation and every other parameter stay shared.

    ``targets``: V (H, W, 4) images; ``cam_offsets``: V (3,) offsets.
    ``blur_sigmas`` (e.g. (8., 2.)): sum the MSEs of Gaussian-blurred
    pairs (:func:`gaussian_blur`), each level a smooth basin about sigma
    pixels wide; otherwise ``pyramid``'s average-pool factors.
    ``view_weights``: V (H, W) maps multiplying each view's squared
    difference, normalized by the map's mean (the config-5 harness masks
    the disk's pixels out of the pose objective with them).  The renderer
    defaults to "fast", as in the JAX package."""
    if len(targets) != len(cam_offsets):
        raise ValueError("one camera offset per target view")
    render_any = _renderer(renderer)
    dev = background.data.device
    offs = [_image(o, dev) for o in cam_offsets]
    if blur_sigmas is not None:
        levels, lvl_of = list(blur_sigmas), gaussian_blur
    else:
        levels = list(pyramid)

        def lvl_of(img, k):
            return img if k == 1 else _avg_pool(img, k)
    tgt_pyr = [[lvl_of(_image(t, dev), k) for k in levels] for t in targets]
    if view_weights is not None:
        if len(view_weights) != len(targets):
            raise ValueError("one weight map per target view")
        wts = [_image(w, dev)[..., None] for w in view_weights]
    else:
        wts = [None] * len(targets)

    def loss_fn(params: InverseParams):
        cam, r_s, tex_p = realize(params, tex, disk_slot)
        total = torch.zeros((), device=dev)
        for tgts, off, w in zip(tgt_pyr, offs, wts):
            img = render_any(sc, cam._replace(pos=cam.pos + off), cfg,
                             background, tex_p, r_s)
            for k, tgt in zip(levels, tgts):
                d2 = (lvl_of(img, k) - tgt) ** 2
                if w is None:
                    total = total + torch.mean(d2)
                else:
                    total = total + (torch.mean(w * d2)
                                     / torch.clamp_min(torch.mean(w), 1e-6))
        return total / (len(targets) * len(levels))

    return loss_fn


def pack_pose(p: InverseParams) -> np.ndarray:
    """The 11 pose and mass scalars as a float32 numpy vector (r_s_raw,
    cam_pos, cam_fwd_raw, cam_right_raw, fov): the CEM search space."""
    return np.concatenate([
        np.ravel(np.asarray(torch.as_tensor(x).detach().cpu(), np.float32))
        for x in (p.r_s_raw, p.cam_pos, p.cam_fwd_raw, p.cam_right_raw,
                  p.fov)])


def unpack_pose(v, base: InverseParams) -> InverseParams:
    """``base`` with its 11 pose and mass scalars taken from ``v``, on the
    device of ``base.cam_pos``."""
    v = torch.as_tensor(np.asarray(v, np.float32), device=base.cam_pos.device)
    return base._replace(r_s_raw=v[0], cam_pos=v[1:4], cam_fwd_raw=v[4:7],
                         cam_right_raw=v[7:10], fov=v[10])


# Default CEM sampling stds per packed dimension: position ~0.3 world
# units, raw orientation vectors ~0.03 (a few degrees), r_s_raw ~0.3, fov
# ~3 degrees.
CEM_DEFAULT_STD = np.array(
    [0.3, 0.3, 0.3, 0.3, 0.03, 0.03, 0.03, 0.03, 0.03, 0.03, 3.0],
    np.float32)


def cem_fit_pose(loss_fn, p0: InverseParams, n_iters=40, pop=64, elite=16,
                 init_std=None, seed=0, log_fn=None):
    """Cross-entropy-method search over the 11 pose and mass scalars
    (texels and every other field stay at ``p0``): each iteration draws
    ``pop`` samples around the running mean from
    ``np.random.default_rng(seed)`` (the first sample is the mean itself),
    evaluates the loss of each without gradients, and refits the mean and
    the diagonal std (times 1.1, plus 1e-5) to the ``elite`` best.  The
    draws are the JAX package's, so on the same loss both search the same
    points.  A derivative-free search does not share gradient descent's
    sensitivity to the blurred loss's basins; Adam polishes after it.

    Returns (best params, {"best_loss", "history"}): the best sample seen,
    or the final mean if it scores no worse; ``history`` the best loss of
    each iteration."""
    init_std = (CEM_DEFAULT_STD if init_std is None
                else np.asarray(init_std, np.float32))

    def batch_loss(V):
        with torch.no_grad():
            return np.array([float(loss_fn(unpack_pose(v, p0))) for v in V],
                            np.float32)

    mu = pack_pose(p0)
    sig = init_std.copy()
    rng = np.random.default_rng(seed)
    best_v, best_l = mu, np.inf
    history = []
    for it in range(n_iters):
        V = mu[None] + sig[None] * rng.standard_normal(
            (pop, mu.size)).astype(np.float32)
        V[0] = mu  # elitism: the running mean always competes
        L = batch_loss(V)
        L = np.where(np.isfinite(L), L, np.inf)
        idx = np.argsort(L)[:elite]
        if L[idx[0]] < best_l:
            best_l, best_v = float(L[idx[0]]), V[idx[0]].copy()
        mu = V[idx].mean(0)
        sig = V[idx].std(0) * 1.1 + 1e-5
        history.append(float(L[idx[0]]))
        if log_fn and it % 5 == 0:
            log_fn(f"cem it{it}: best {L[idx[0]]:.6f} "
                   f"sig_pos~{float(sig[1:4].mean()):.3f}")
    # The final mean is the denoised estimate; keep whichever scores better.
    final_l = float(batch_loss(mu[None])[0])
    if final_l <= best_l:
        best_v, best_l = mu, final_l
    return unpack_pose(best_v, p0), dict(best_loss=best_l, history=history)


# ---------------------------------------------------------------------------
# The optimizer: optax's transformations, on lists of tensors.
# ---------------------------------------------------------------------------


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(updates, state)
    -> (updates, state)``, the updates a list of tensors in the order of
    the parameters' leaves (an InverseParams' fields, None skipped)."""

    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class ZeroNonfiniteState(NamedTuple):
    fired: torch.Tensor  # () int64: non-finite entries zeroed so far


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: tuple
    nu: tuple


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # () int32


def _leaves(params):
    """The tensors of an InverseParams (None skipped), or of a sequence."""
    return [x for x in params if x is not None]


def _zero_count(params, dtype=torch.int32):
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=dtype, device=dev)


def chain(*transforms) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def zero_nonfinite() -> GradientTransformation:
    """Zero the non-finite gradient entries and count them, on the
    device, as optax does.  The march backward is guarded to be finite
    everywhere, so this should never fire; :func:`nonfinite_fired` reads the
    count."""

    def init(params):
        return ZeroNonfiniteState(fired=_zero_count(params, torch.int64))

    def update(updates, state):
        finite = [torch.isfinite(g) for g in updates]
        fired = state.fired + sum((~f).sum() for f in finite)
        updates = [torch.where(f, g, torch.zeros_like(g))
                   for f, g in zip(finite, updates)]
        return updates, ZeroNonfiniteState(fired=fired)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's rule: scale every leaf by max_norm / |g| unless the global
    norm |g| is below max_norm (no epsilon, unlike clip_grad_norm_)."""

    def update(updates, state):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in updates))
        trigger = g_norm < max_norm
        return [torch.where(trigger, g, (g / g_norm) * max_norm)
                for g in updates], state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    def init(params):
        leaves = _leaves(params)
        return ScaleByAdamState(count=_zero_count(leaves),
                                mu=tuple(torch.zeros_like(x) for x in leaves),
                                nu=tuple(torch.zeros_like(x) for x in leaves))

    def update(updates, state):
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(updates, state.mu))
        nu = tuple((1 - b2) * (g * g) + b2 * v
                   for g, v in zip(updates, state.nu))
        count = state.count + 1
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=count.device) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=count.device) ** count
        out = [(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)]
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr) -> GradientTransformation:
    """Multiply by -lr, or by -lr(count) for a schedule evaluated at the
    count of earlier updates (0 first, as optax numbers them)."""
    if callable(lr):
        def update(updates, state):
            step = -lr(state.count)
            return ([step * g for g in updates],
                    ScaleByScheduleState(count=state.count + 1))

        return GradientTransformation(
            lambda params: ScaleByScheduleState(count=_zero_count(params)),
            update)
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda updates, state: ([-lr * g for g in updates], state))


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule: init_value * ((1 - alpha) * 0.5 * (1 +
    cos(pi * min(count, decay_steps) / decay_steps)) + alpha), in f32."""

    def schedule(count):
        count = torch.clamp(torch.as_tensor(count), max=decay_steps).to(
            torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def default_optimizer(learning_rate=2e-2,
                      decay_steps=None) -> GradientTransformation:
    """Zero non-finite entries, clip the global norm to 1, then Adam
    (optionally with a cosine decay to 1% over ``decay_steps``)."""
    lr = learning_rate
    if decay_steps:
        lr = cosine_decay_schedule(learning_rate, decay_steps, alpha=0.01)
    return chain(zero_nonfinite(), clip_by_global_norm(1.0), adam(lr))


def nonfinite_fired(opt_state) -> int:
    """Gradient entries the zero_nonfinite layer has zeroed so far (0 when
    the guards do their job)."""
    if isinstance(opt_state, ZeroNonfiniteState):
        return int(opt_state.fired)
    if isinstance(opt_state, tuple):
        return sum(nonfinite_fired(s) for s in opt_state)
    return 0


def _with_leaves(params: InverseParams, leaves):
    it = iter(leaves)
    return InverseParams(*(None if x is None else next(it) for x in params))


def make_train_step(loss_fn, optimizer: GradientTransformation):
    """``train_step(params, opt_state, *aux) -> (params, opt_state, loss)``:
    one value-and-gradient of ``loss_fn(params, *aux)`` and one optimizer
    update, the state from ``optimizer.init(params)``."""

    def train_step(params, opt_state, *aux):
        leaves = [x.detach().requires_grad_(True) for x in _leaves(params)]
        loss = loss_fn(_with_leaves(params, leaves), *aux)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        updates, opt_state = optimizer.update(grads, opt_state)
        new = [(x + u).detach() for x, u in zip(leaves, updates)]
        return _with_leaves(params, new), opt_state, loss.detach()

    return train_step


def _flatten(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, tuple):
        for x in tree:
            _flatten(x, out)
    return out


def _unflatten(template, leaves):
    if isinstance(template, torch.Tensor):
        return next(leaves).to(template.device)
    if isinstance(template, tuple):
        items = [_unflatten(x, leaves) for x in template]
        return (type(template)(*items) if hasattr(template, "_fields")
                else tuple(items))
    return template


class _Checkpointer:
    """``<dir>/step_<N>.pt`` files holding the (params, opt_state) tensors
    in order and the loss history; restored against a template tree."""

    def __init__(self, directory):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)

    def save(self, step, tree, history):
        path = self._dir / f"step_{step:08d}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(dict(leaves=[x.detach().cpu() for x in _flatten(tree, [])],
                        history=list(history)), tmp)
        tmp.replace(path)

    def restore_latest(self, template):
        steps = sorted(self._dir.glob("step_*.pt"))
        if not steps:
            return None
        latest = steps[-1]
        data = torch.load(latest, weights_only=True)
        step = int(latest.stem.split("_")[1])
        return step, _unflatten(template, iter(data["leaves"])), [
            float(x) for x in data["history"]]


def fit(sc, cfg, background, tex, disk_slot, target, cam0, r_s0=0.7,
        n_steps=200, learning_rate=2e-2, checkpoint_dir=None,
        checkpoint_every=50, log_every=10, log_fn=print, renderer="jnp"):
    """Optimize from ``cam0`` and ``r_s0`` for ``n_steps`` steps: (params,
    loss history).  With ``checkpoint_dir`` it resumes from the latest
    checkpoint there, and the history it returns covers every step,
    including those before the resume.  ``renderer`` as in
    :func:`make_loss`."""
    params = init_params(cam0, r_s0, tex, disk_slot)
    optimizer = default_optimizer(learning_rate)
    opt_state = optimizer.init(params)
    start_step = 0
    history = []

    ckpt = _Checkpointer(checkpoint_dir) if checkpoint_dir else None
    if ckpt:
        restored = ckpt.restore_latest((params, opt_state))
        if restored is not None:
            start_step, (params, opt_state), history = restored
            log_fn(f"resumed from step {start_step}")

    loss_fn = make_loss(sc, cfg, background, tex, disk_slot, target,
                        renderer=renderer)
    train_step = make_train_step(loss_fn, optimizer)
    for step in range(start_step, n_steps):
        params, opt_state, loss = train_step(params, opt_state)
        history.append(float(loss))
        if log_every and step % log_every == 0:
            log_fn(f"step {step}: loss {float(loss):.6f}")
        if ckpt and checkpoint_every and (step + 1) % checkpoint_every == 0:
            ckpt.save(step + 1, (params, opt_state), history)
    fired = nonfinite_fired(opt_state)
    if fired:
        log_fn(f"WARNING: {fired} non-finite gradient entries were zeroed; "
               "the march backward's guards should make this impossible "
               "(see inverse.zero_nonfinite)")
    if ckpt:
        ckpt.save(n_steps, (params, opt_state), history)
    return params, history
