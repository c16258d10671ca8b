"""Differentiable renderers (counterpart of ``schwarzschild_tpu.adjoint``).

Both renderers run a march kernel forward.  ``backward="kernel"`` (the
default) differentiates through the march's ``torch.autograd.Function``,
whose backward is the adjoint kernel ``kernel_scene.march_scene_bwd``, and
through torch autograd around it.  ``backward="twin"`` is the JAX package's
gradient oracle: the forward is the kernel frame, computed without a
graph, and the backward recomputes the dense differentiable renderer
(``render.render``) and takes its vector-Jacobian product, as ``jax.vjp``
of the dense twin does there.
"""

from __future__ import annotations

from typing import Optional

import torch

from .camera import Camera
from .config import RenderConfig
from .kernel import render_horizon_sky
from .kernel_scene import render_fast
from .render import render
from .scene import Scene, empty_scene
from .textures import Texture, TextureStack


def _check_backward(backward: str):
    if backward not in ("kernel", "twin"):
        raise ValueError(f"unknown backward mode {backward!r}")


class _TwinFrame(torch.autograd.Function):
    """A frame whose forward is ``kernel_frame`` and whose backward is the
    VJP of ``dense_frame``, both f(cam, bg_data, r_s) -> image.  The camera
    travels as its three tensors, since a Function's gradients go to
    tensor arguments."""

    @staticmethod
    def forward(ctx, kernel_frame, dense_frame, pos, axes, fov, bg_data, r_s):
        ctx.dense_frame = dense_frame
        ctx.save_for_backward(pos, axes, fov, bg_data, r_s)
        return kernel_frame(Camera(pos=pos, axes=axes, fov=fov), bg_data, r_s)

    @staticmethod
    def backward(ctx, g_img):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[2:])]
        pos, axes, fov, bg_data, r_s = inputs
        with torch.enable_grad():
            img = ctx.dense_frame(Camera(pos=pos, axes=axes, fov=fov),
                                  bg_data, r_s)
        grads = iter(torch.autograd.grad(
            img, [x for x in inputs if x.requires_grad], g_img,
            allow_unused=True))
        return (None, None, *(next(grads) if x.requires_grad else None
                              for x in inputs))


def _twin(kernel_frame, dense_frame):
    def f(cam, bg_data, r_s):
        dev = bg_data.device
        r_s = torch.as_tensor(r_s, dtype=torch.float32, device=dev)
        fov = torch.as_tensor(cam.fov, dtype=torch.float32, device=dev)
        return _TwinFrame.apply(kernel_frame, dense_frame, cam.pos, cam.axes,
                                fov, bg_data, r_s)

    return f


def make_diff_horizon_sky(cfg: RenderConfig, backward: str = "kernel"):
    """f(cam, background_data, r_s) -> (H, W, 4), differentiable in all
    three.  ``backward="twin"``: the horizon kernel's frame forward, the
    dense renderer on the empty scene backward."""
    _check_backward(backward)

    def kernel_frame(cam, bg_data, r_s):
        return render_horizon_sky(cam, cfg, Texture(data=bg_data), r_s,
                                  differentiable=backward == "kernel")

    if backward == "kernel":
        return kernel_frame

    def dense_frame(cam, bg_data, r_s):
        return render(empty_scene(device=bg_data.device), cam, cfg,
                      Texture(data=bg_data), None, r_s)

    return _twin(kernel_frame, dense_frame)


def make_diff_scene_renderer(cfg: RenderConfig, sc: Scene,
                             tex: Optional[TextureStack] = None,
                             n_slots: int = 4, backward: str = "kernel"):
    """f(cam, background_data, r_s) -> image of the scene ``sc``, which is
    closed over with ``tex``; differentiable in all three arguments.
    ``backward="twin"``: ``render_fast`` forward (no graph), the dense
    renderer's VJP backward."""
    _check_backward(backward)

    def kernel_frame(cam, bg_data, r_s):
        return render_fast(sc, cam, cfg, Texture(data=bg_data), tex, r_s,
                           n_slots=n_slots, overflow="ignore",
                           differentiable=backward == "kernel")

    if backward == "kernel":
        return kernel_frame

    def dense_frame(cam, bg_data, r_s):
        return render(sc, cam, cfg, Texture(data=bg_data), tex, r_s)

    return _twin(kernel_frame, dense_frame)
