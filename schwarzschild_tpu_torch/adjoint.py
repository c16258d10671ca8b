"""Differentiable renderers (counterpart of ``schwarzschild_tpu.adjoint``).

Both renderers run the march kernel forward and the adjoint kernel backward
(``backward="kernel"``): the march is a ``torch.autograd.Function`` whose
backward is ``kernel_scene.march_scene_bwd``, and everything around it
differentiates through torch autograd.  The JAX package's other mode,
``backward="twin"`` (jax.vjp of the dense ``render.py`` renderer, kept there
as a gradient oracle), needs that renderer, which is not ported.
"""

from __future__ import annotations

from typing import Optional

from .config import RenderConfig
from .kernel import render_horizon_sky
from .kernel_scene import render_fast
from .scene import Scene
from .textures import Texture, TextureStack


def _check_backward(backward: str):
    if backward == "twin":
        raise NotImplementedError(
            "backward='twin' needs the dense render.py renderer, which "
            "schwarzschild_tpu_torch does not have yet (ROADMAP.md queue 1)")
    if backward != "kernel":
        raise ValueError(f"unknown backward mode {backward!r}")


def make_diff_horizon_sky(cfg: RenderConfig, backward: str = "kernel"):
    """f(cam, background_data, r_s) -> (H, W, 4), differentiable in all
    three."""
    _check_backward(backward)

    def f(cam, bg_data, r_s):
        return render_horizon_sky(cam, cfg, Texture(data=bg_data), r_s,
                                  differentiable=True)

    return f


def make_diff_scene_renderer(cfg: RenderConfig, sc: Scene,
                             tex: Optional[TextureStack] = None,
                             n_slots: int = 4, backward: str = "kernel"):
    """f(cam, background_data, r_s) -> image of the scene ``sc``, which is
    closed over with ``tex``; differentiable in all three arguments."""
    _check_backward(backward)

    def f(cam, bg_data, r_s):
        return render_fast(sc, cam, cfg, Texture(data=bg_data), tex, r_s,
                           n_slots=n_slots, overflow="ignore",
                           differentiable=True)

    return f
