"""The CUDA march kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  This file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

import schwarzschild_tpu_torch as sp
from schwarzschild_tpu_torch import camera as cam_mod
from schwarzschild_tpu_torch import configs
from schwarzschild_tpu_torch import geometry as geo
from schwarzschild_tpu_torch import kernel, kernel_scene, physics

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _rays(dev, W, H, drop=0.0):
    cam = configs.demo_camera(device=dev)
    u, v = cam_mod.pixel_grid(W, H, device=dev)
    o, d = cam_mod.generate_rays(cam, u, v, W, H)
    active = ~physics.is_radial(d, geo.safe_normalize(o))
    if drop:
        g = torch.Generator(device="cpu").manual_seed(0)
        active &= (torch.rand((H, W), generator=g) >= drop).to(dev)
    return o, d, active


def _agree(a, b, frac=0.999):
    ok = a == b
    assert ok.float().mean().item() >= frac, ok.float().mean().item()


# 77 x 43 = 3311 rays: not a multiple of the 128-thread block.
@pytest.mark.parametrize("size,drop", [((77, 43), 0.3), ((256, 256), 0.0)])
def test_march_bh_kernel_matches_plain(dev, size, drop):
    o, d, active = _rays(dev, *size, drop=drop)
    cfg = sp.RenderConfig(width=size[0], height=size[1], percent_black=-1.0)
    before = kernel.march_bh.launches
    fdir, status = kernel.march_bh(o, d, active, 1.0, cfg)
    torch.cuda.synchronize()
    assert kernel.march_bh.launches == before + 1
    pfdir, pstatus = kernel.march_bh_torch(o, d, active, 1.0, cfg)
    _agree(status, pstatus)
    same = status == pstatus
    assert torch.allclose(fdir[same], pfdir[same], rtol=0, atol=1e-3)
    assert (status[~active] == kernel.STATUS_ESCAPED).all()
    assert torch.equal(fdir[~active], d[~active])


@pytest.mark.parametrize("n_slots,opaque", [(4, True), (3, False)])
def test_march_scene_kernel_matches_plain(dev, n_slots, opaque):
    o, d, active = _rays(dev, 160, 90, drop=0.2)
    cfg = sp.RenderConfig(width=160, height=90, percent_black=-1.0)
    sc = configs.demo_scene(device=dev)
    tex = configs.demo_texture_stack(device=dev) if opaque else None
    before = kernel_scene.march_scene.launches
    out = kernel_scene.march_scene(o, d, active, 1.0, sc, cfg, n_slots, tex)
    torch.cuda.synchronize()
    assert kernel_scene.march_scene.launches == before + 1
    ref = kernel_scene.march_scene_torch(o, d, active, 1.0, sc, cfg, n_slots,
                                         tex)
    _agree(out[2], ref[2])
    _agree(out[4], ref[4])
    same = (out[2] == ref[2]) & (out[4] == ref[4])
    for a, b in [(out[0], ref[0]), (out[1], ref[1])] + [
            (x, y) for s0, s1 in zip(out[3], ref[3]) for x, y in zip(s0, s1)]:
        assert torch.allclose(a[same], b[same], rtol=1e-3, atol=1e-3)
    if not opaque:
        assert (out[4] >= 2).any()  # rays record more than one crossing


def test_empty_and_inactive_inputs(dev):
    cfg = sp.RenderConfig(width=4, height=0, percent_black=-1.0)
    empty = torch.zeros((0, 4, 3), device=dev)
    fdir, status = kernel.march_bh(empty, empty, torch.zeros(
        (0, 4), dtype=torch.bool, device=dev), 1.0, cfg)
    assert fdir.shape == (0, 4, 3) and status.shape == (0, 4)
    o, d, active = _rays(dev, 16, 8)
    out = kernel_scene.march_scene(o, d, torch.zeros_like(active), 1.0,
                                   configs.demo_scene(device=dev),
                                   dataclasses.replace(cfg, height=8,
                                                       width=16))
    assert (out[2] == kernel_scene.STATUS_ESCAPED).all()
    assert (out[4] == 0).all() and all((s[2] == 0).all() for s in out[3])


def test_wrappers_refuse_non_contiguous_input(dev):
    o, d, active = _rays(dev, 16, 8)
    cfg = sp.RenderConfig(width=16, height=8)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.march_bh(o.transpose(0, 1), d.transpose(0, 1), active.T,
                        1.0, cfg)


@pytest.mark.parametrize("raytrace_type", [sp.CURVED, sp.HALF_WIDTH])
def test_render_fast_on_card_matches_cpu(dev, raytrace_type):
    cfg = sp.RenderConfig(width=64, height=36, percent_black=0.5,
                          raytrace_type=raytrace_type, crosshair=True)
    args = [configs.demo_scene(), configs.demo_camera(), cfg,
            configs.background_texture(), configs.demo_texture_stack()]
    cpu = sp.render_fast(*args)
    gpu = sp.render_fast(*[sp.to_device(a, dev) for a in args]).cpu()
    ok = ((gpu - cpu).abs().amax(-1) < 2e-3).float().mean().item()
    assert ok >= 0.995, ok
