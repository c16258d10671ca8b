"""The port's two example scripts run in-process on the CPU at tiny sizes:
examples/live_viewer_torch.py with --script and --artifact (every frame
an (H, W, 3) uint8 image, the timing artifact written), and
examples/render_configs_torch.py for configs 1-4 (the PNGs written and
decodable at the scaled size, config 4's eight flyby frames).  Neither
example imports jax."""

import importlib.util
import json
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _png_size(path):
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                              "big")
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    assert len(zlib.decompress(idat)) == h * (1 + 3 * w)
    return w, h


def test_examples_import_no_jax():
    code = ("import sys, runpy; sys.argv = ['x', '--help']\n"
            "for f in ('live_viewer_torch', 'render_configs_torch'):\n"
            "    try:\n"
            "        runpy.run_path(f'examples/{f}.py', run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "import schwarzschild_tpu_torch.sharding, "
            "schwarzschild_tpu_torch.viewer, "
            "schwarzschild_tpu_torch.oracle.reference\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'schwarzschild_tpu']\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_live_viewer_script(tmp_path, capsys):
    viewer_ex = _example("live_viewer_torch")
    art = tmp_path / "viewer.json"
    times = viewer_ex.main(["--device", "cpu", "--width", "24",
                            "--height", "12", "--script", "wa2r1hxq",
                            "--artifact", str(art)])
    assert len(times) == 8  # the 'q' frame is drawn, then the loop quits
    rec = json.loads(art.read_text())
    assert rec["frames"] == 8 and rec["keys"] == list("wa2r1hxq")
    assert "script ok: 8 frames" in capsys.readouterr().out


def test_live_viewer_frames(tmp_path):
    """make_renderer's frames: uint8 (H, W, 3), the crosshair drawn, the
    FLAT mode frame differs from the curved one, and a test ray toggled on
    changes the frame."""
    import schwarzschild_tpu_torch as sp
    from schwarzschild_tpu_torch import configs, viewer

    viewer_ex = _example("live_viewer_torch")
    conf = dict(scene=configs.demo_scene(device="cpu"),
                background=configs.background_texture(device="cpu"),
                tex=configs.demo_texture_stack(device="cpu"))
    frame = viewer_ex.make_renderer(conf, 32, 16, "cpu")
    s = viewer.apply_key(viewer.initial_state(), "left")
    img = frame(s)
    assert img.shape == (16, 32, 3) and img.dtype == np.uint8
    ref = sp.to_uint8(sp.render_fast(
        conf["scene"], s.cam, sp.RenderConfig(
            width=32, height=16, percent_black=-1.0, crosshair=True),
        conf["background"], conf["tex"], 1.0, overflow="ignore")).numpy()
    np.testing.assert_array_equal(img, ref)
    assert not np.array_equal(frame(viewer.apply_key(s, "2")), img)
    assert frame(viewer.apply_key(s, "r")).shape == img.shape


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_render_configs(tmp_path, n):
    rc = _example("render_configs_torch")
    written = rc.main(["--device", "cpu", "--config", str(n), "--fast",
                       "--scale", "0.02", "--out", str(tmp_path)])
    paths = written[n]
    assert len(paths) == (8 if n == 4 else 1)
    for p in paths:
        w, h = _png_size(p)
        assert w >= 16 and h >= 16
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert any(json.loads(x)["event"].startswith("config") for x in lines)
