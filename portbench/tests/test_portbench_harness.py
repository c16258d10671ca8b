"""The benchmark's manifest, its files found by name, its result line, and
what its modules import.  CPU only:

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in MANIFEST["end_to_end"]]
             + [m["name"] for m in MANIFEST["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert len(n) <= 64 and set(n) <= NAME_CHARS, n
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in CELLS
            # The cells that read it report the metric it moves.
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = run.load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert (BENCH / "traffic" / f"{cell.traffic_name}.json").is_file()
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(run.reader(m["name"]))


def test_added_files_alone_add_a_cell(tmp_path):
    """A configuration, a traffic mix, the driver of a new traffic kind and
    a metric added as files, with their entries in the manifest, are found
    without a code edit."""
    shutil.copytree(BENCH, tmp_path / "portbench")
    man = json.loads(json.dumps(MANIFEST))
    cfg = json.loads((BENCH / "configs" / "config3_4k.json").read_text())
    cfg["name"] = "config3_1440p"
    cfg["render"].update(width=2560, height=1440)
    (tmp_path / "portbench" / "configs" / "config3_1440p.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "still.json").read_text())
    traffic["poses"] = 3
    traffic["kind"] = "frames_copy"
    (tmp_path / "portbench" / "traffic" / "still3.json").write_text(
        json.dumps(traffic))
    shutil.copy(BENCH / "kinds" / "frames.py",
                tmp_path / "portbench" / "kinds" / "frames_copy.py")
    (tmp_path / "portbench" / "metrics" / "frames.count.py").write_text(
        "def read(ctx):\n    return ctx['window'].count\n")
    man["configs"].append(dict(name="config3_1440p", source="x",
                               file="portbench/configs/config3_1440p.json",
                               reduced=[], why="x"))
    man["workloads"].append(dict(name="config3_1440p.still3",
                                 config="config3_1440p", traffic="still3",
                                 chips=1, why="x"))
    man["per_layer"].append(dict(name="frames.count", unit="frames",
                                 better="higher", source="program_counter",
                                 layer="frame entry", moves="frame_ms",
                                 workloads=["config3_1440p.still3"]))
    for m in man["end_to_end"]:
        if "workloads" in m and "frame" in m["name"]:
            m["workloads"].append("config3_1440p.still3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = run.load_cell("config3_1440p.still3", root=tmp_path)
    assert cell.config["render"]["width"] == 2560
    assert cell.traffic["poses"] == 3
    driver = run.kind(cell.traffic["kind"], root=tmp_path)
    assert driver.__file__ == str(tmp_path / "portbench" / "kinds"
                                  / "frames_copy.py")
    assert all(callable(getattr(driver, f)) for f in KIND_API)
    assert "frames.count" in {m["name"] for m in cell.per_layer}
    read = run.reader("frames.count", root=tmp_path)

    class W:
        count = 7

    assert read(dict(window=W())) == 7


KIND_API = ("load", "work", "check", "readings")


@pytest.mark.parametrize("traffic", sorted(
    p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_traffic_names_a_driver_file(traffic):
    kind = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())[
        "kind"]
    assert (BENCH / "kinds" / f"{kind}.py").is_file()
    driver = run.kind(kind)
    assert all(callable(getattr(driver, f)) for f in KIND_API)


@pytest.mark.parametrize("change", [
    dict(texture_filter="trilinear"), dict(raytrace_type=1),
    dict(crosshair=True), dict(horizon_softness=0.1),
    dict(percent_black=0.5, noise_mode="prng"),
    dict(percent_black=0.75, noise_mode="tile"), dict(not_a_field=1),
    dict(object="box")], ids=str)
def test_reference_refuses_what_it_does_not_render(change):
    """A render field or an object the reference does not follow fails
    loudly, instead of being compared with another renderer."""
    from portbench import inputs as I
    from portbench.reference import render as R

    cfg = json.loads((BENCH / "configs" / "config3_4k.json").read_text())
    change = dict(change)
    if "object" in change:
        cfg["scene"]["objects"].append(dict(type=change.pop("object")))
    with pytest.raises(R.Unsupported):
        I.reference_inputs(cfg, dict(render=change), I.raw_textures(cfg),
                           "cpu", scale=(32, 24))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    tops = {_top(n) for n in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "schwarzschild_tpu"}, tops


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {_top(n) for n in _imports(path)}
    assert "schwarzschild_tpu_torch" not in tops
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, tops


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax_and_reference_none_of_the_program():
    """In a fresh process: the reference alone loads nothing of the
    program; a whole tiny run loads neither JAX nor the JAX package
    (top-level module names compared whole)."""
    got = _python(
        "import sys, json, torch\n"
        "from portbench import inputs as I\n"
        "from portbench.reference import render as R\n"
        "cfg = I.load_json('portbench/configs/config3_4k.json')\n"
        "inp = I.reference_inputs(cfg, {}, I.raw_textures(cfg), 'cpu',"
        " scale=(32, 24))\n"
        "R.render_frame(inp, I.reference_pose(cfg['camera']), 1.0)\n"
        "ref_tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from portbench import run\n"
        "out = run.run_cell(run.load_cell('config3_4k.still'), 5, 0.2,"
        " False, torch.device('cpu'), scale=(32, 24))\n"
        "print(json.dumps(dict(ref=ref_tops, bad=run.forbidden_modules(),"
        " out=out)))\n")
    assert "schwarzschild_tpu_torch" not in got["ref"]
    assert got["bad"] == []
    out = got["out"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "config3_4k.still", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_with_only_the_benchmark(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone: no result."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "config3_4k.still", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
