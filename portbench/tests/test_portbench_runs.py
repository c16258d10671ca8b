"""Tiny CPU runs of every traffic mix through the whole harness, the check
failing under each fault the cells can have, and the controls failing it.
The card's own runs are in test_portbench_cuda.py.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import pytest
import torch

from portbench import control, run

CPU = torch.device("cpu")
# Tiny sizes: the frames' lane-sparse path needs a multiple of 8 rows and
# of 128 columns and at least 64 such tiles.
SCALE = {"config3_4k.still": (128, 72), "config3_4k.sparse": (512, 128),
         "config5_4k.fit_pose": (96, 64)}
SEED = 2**33 + 5  # wider than 32 bits: seeds of any size are taken


def _run(name, trace=False, fault=None, seconds=0.5):
    return run.run_cell(run.load_cell(name), SEED, seconds, trace, CPU,
                        scale=SCALE[name], fault=fault)


@pytest.mark.parametrize("name", ["config3_4k.still", "config3_4k.sparse"])
def test_frames_run_and_agree(name):
    """On the CPU the program runs its plain versions, which the reference
    copies operation for operation: the frames agree exactly."""
    out = _run(name, trace=True)
    assert out["correct"] is True and out["attempted"] >= 1
    assert out["checks"]["bad_px_share"]["value"] == 0.0
    assert any(m.startswith("device.idle_pct.") for m in out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_fit_runs():
    out = _run("config5_4k.fit_pose", seconds=0.1)
    assert out["attempted"] >= 1
    assert {"step_ms", "peak_mem_gb", "setup_s"} <= set(out["metrics"])
    assert out["checks"]["grad_gap"]["value"] < 1e-4


@pytest.mark.parametrize("name,fault", [
    ("config3_4k.still", "half"), ("config3_4k.still", "answer"),
    ("config3_4k.sparse", "half"), ("config3_4k.sparse", "answer"),
    ("config5_4k.fit_pose", "unchanged"), ("config5_4k.fit_pose", "half"),
    ("config5_4k.fit_pose", "answer")])
def test_fault_fails_the_check(name, fault):
    out = _run(name, fault=fault, seconds=0.1)
    assert out["correct"] is False, out["checks"]


class _NanGrad(torch.autograd.Function):
    """The loss unchanged, its gradient non-finite everywhere."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, float("nan"))


@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("unchanged", False)])
def test_fit_that_cannot_move_still_sees_a_skipped_update(
        monkeypatch, fault, correct):
    """Where every gradient entry is non-finite on both sides, the chain
    zeroes them all and a sound fit never moves: the check still passes it,
    and still fails a step that returns its state unchanged."""
    from schwarzschild_tpu_torch import inverse

    from portbench.reference import render as R

    make_loss, loss_and_grad = inverse.make_loss, R.loss_and_grad

    def nan_loss(*a, **k):
        loss_fn = make_loss(*a, **k)
        return lambda *p: _NanGrad.apply(loss_fn(*p))

    def nan_ref(*a, **k):
        loss, grads = loss_and_grad(*a, **k)
        return loss, {n: torch.full_like(g, float("nan"))
                      for n, g in grads.items()}

    monkeypatch.setattr(inverse, "make_loss", nan_loss)
    monkeypatch.setattr(R, "loss_and_grad", nan_ref)
    out = _run("config5_4k.fit_pose", fault=fault, seconds=0.1)
    assert out["checks"]["grad_gap"]["value"] == 0.0
    assert out["checks"]["change_gap"]["value"] == 0.0
    assert out["correct"] is correct, out["checks"]


def test_fit_fault_after_the_first_steps_fails_the_check(monkeypatch):
    """A step that goes wrong only once the compared first steps are done
    (a cache, or a reuse keyed on the step count) is caught by the window's
    recorded step."""
    from schwarzschild_tpu_torch import inverse

    make_train_step = inverse.make_train_step
    compare = run.load_cell("config5_4k.fit_pose").traffic["compare_steps"]

    def late_fault(loss_fn, opt):
        step, calls = make_train_step(loss_fn, opt), [0]

        def late(p, s, *aux):
            calls[0] += 1
            if calls[0] <= compare:
                return step(p, s, *aux)
            return p, s, loss_fn(p, *aux).detach()
        return late

    monkeypatch.setattr(inverse, "make_train_step", late_fault)
    out = _run("config5_4k.fit_pose", seconds=0.1)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["count_gap"]["value"] >= 1


@pytest.mark.parametrize("name", ["config3_4k.still", "config5_4k.fit_pose"])
def test_control_fails_the_check(name):
    """The control (bfloat16 textures for frames, the reference in
    bfloat16 for the fit) breaks a limit."""
    cell = run.load_cell(name)
    got = control.readings(cell, SEED, CPU, "control", 0.2,
                           scale=SCALE[name])
    limits = cell.traffic["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got
