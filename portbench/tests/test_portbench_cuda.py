"""The harness on the card, at the cells' own sizes: every cell runs with
a short window and its check passes; the frames' control fails it.  Skips
without a card (decided inside each test):

    python -m pytest portbench/tests/test_portbench_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from portbench import control, run

CELLS = ["config3_4k.still", "config5_4k.fit_pose", "config3_4k.sparse"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    dev = _card()
    out = run.run_cell(run.load_cell(name), 2**33 + 11, 2.0, False, dev)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_frames_control_fails_on_the_card():
    dev = _card()
    cell = run.load_cell("config3_4k.still")
    got = control.readings(cell, 2**33 + 13, dev, "control", 1.0)
    limits = cell.traffic["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got
