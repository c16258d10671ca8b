"""The measured window and the helpers every traffic kind shares: units
(frames or steps) back to back until ``seconds`` have passed, each unit's
end read on the host's clock after the device finished it."""

from __future__ import annotations

import contextlib
import time

import torch


# The host clock at the end of each part of a run, by name (``mark``):
# what moves setup_s from run to run, and the check's time, printed to
# standard error.
PHASES = {}


def mark(name: str):
    PHASES[name] = time.perf_counter()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name, on):
    """The benchmark's own profiler span around one unit, when traced."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Window:
    def __init__(self, seconds: float):
        self.seconds = seconds
        self.times = []
        self.start = self.end = None

    def run(self, unit):
        self.start = prev = time.perf_counter()
        k = 0
        while True:
            unit(k)
            now = time.perf_counter()
            self.times.append(now - prev)
            prev = now
            k += 1
            if now - self.start >= self.seconds:
                break
        self.end = prev

    @property
    def count(self) -> int:
        return len(self.times)

    @property
    def elapsed(self) -> float:
        return self.end - self.start


def reservoir_pick(rng, k: int, keep: int):
    """Where unit ``k`` goes in a seeded reservoir of ``keep`` units (a
    uniform sample of the window's units), or None."""
    if k < keep:
        return k
    j = int(rng.integers(0, k + 1))
    return j if j < keep else None
