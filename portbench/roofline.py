"""Shares of the card's peaks, for the per-layer metric readers:
``ctx["work"]`` lists, for each frame or step of the traced window, the
executed steps and marched rays the benchmark counted at its inputs."""

from __future__ import annotations

from . import trace, work


def _share(ctx, pick, bound_of):
    t, units = ctx.get("trace"), ctx.get("work")
    if not t or not units:
        return None
    device_s = trace.kernel_seconds(t, pick)
    if device_s <= 0.0:
        return None
    return 100.0 * sum(bound_of(w) for w in units) / device_s


def march(ctx):
    return _share(ctx, trace.is_march, lambda w: work.march_bound_s(
        w["steps"], w["rays"], w["n_slots"], w["events"]))


def bwd(ctx):
    return _share(ctx, trace.is_march_bwd, lambda w: work.bwd_bound_s(
        w["steps"], w["rays"], w["n_slots"]) if w["events"] else 0.0)
