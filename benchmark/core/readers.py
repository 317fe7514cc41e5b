"""Arithmetic shared by the per-layer metric readers in ``metrics/``.

Each reader takes the run's context (``ctx``, a dict a runner fills:
``family``, ``window``, per-frame timings, with ``--trace 1`` the trace's
``Summary`` under ``trace`` and the counted work under ``work``) and
returns a number, or None where it finds nothing to read.
"""
from __future__ import annotations

from benchmark.core import work
from benchmark.core.manifest import kernel_names
from benchmark.core.trace import kernel_seconds


def mean_ms(values):
    """Milliseconds from a list of seconds per iteration, one per frame (the
    frames run the same iterations, so the plain mean is the mean weighted
    by iterations)."""
    return 1e3 * sum(values) / len(values) if values else None


def wall_s_per_frame(ctx, family):
    """The window's wall seconds over its whole frames."""
    w = ctx.get("window")
    if ctx.get("family") != family or not w or not w.get("frames"):
        return None
    return w["seconds"] / w["frames"]


def traced(ctx, family):
    if ctx.get("family") != family or ctx.get("trace") is None:
        return None
    return ctx["trace"], ctx["work"]


def ops_per_iter(ctx, family):
    t = traced(ctx, family)
    return None if t is None else t[0].device_ops / t[1]["iterations"]


def idle_pct(ctx, family):
    t = traced(ctx, family)
    return None if t is None else 100.0 * (1.0 - t[0].busy_s / t[0].window_s)


def roofline_pct(ctx, family, group):
    t = traced(ctx, family)
    if t is None:
        return None
    seconds = kernel_seconds(t[0], kernel_names(group))
    return None if seconds <= 0 else 100.0 * t[1]["raster_least_s"] / seconds


def mfu_pct(ctx, family):
    t = traced(ctx, family)
    if t is None:
        return None
    return 100.0 * t[1]["ops"] / (t[0].window_s * work.F32_PEAK_FLOPS)
