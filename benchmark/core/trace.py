"""The device trace of a traced run and what the metrics read from it.

``Profiler`` wraps ``torch.profiler`` (CPU and CUDA activity) around the
traced frames, inside a ``bm.window`` span, and hands its events over as
plain tuples. ``summarize`` reduces a list of such events: the union of the
device's busy intervals inside the window (overlapping kernels counted
once), the device operations and their times by name, and the idle gaps
labelled by what the host was doing then (the innermost harness span,
``bm.*``, and the innermost host operation under it). It is plain Python
over the tuples, so a recorded trace can be replayed in a test.

``DeviceMeter`` takes the card's busy time over a whole measured window
(the end-to-end ``device_s_per_frame``): CUDA activity alone, no host
operations recorded, one profiler session per frame, read once the window
has closed.
"""
from __future__ import annotations

import bisect
from typing import NamedTuple

WINDOW = "bm.window"


class Event(NamedTuple):
    name: str
    device: bool  # ran on the card (a kernel, a copy, a set)
    start_ns: int
    dur_ns: int
    tid: int  # host thread (device events: 0)


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: int
    op_seconds: dict  # device op name -> seconds
    idle_gaps: list  # [(label, seconds)], longest first


class Profiler:
    """``torch.profiler`` over a stretch of the run."""

    def __init__(self):
        self._prof = self._span = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> list[Event]:
        import torch

        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        out = []
        for e in self._prof.profiler.kineto_results.events():
            dev = e.device_type() != DeviceType.CPU
            if dev and e.name().startswith("bm."):
                continue  # the device's copy of a harness span
            out.append(Event(e.name(), dev, int(e.start_ns()),
                             int(e.duration_ns()),
                             0 if dev else int(e.start_thread_id())))
        self._prof = None
        return out


class DeviceMeter:
    """The card's busy seconds over consecutive stretches of a run, each in
    a ``torch.profiler`` session of its own with CUDA activity alone (a
    SLAM frame is some 125,000 device ops, so a session per frame keeps
    each session's activity buffers small). The caller synchronizes the
    card before ``start`` and ``stop``; ``read`` reduces the sessions once
    the window has closed. Recording and stopping cost the host some 4 s a
    frame, which the busy time does not see."""

    def __init__(self):
        self._prof = None
        self._results = []

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)
        self._results.append(self._prof.profiler.kineto_results)
        self._prof = None

    def drop(self):
        self._results = []

    def read(self) -> list[tuple[float, int]]:
        """(busy seconds, device ops) of each stretch, in order: the union
        of its device operations' intervals (kernels, copies, sets)."""
        from torch.autograd import DeviceType

        out = []
        for res in self._results:
            spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in res.events()
                     if e.device_type() != DeviceType.CPU
                     and not e.name().startswith("bm.")]
            out.append((busy_seconds(spans), len(spans)))
        self._results = []
        return out


def busy_seconds(spans) -> float:
    """Seconds covered by (start_ns, end_ns) intervals, overlaps once."""
    return sum(e - s for s, e in _union(spans)) * 1e-9


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _innermost(events):
    """Segments (start, end, stack of names) of one thread's properly
    nested events: for any time, the events covering it, outermost first."""
    segs, stack = [], []
    t = None
    for e in sorted(events, key=lambda e: (e.start_ns, -e.dur_ns)):
        end = e.start_ns + e.dur_ns
        while stack and stack[-1][1] <= e.start_ns:
            top = stack.pop()
            if t is not None and top[1] > t:
                segs.append((t, top[1], [s[0] for s in stack + [top]]))
            t = top[1]
        if t is not None and e.start_ns > t and stack:
            segs.append((t, e.start_ns, [s[0] for s in stack]))
        stack.append((e.name, end))
        t = e.start_ns
    while stack:
        top = stack.pop()
        if top[1] > t:
            segs.append((t, top[1], [s[0] for s in stack + [top]]))
        t = top[1]
    return segs


def _label(names):
    spans = [n for n in names if n.startswith("bm.") and n != WINDOW]
    ops = [n for n in names if not n.startswith("bm.")]
    span = spans[-1] if spans else "harness"
    return f"{span} / {ops[-1]}" if ops else span


def summarize(events: list[Event], top: int = 10) -> Summary:
    win = [e for e in events if e.name == WINDOW and not e.device]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} span")
    w = win[0]
    w0, w1 = w.start_ns, w.start_ns + w.dur_ns
    dev = [e for e in events if e.device and e.start_ns < w1
           and e.start_ns + e.dur_ns > w0]
    busy = _union((max(e.start_ns, w0), min(e.start_ns + e.dur_ns, w1))
                  for e in dev)
    busy_ns = sum(e - s for s, e in busy)
    ops = {}
    for e in dev:
        ops[e.name] = ops.get(e.name, 0.0) + e.dur_ns * 1e-9
    host = [e for e in events if not e.device and e.tid == w.tid
            and e.start_ns >= w0 and e.start_ns < w1]
    segs = _innermost(host)
    starts = [s[0] for s in segs]
    gaps, prev = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            i = bisect.bisect_right(starts, prev) - 1
            names = segs[i][2] if i >= 0 and segs[i][1] > prev else []
            lab = _label(names)
            gaps[lab] = gaps.get(lab, 0.0) + (s - prev) * 1e-9
        prev = max(prev, e)
    return Summary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, device_ops=len(dev),
        op_seconds=ops,
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top])


def top_ops(summary: Summary, top: int = 10):
    return sorted(summary.op_seconds.items(), key=lambda kv: -kv[1])[:top]


def kernel_seconds(summary: Summary, names) -> float:
    """Device seconds of the ops whose name contains one of ``names``."""
    return sum(s for op, s in summary.op_seconds.items()
               if any(n in op for n in names))
