"""SLAM cells: the program's ``rgbd_slam`` over the benchmark's sequence.

One call of ``splatam_torch.slam.pipeline.rgbd_slam`` runs the whole cell.
It reads ``len(sequence)`` once and ``sequence[t]`` per frame, and calls
the harness's ``frame_callback`` before each frame: that is where set-up
ends (after ``setup_frames`` frames), where the window closes (at the first
frame boundary at or after ``--seconds``) and, with ``--trace 1``, where
the profiler covers ``trace_frames`` more frames. Without ``--trace``, a
profiler session with CUDA activity alone covers each frame of the window:
the end-to-end ``device_s_per_frame`` is the card's busy time over the
window's frames (the wall time per frame is read from the untraced window
of a ``--trace 1`` run, as the per-layer ``slam_wall_s_per_frame``). The
call is left by an
exception at that boundary, and the callback's caller's locals give the
program's state there (the program has no stop of its own).

The check (see ``check``) follows the first three steps of tracking and of
mapping at ``check_frame``, a set-up frame the timed call itself runs at
full size, from the program's own state there; it checks the first map and
the densification of that frame by themselves, and every frame-to-frame
motion the run tracked against the sequence's ground truth. Wrappers around the program's
own functions record what it did: ``tracking.adam_step`` and
``tracking.slam_loss``, ``pipeline.map_step``; outside the check frame and
without tracing they only pass the call on.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import sys
import time

import torch

from benchmark.core import work
from benchmark.core.scene import Sequence
from benchmark.core.trace import DeviceMeter, Profiler, summarize
from benchmark.runners import slam_check

STEPS = 3  # the steps of each optimiser the check follows
POSE_ALTERATION = 0.01  # metres the fault "pose_altered" moves a tracked pose
# a frame's profiler session that holds fewer device ops than this share of
# the window's median frame lost records (a frame's ops vary by under 5%)
WHOLE_OPS = 0.9


class WindowClosed(Exception):
    pass


def _clone(d, keys=None):
    return {k: v.detach().clone() for k, v in d.items()
            if keys is None or k in keys}


class Hooks:
    """The frame callback and the wrappers around the program's calls."""

    GAUSS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities",
             "log_scales")

    def __init__(self, traffic, seconds, trace, t_start, dev, fault=None):
        self.setup_frames = traffic["setup_frames"]
        self.check_frame = traffic["check_frame"]
        self.trace_frames = traffic["trace_frames"]
        self.seconds, self.trace, self.t_start = seconds, trace, t_start
        self.dev, self.fault = dev, fault
        self.phase = "setup"
        self.rec = {"track": None, "map": None, "init": None}
        self.frame_times = []
        self.profiler = Profiler() if trace else None
        self.meter = DeviceMeter() if not trace and dev.type == "cuda" else None
        self.events = None
        self.spans = False  # record bm.* spans (traced frames only)

    # -- the program's functions, wrapped ---------------------------------
    def install(self):
        import splatam_torch.slam.pipeline as pipe
        import splatam_torch.slam.tracking as trk

        self._orig = {
            (trk, "adam_step"): trk.adam_step,
            (trk, "slam_loss"): trk.slam_loss,
            (pipe, "map_step"): pipe.map_step,
            (pipe, "track_frame"): pipe.track_frame,
            (pipe, "add_new_gaussians"): pipe.add_new_gaussians,
            (pipe, "keyframe_selection_overlap"): pipe.keyframe_selection_overlap,
            (pipe, "compute_binned"): pipe.compute_binned,
        }
        trk.adam_step = self._track_adam
        trk.slam_loss = self._track_loss
        pipe.map_step = self._map_step
        for name in ("track_frame", "add_new_gaussians",
                     "keyframe_selection_overlap", "compute_binned"):
            setattr(pipe, name, self._span(name, self._orig[(pipe, name)]))

    def uninstall(self):
        for (mod, name), fn in self._orig.items():
            setattr(mod, name, fn)

    def _span(self, name, fn):
        label = "bm." + name

        def wrapped(*a, **kw):
            if not self.spans:
                return fn(*a, **kw)
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped

    def _track_loss(self, *a, **kw):
        import splatam_torch.slam.tracking as trk

        out = self._orig[(trk, "slam_loss")](*a, **kw)
        r = self.rec["track"]
        if r is not None and len(r["losses"]) < STEPS:
            r["losses"].append(out.loss.detach().clone())
        return out

    def _track_adam(self, params, grads, state, lrs, **kw):
        import splatam_torch.slam.tracking as trk

        real = self._orig[(trk, "adam_step")]
        r = self.rec["track"]
        if r is None or r["steps"] >= STEPS:
            if self.fault == "track_unchanged":
                return None
            return real(params, grads, state, lrs, **kw)
        if r["steps"] == 0:
            r["start"] = _clone(params)
        if self.fault != "track_unchanged":
            real(params, grads, state, lrs, **kw)
        r["steps"] += 1
        if r["steps"] == 1:
            r["mu"] = _clone(state.mu)
        if r["steps"] == STEPS:
            r["end"] = _clone(params)
        return None

    def _map_step(self, params, opt_state, cam_rot, cam_tran, frame_im,
                  frame_depth, *a, **kw):
        import splatam_torch.slam.pipeline as pipe

        real = self._orig[(pipe, "map_step")]
        if self.fault == "map_half_batch":
            frame_depth = frame_depth.clone()
            frame_depth[:, frame_depth.shape[1] // 2:] = 0.0
        if self.rec["init"] is None:  # the first map, before any step
            self.rec["init"] = _clone(params, self.GAUSS)
        r = self.rec["map"]
        if r is None or r["steps"] >= STEPS:
            if self.fault == "map_unchanged":
                return self._unchanged(real, params, opt_state, cam_rot,
                                       cam_tran, frame_im, frame_depth, a, kw)
            with self._maybe_span("bm.map_step"):
                return real(params, opt_state, cam_rot, cam_tran, frame_im,
                            frame_depth, *a, **kw)
        if r["steps"] == 0:
            r["start"] = _clone(params, self.GAUSS)
        elif r["steps"] == 1:
            r["rows_at_2"] = params["means3D"].shape[0]
        r["frames"].append((cam_rot.detach().clone(), cam_tran.detach().clone(),
                            frame_im))
        if self.fault == "map_unchanged":
            res = self._unchanged(real, params, opt_state, cam_rot, cam_tran,
                                  frame_im, frame_depth, a, kw)
        else:
            res = real(params, opt_state, cam_rot, cam_tran, frame_im,
                       frame_depth, *a, **kw)
        r["losses"].append(res.losses["loss"].clone())
        r["steps"] += 1
        if r["steps"] == 1:
            r["mu"] = _clone(opt_state.mu)
            r["after_1"] = _clone(params, self.GAUSS)
        if r["steps"] == STEPS:
            r["end"] = _clone(params, self.GAUSS)
        return res

    def _unchanged(self, real, params, opt_state, cam_rot, cam_tran, frame_im,
                   frame_depth, a, kw):
        """A planted fault: the step runs and leaves the map as it was."""
        keep = _clone(params, self.GAUSS)
        res = real(params, opt_state, cam_rot, cam_tran, frame_im,
                   frame_depth, *a, **kw)
        with torch.no_grad():
            for k, v in keep.items():
                params[k].copy_(v)
        return res

    def _maybe_span(self, label):
        if self.spans:
            return torch.profiler.record_function(label)
        return contextlib.nullcontext()

    # -- the frame callback -------------------------------------------------
    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def on_frame(self, t, state):
        loc = sys._getframe(1).f_locals
        self.state = state
        if t == self.check_frame:
            p = loc["params"]
            self.rec["map_before"] = _clone(p, self.GAUSS)
            self.rec["poses_before"] = (p["cam_unnorm_rots"][0, :, :t].T.clone(),
                                        p["cam_trans"][0, :, :t].T.clone())
            self.rec["track"] = {"losses": [], "steps": 0}
            self.rec["map"] = {"losses": [], "steps": 0, "frames": []}
        if self.fault == "pose_altered" and t == self.check_frame + 1:
            with torch.no_grad():
                loc["params"]["cam_trans"][0, 0, self.check_frame] += POSE_ALTERATION
        if t < self.setup_frames:
            if self.meter is not None and t == 1:
                # the profiler's start-up, in set-up: one session around
                # one small op, its reading dropped
                self._sync()
                self.meter.start()
                torch.ones(1, device=self.dev).add_(1)
                self._sync()
                self.meter.stop()
                self.meter.drop()
            return
        self._sync()
        now = time.perf_counter()
        if self.phase == "setup":
            self.phase = "window"
            self.t0 = now
            self.setup_s = now - self.t_start
            self.counts0 = dict(state.counts)
            self.nonfinite0 = self._nonfinite(loc)
            self.first = t
            if self.meter is not None:
                self.meter.start()
            return
        if self.phase == "window":
            self.frame_times.append(now)
            if self.meter is not None:
                self.meter.stop()
        if self.phase == "window" and now - self.t0 >= self.seconds:
            self.t1 = now
            self.last = t  # the window ran frames [first, last)
            self.counts1 = dict(state.counts)
            self.nonfinite1 = self._nonfinite(loc)
            if not self.trace:
                self._close(t, loc)
            self.phase = "trace"
            self.trace_first = t
            self.spans = True
            self.profiler.start()
            return
        if self.meter is not None:
            self.meter.start()  # the next frame of the window
        if self.phase == "trace" and t == self.trace_first + self.trace_frames:
            self.events = self.profiler.stop()
            self.spans = False
            self._close(t, loc)

    @staticmethod
    def _nonfinite(loc):
        return int(loc["nonfinite_track"]) + int(loc["nonfinite_map"])

    def _close(self, t, loc):
        self.end_frame = t
        self.params = loc["params"]
        raise WindowClosed


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        log, fault=None, shrink=None, control=False):
    """One run of a SLAM cell. ``fault`` plants a fault in the program
    (``Hooks``), ``control`` also computes the precision control's numbers
    (both for ``benchmark/calibrate.py`` and the tests), and ``shrink``
    (tests only) overrides configuration keys, the camera and the traffic
    for a tiny run."""
    from splatam_torch.slam.pipeline import rgbd_slam

    cfg = copy.deepcopy(cell.config["slam"])
    cam = dict(cell.config["camera"])
    traffic = copy.deepcopy(cell.traffic)
    if shrink:
        shrink(cfg, cam, traffic)
    cfg["seed"] = seed
    seq = Sequence(traffic["scene"], traffic["motion"], cam,
                   traffic["frames_made"], seed, dev)
    hooks = Hooks(traffic, seconds, trace, t_start, dev, fault)
    hooks.install()
    try:
        rgbd_slam(cfg, seq, progress=False, frame_callback=hooks.on_frame,
                  device=dev)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the sequence ran out before the window closed")
    finally:
        hooks.uninstall()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    frames = hooks.last - hooks.first
    ends = [hooks.t0] + hooks.frame_times
    log("[window] frame seconds " + " ".join(
        f"{b - a:.3f}" for a, b in zip(ends, ends[1:])))
    window_s = hooks.t1 - hooks.t0
    tr = hooks.counts1["tracking_iters"] - hooks.counts0["tracking_iters"]
    mp = hooks.counts1["mapping_iters"] - hooks.counts0["mapping_iters"]
    timing = hooks.state.timing
    f0, f1 = hooks.first, hooks.last
    ctx = {
        "family": "slam",
        "window": {"frames": frames, "seconds": window_s,
                   "tracking_iters": tr, "mapping_iters": mp},
        # per-frame seconds per iteration: tracking's entries start at
        # frame 1, mapping's at frame 0 (map_every 1)
        "tracking_iter": timing["tracking_iter"][f0 - 1:f1 - 1],
        "mapping_iter": timing["mapping_iter"][f0:f1],
    }
    e2e = {"setup_s": hooks.setup_s}
    if hooks.meter is not None:
        e2e["device_s_per_frame"] = device_s_per_frame(hooks.meter.read(),
                                                       frames, log)
    log(f"[window] {frames} frames in {window_s:.3f} s: "
        f"{window_s / frames:.4f} s/frame")
    result = {
        "e2e": e2e,
        "attempted": tr + mp,
        "failed": hooks.nonfinite1 - hooks.nonfinite0,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        summary = summarize(hooks.events)
        traced = list(range(hooks.trace_first, hooks.end_frame))
        ctx["trace"] = summary
        ctx["work"] = count_work(hooks.params, seq, cam, cfg, traced)
        log(f"[trace] frames {traced}: window {summary.window_s:.3f} s, "
            f"busy {summary.busy_s:.3f} s, {summary.device_ops} device ops")
    result["ctx"] = ctx
    # the program's trajectory, then its state goes before the reference
    traj = slam_check.trajectory(hooks.params, hooks.end_frame)
    hooks.params = hooks.state = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    result["detail"] = {}
    result["checks"] = slam_check.check(hooks.rec, traj, seq, cam, cfg,
                                        hooks.check_frame, dev,
                                        detail=result["detail"])
    log(f"[check] the reference took {time.perf_counter() - t_check:.1f} s")
    if control:
        result["control"] = slam_check.check(hooks.rec, traj, seq, cam, cfg,
                                             hooks.check_frame, dev,
                                             control=True)
    return result


def device_s_per_frame(busy, frames, log):
    """The card's busy seconds per frame over the window's frames, from
    ``DeviceMeter.read()``. A frame whose session lost device records (the
    profiler now and then drops some of its buffers: 4 sessions in 310 on
    the card) is not counted as a shorter frame: it takes the mean of the
    nearest whole frames before and after it (a frame's busy time grows
    with the map, by some 1% a frame), and is named."""
    if len(busy) != frames:
        raise RuntimeError(f"{len(busy)} profiler sessions for {frames} frames")
    log("[window] device seconds " + " ".join(f"{b:.4f}" for b, _ in busy))
    log("[window] device ops " + " ".join(str(n) for _, n in busy))
    median = sorted(n for _, n in busy)[frames // 2]
    whole = [n >= WHOLE_OPS * median for _, n in busy]
    seconds = []
    for i, (b, n) in enumerate(busy):
        if not whole[i]:
            near = [next((busy[j][0] for j in js if whole[j]), None)
                    for js in (range(i - 1, -1, -1), range(i + 1, frames))]
            near = [x for x in near if x is not None]
            b = sum(near) / len(near)
            log(f"[window] frame {i} of the window: its session lost device "
                f"records ({n} ops, under {WHOLE_OPS:.0%} of the median "
                f"frame's {median}); it counts {b:.4f} s")
        seconds.append(b)
    return sum(seconds) / frames


def count_work(params, seq, cam, cfg, frames):
    """Operations and least raster seconds of the traced frames, counted on
    the map at their end from each frame's ground-truth camera: tracking
    and mapping iterations render with a backward, the densification render
    without."""
    g = {k: params[k].detach() for k in Hooks.GAUSS}
    n = g["means3D"].shape[0]
    w, h = cam["width"], cam["height"]
    ops = least = 0.0
    iters = cfg["tracking"]["num_iters"] + cfg["mapping"]["num_iters"]
    for t in frames:
        pairs = work.pairs_at(g, seq.poses[t], seq.k, w, h)
        o, s = work.render_cost(pairs, n, w, h, backward=True)
        fo, fs = work.render_cost(pairs, n, w, h, backward=False)
        ops += iters * o + fo + iters * n * work.GAUSSIAN_OPS
        least += iters * s + fs
    return {"ops": ops, "raster_least_s": least, "iterations": iters * len(frames)}
