"""Training cells: the iterations of the program's offline 3DGS training.

Set-up makes the sequence, ingests its frames as ``offline_splatting``
does (frame 0 back-projected by ``initialize_first_timestep``, every later
frame's pose written and ``add_new_gaussians`` run at it, ground-truth
poses), and runs ``setup_iters`` iterations. The window then runs the
iterations of ``offline_splatting``'s loop, through the functions that loop
calls (``gs_step``, the max-radius update, ``accumulate_mean2d_gradient``,
``densify`` on the configuration's schedule, the means' learning-rate
schedule), on frames drawn from the seed, until the first iteration
boundary at or after ``--seconds``; with ``--trace 1`` the profiler covers
``trace_iters`` more. The program's ``offline_splatting`` runs all its
iterations in one call, so the harness runs the loop's body itself.

The check follows the first three iterations (set-up) from the ingested
map, and checks the first map and the first densification (frame 1's) by
themselves.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import time

import numpy as np
import torch

from benchmark.core import work
from benchmark.core.compare import loss_gap, moving_leaves, norm_gap
from benchmark.core.scene import Sequence
from benchmark.core.trace import Profiler, summarize
from benchmark.runners.slam_check import cast, densify_gap, init_gap
from benchmark.reference import render as R
from benchmark.reference import slam as RS

STEPS = 3
B1 = 0.9
GAUSS = RS.GAUSS


def _clone(d):
    return {k: d[k].detach().clone() for k in GAUSS}


def lr_at(step, lr_init, lr_final, delay_mult, max_steps):
    """The means' learning rate at ``step``: log-linear from lr_init to
    lr_final over max_steps (Plenoxels' schedule, no delay steps)."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = np.clip(step / max_steps, 0, 1)
    return float(np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t))


class Trainer:
    """The program's training state and one iteration of its loop."""

    def __init__(self, cfg, seq, dev, seed, fault=None):
        from splatam_torch.core.optim import init_adam
        from splatam_torch.core.params import set_pose
        from splatam_torch.core.transforms import matrix_to_quaternion
        from splatam_torch.render.binning import RasterConfig
        from splatam_torch.slam.densify import add_new_gaussians
        from splatam_torch.slam.initialize import initialize_first_timestep
        from splatam_torch.slam.pipeline import as_frame

        self.cfg, self.dev, self.fault = cfg, dev, fault
        tr = cfg["train"]
        self.raster = RasterConfig(**cfg.get("raster", {}))
        self.rng = np.random.default_rng(seed)
        n = len(seq)
        dist = cfg.get("gaussian_distribution", "isotropic")
        color, depth, k4, pose = seq[0]
        (self.params, self.variables, k3, _, self.cam,
         self.scene_radius) = initialize_first_timestep(
            color, depth, k4, pose, n, cfg["scene_radius_depth_ratio"], dist,
            device=dev)
        self.rec = {"init": _clone(self.params)}
        self.frames = []
        for t in range(n):
            color, depth, _, pose = seq[t]
            frame_im, frame_depth = as_frame(color, depth, dev)
            self.frames.append((frame_im, frame_depth))
            rel = torch.as_tensor(np.linalg.inv(np.asarray(pose, np.float64)),
                                  dtype=torch.float32, device=dev)
            rot, tran = matrix_to_quaternion(rel[:3, :3]), rel[:3, 3]
            set_pose(self.params, t, rot, tran)
            if t > 0:
                if t == 1:  # the first densification, checked by itself
                    self.rec["before_1"] = _clone(self.params)
                    self.rec["pose_1"] = (rot.clone(), tran.clone())
                self.params, self.variables, _ = add_new_gaussians(
                    self.params, self.variables, frame_im, frame_depth, k3,
                    self.cam, self.raster, tr["sil_thres"], t, dist,
                    pose=(rot, tran))
                if t == 1:
                    self.rec["added"] = (self.params["means3D"].shape[0]
                                         - self.rec["before_1"]["means3D"].shape[0])
        self.opt = init_adam({k: self.params[k] for k in GAUSS})
        self.it = 0
        self.steps = []  # the first STEPS iterations: (frame, lrs, loss)
        self.spans = False  # record bm.* spans (traced iterations only)

    def _span(self, label):
        if self.spans:
            return torch.profiler.record_function(label)
        return contextlib.nullcontext()

    def step(self):
        """One iteration of offline_splatting's loop."""
        from splatam_torch.core.params import get_pose
        from splatam_torch.gs.offline import gs_step
        from splatam_torch.slam.inria_densify import (
            accumulate_mean2d_gradient, densify)

        tr = self.cfg["train"]
        lrs = {k: tr["lrs_mapping"][k] for k in GAUSS}
        lrs["means3D"] = lr_at(self.it + 1, tr["lrs_mapping"]["means3D"],
                               tr.get("lrs_mapping_means3D_final",
                                      tr["lrs_mapping"]["means3D"]),
                               tr.get("lr_delay_mult", 1.0),
                               tr["num_iters_mapping"])
        t = int(self.rng.integers(0, len(self.frames)))
        frame_im, frame_depth = self.frames[t]
        if self.fault == "frame_altered":  # the drawn frame's image swapped
            frame_im = self.frames[(t + 1) % len(self.frames)][0]
        if self.fault == "half_batch":
            frame_depth = frame_depth.clone()
            frame_depth[:, frame_depth.shape[1] // 2:] = 0.0
        rot, tran = get_pose(self.params, t)
        record = self.it < STEPS
        if record and self.it == 0:
            self.rec["start"] = _clone(self.params)
        keep = _clone(self.params) if self.fault == "unchanged" else None
        with self._span("bm.gs_step"):
            res = gs_step(self.params, self.opt, rot, tran, frame_im,
                          frame_depth, self.cam, self.raster, lrs,
                          loss_w_im=tr["loss_weights"]["im"],
                          loss_w_depth=tr["loss_weights"]["depth"])
        if keep is not None:
            with torch.no_grad():
                for k, v in keep.items():
                    self.params[k].copy_(v)
        if record:
            self.steps.append((t, lrs, res.losses["loss"].clone()))
            if self.it == 0:
                self.rec["mu"] = _clone(self.opt.mu)
            if self.it == STEPS - 1:
                self.rec["end"] = _clone(self.params)
        mr = self.variables["max_2D_radius"]
        self.variables["max_2D_radius"] = torch.where(
            res.seen, torch.maximum(res.radius.float(), mr), mr)
        if tr.get("use_gaussian_splatting_densification", False):
            with self._span("bm.densify"):
                self.variables = accumulate_mean2d_gradient(
                    self.variables, res.means2d_grad_norm, res.seen)
                self.params, self.variables, self.opt = densify(
                    self.params, self.variables, self.opt, self.it,
                    tr["densify_dict"], self.scene_radius, self.rng)
        self.it += 1
        return t


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        log, fault=None, shrink=None, control=False):
    """One run of a training cell (arguments as ``slam.run``'s)."""
    cfg = copy.deepcopy(cell.config["train"])
    cam = dict(cell.config["camera"])
    traffic = copy.deepcopy(cell.traffic)
    if shrink:
        shrink(cfg, cam, traffic)
    seq = Sequence(traffic["scene"], traffic["motion"], cam,
                   traffic["frames_made"], seed, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tr = Trainer(cfg, seq, dev, seed, fault)
    for _ in range(traffic["setup_iters"]):
        tr.step()
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    it0 = tr.it
    while True:
        tr.step()
        if time.perf_counter() - t0 >= seconds:
            sync()
            if time.perf_counter() - t0 >= seconds:
                break
    t1 = time.perf_counter()
    iters = tr.it - it0
    log(f"[window] {iters} iterations in {t1 - t0:.3f} s")
    ctx = {"family": "train",
           "window": {"iterations": iters, "seconds": t1 - t0}}
    if trace:
        prof = Profiler()
        prof.start()
        tr.spans = True
        traced = [tr.step() for _ in range(traffic["trace_iters"])]
        events = prof.stop()
        ctx["trace"] = summarize(events)
        ctx["work"] = count_work(tr.params, seq, cam, traced)
        log(f"[trace] {len(traced)} iterations: window "
            f"{ctx['trace'].window_s:.3f} s, busy {ctx['trace'].busy_s:.3f} s, "
            f"{ctx['trace'].device_ops} device ops")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {"e2e": {"train_ms_per_iter": 1e3 * (t1 - t0) / iters,
                      "setup_s": setup_s},
              "attempted": iters, "failed": 0, "memory_peak_bytes": int(peak),
              "ctx": ctx}
    rec, steps = tr.rec, tr.steps
    tr = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    result["detail"] = {}
    result["checks"] = check(rec, steps, seq, cam, cfg, dev,
                             detail=result["detail"])
    log(f"[check] the reference took {time.perf_counter() - t_check:.1f} s")
    if control:
        result["control"] = check(rec, steps, seq, cam, cfg, dev, control=True)
    return result


def count_work(params, seq, cam, frames):
    """Operations and least raster seconds of the traced iterations, on the
    map at their end from each drawn frame's ground-truth camera."""
    g = {k: params[k].detach() for k in GAUSS}
    n = g["means3D"].shape[0]
    w, h = cam["width"], cam["height"]
    ops = least = 0.0
    for t in frames:
        o, s = work.render_cost(work.pairs_at(g, seq.poses[t], seq.k, w, h),
                                n, w, h, backward=True)
        ops += o + n * work.GAUSSIAN_OPS
        least += s
    return {"ops": ops, "raster_least_s": least, "iterations": len(frames)}


def check(rec, steps, seq, cam, cfg, dev, control=False, detail=None) -> dict:
    """The numbers compared (``control``: the reference in bfloat16 in the
    program's place)."""
    dt = torch.bfloat16 if control else torch.float32
    f32 = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcam = R.make_cam(cam["width"], cam["height"], seq.k, np.eye(4), dev)
    iso = cfg.get("gaussian_distribution", "isotropic") == "isotropic"
    out = {"init_gap": init_gap(None if control else rec["init"], seq, dt, iso)}
    rot, tran = rec["pose_1"]
    out["densify_gap"], prog_added, ref_added = densify_gap(
        rec["before_1"], rot, tran, seq.frame(1)[1], rcam,
        cfg["train"]["sil_thres"], None if control else rec["added"], dt)

    w = cfg["train"]["loss_weights"]
    frames = [(t, lrs, *seq.frame(t), RS.pose_of(seq.poses[t], dev))
              for t, lrs, _ in steps]
    l_r, g_r, m_r = RS.train_steps(rec["start"], frames, rcam, w)
    if control:
        l_p, g_p, m_p = RS.train_steps(
            cast(rec["start"], dt),
            [(t, lrs, im.to(dt), d.to(dt), (q.to(dt), x.to(dt)))
             for t, lrs, im, d, (q, x) in frames], rcam, w)
        g_p, m_p = cast(g_p, f32), cast(m_p, f32)
    else:
        l_p = [float(x) for _, _, x in steps]
        g_p = {k: v / (1 - B1) for k, v in rec["mu"].items()}
        m_p = rec["end"]
    start = rec["start"]
    out["train_loss_gap"] = loss_gap(l_p, l_r)
    out["train_grad_gap"] = norm_gap(g_p, g_r)
    out["train_step_gap"] = norm_gap({k: m_p[k] - start[k] for k in GAUSS},
                                     {k: m_r[k] - start[k] for k in GAUSS},
                                     moving_leaves(g_r))
    if detail is not None:
        detail["losses"] = (l_p, l_r)
        detail["added"] = (prog_added, ref_added)
    return out
