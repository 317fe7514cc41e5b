"""The SLAM cells' check: the numbers compared, from what the run recorded.

The reference (``benchmark.reference.slam``) follows the program step by
step from the program's own state at the check frame (the map before it,
the poses before it, the map mapping starts from, the poses of the
keyframes mapping samples); it takes its frames from the sequence itself.
The start (the first map) and the stage the step-by-step check skips (the
frame's densification) are checked by themselves, and every frame-to-frame
motion the run tracked is held to the sequence's ground truth.

``check(..., control=True)`` puts the reference, computed in bfloat16, in
the program's place: the precision control.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.core.compare import loss_gap, moving_leaves, norm_gap
from benchmark.reference import render as R
from benchmark.reference import slam as RS

B1 = 0.9  # Adam's first-moment decay: the first gradient is mu / (1 - B1)


def trajectory(params, end):
    """The program's tracked poses of frames [0, end), (rot (end, 4),
    tran (end, 3)) on the host in float64."""
    rots = params["cam_unnorm_rots"][0, :, :end].T.detach().double().cpu()
    trans = params["cam_trans"][0, :, :end].T.detach().double().cpu()
    return rots, trans


def _c2w(rots, trans):
    """Camera-to-world matrices of world-to-camera poses, (T, 4, 4)."""
    r = R.rotmat(rots)
    m = torch.zeros((rots.shape[0], 4, 4), dtype=rots.dtype)
    m[:, :3, :3] = r.transpose(1, 2)
    m[:, :3, 3] = -(r.transpose(1, 2) @ trans[:, :, None])[..., 0]
    m[:, 3, 3] = 1
    return m


def rpe(traj, poses) -> float:
    """The largest relative pose error (m) between consecutive tracked
    frames: the distance between the tracked and the true motion of the
    camera centre from one frame to the next. Drift does not add up in it,
    so it does not grow with the frames a window holds."""
    est = _c2w(*traj)
    gt = torch.as_tensor(np.asarray(poses)[: est.shape[0]])
    step_e = torch.linalg.inv(est[:-1]) @ est[1:]
    step_g = torch.linalg.inv(gt[:-1]) @ gt[1:]
    return float((step_e[:, :3, 3] - step_g[:, :3, 3]).norm(dim=-1).max())


def _frame_id(seq, im, upto):
    for i in range(upto + 1):
        if torch.equal(seq.frame(i)[0].to(im.device), im):
            return i
    raise RuntimeError("a keyframe mapping sampled is not a frame of the sequence")


def cast(d, dt):
    return {k: v.to(dt) for k, v in d.items()}


def init_gap(prog0, seq, dt, isotropic=True) -> float:
    """The largest gap of any value between the program's first map
    (``prog0``; None for the control, which back-projects in ``dt``) and
    the reference's back-projection of frame 0."""
    im0, d0 = seq.frame(0)
    ref0 = RS.new_gaussians(*RS.backproject(im0, d0, seq.k, np.eye(4)),
                            isotropic)
    if prog0 is None:
        prog0 = cast(RS.new_gaussians(*RS.backproject(
            im0.to(dt), d0.to(dt), seq.k, np.eye(4)), isotropic), torch.float32)
    return max(float((prog0[k] - ref0[k]).abs().max())
               if prog0[k].shape == ref0[k].shape else float("inf")
               for k in RS.GAUSS)


def densify_gap(before, rot, tran, depth, rcam, sil, prog_added, dt):
    """The Gaussians a densification adds to ``before`` at the pose (rot,
    tran), the program's count (``prog_added``; None for the control, which
    counts in ``dt``) against the reference's, relative to the latter.
    Returns (gap, program's count, reference's count)."""
    ref = int(RS.densify_mask(before, rot, tran, depth, rcam, sil).sum())
    if prog_added is None:
        prog_added = int(RS.densify_mask(cast(before, dt), rot.to(dt),
                                         tran.to(dt), depth.to(dt), rcam,
                                         sil).sum())
    return abs(prog_added - ref) / max(ref, 1), prog_added, ref


def check(rec, traj, seq, cam, cfg, c, dev, control=False, detail=None) -> dict:
    """The numbers compared. ``rec`` is what the run recorded, ``traj`` the
    program's trajectory, ``c`` the check frame; ``detail`` (a dict) also
    gets the readings the numbers come from."""
    dt = torch.bfloat16 if control else torch.float32
    f32 = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcam = R.make_cam(cam["width"], cam["height"], seq.k, np.eye(4), dev)
    out = {}
    _, d0 = seq.frame(0)
    scene_radius = float(d0.max()) / cfg["scene_radius_depth_ratio"]
    out["init_gap"] = init_gap(None if control else rec["init"], seq, dt)

    # densification at frame c, at the pose the program tracked
    im_c, d_c = seq.frame(c)
    before = rec["map_before"]
    added = None if control else (rec["map"]["start"]["means3D"].shape[0]
                                  - before["means3D"].shape[0])
    out["densify_gap"], prog_added, ref_added = densify_gap(
        before, traj[0][c].to(dev, f32), traj[1][c].to(dev, f32), d_c, rcam,
        cfg["mapping"]["sil_thres"], added, dt)

    # tracking's first steps at frame c
    rots, trans = rec["poses_before"]
    ct = cfg["tracking"]
    rot0, tran0 = RS.forward_pose(rots[c - 2:c], trans[c - 2:c])
    steps = len(rec["track"]["losses"])
    l_r, g_r, p_r = RS.track_steps(before, rot0, tran0, im_c, d_c, rcam, ct,
                                   steps)
    if control:
        l_p, g_p, p_p = RS.track_steps(cast(before, dt), rot0.to(dt),
                                       tran0.to(dt), im_c.to(dt), d_c.to(dt),
                                       rcam, ct, steps)
        g_p, start_p, p_p = cast(g_p, f32), {"rot": rot0, "tran": tran0}, \
            cast(p_p, f32)
    else:
        tr = rec["track"]
        l_p = [float(x) for x in tr["losses"]]
        g_p = {k: v / (1 - B1) for k, v in tr["mu"].items()}
        start_p, p_p = tr["start"], tr["end"]
    out["track_loss_gap"] = loss_gap(l_p, l_r)
    if detail is not None:
        detail["track_losses"] = (l_p, l_r)
    out["track_grad_gap"] = norm_gap(g_p, g_r)
    out["track_step_gap"] = norm_gap(
        {k: p_p[k] - start_p[k] for k in p_p},
        {"rot": p_r["rot"] - rot0, "tran": p_r["tran"] - tran0},
        moving_leaves(g_r))

    # mapping's first steps at frame c
    mr = rec["map"]
    start = mr["start"]
    ids = [_frame_id(seq, im, c) for _, _, im in mr["frames"]]
    frames = [(rot, tran, *seq.frame(i), i)
              for (rot, tran, _), i in zip(mr["frames"], ids)]
    cm = cfg["mapping"]
    l_r, g_r, m_r, kept_r = RS.map_steps(start, frames, rcam, cm, scene_radius)
    n = start["means3D"].shape[0]
    if control:
        l_p, g_p, m_p, kept_p = RS.map_steps(
            cast(start, dt), [(*(x.to(dt) for x in f[:4]), f[4]) for f in frames],
            rcam, cm, scene_radius)
        g_p, m_p = cast(g_p, f32), cast(m_p, f32)
    else:
        l_p = [float(x) for x in mr["losses"]]
        g_p = {k: v / (1 - B1) for k, v in mr["mu"].items()}
        m_p = mr["end"]
        kept_p = torch.arange(n, device=dev)
        if mr["rows_at_2"] != n:  # the program pruned after step 1
            keep = RS.prune_rows(mr["after_1"], 0, cm["pruning_dict"],
                                 scene_radius)
            kept_p = kept_p[keep] if keep is not None else kept_p
            if kept_p.shape[0] != mr["rows_at_2"]:
                kept_p = None  # it pruned other rows than its rule names
    out["map_loss_gap"] = loss_gap(l_p, l_r)
    if detail is not None:
        detail["map_losses"] = (l_p, l_r)
        detail["map_rows"] = (n, int(m_p["means3D"].shape[0]),
                              int(m_r["means3D"].shape[0]))
        detail["added"] = (prog_added, ref_added)
    out["map_grad_gap"] = norm_gap(g_p, g_r)
    if kept_p is None or m_p["means3D"].shape[0] != kept_p.shape[0]:
        out["map_step_gap"] = float("inf")
    else:
        both_p = torch.isin(kept_p, kept_r)
        both_r = torch.isin(kept_r, kept_p)
        out["map_step_gap"] = norm_gap(
            {k: (m_p[k] - start[k][kept_p])[both_p] for k in RS.GAUSS},
            {k: (m_r[k] - start[k][kept_r])[both_r] for k in RS.GAUSS},
            moving_leaves(g_r))

    # every tracked frame-to-frame motion against the ground truth
    if not control:
        out["rpe_m"] = rpe(traj, seq.poses)
    return out
