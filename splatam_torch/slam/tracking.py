"""Per-frame camera tracking: pose-only Adam keeping the best candidate.

Counterpart of ``splatam_tpu/slam/tracking.py`` (`scripts/splatam.py:696-764`):
constant-velocity pose init, N Adam iterations on (cam_unnorm_rot, cam_trans)
against the silhouette-masked sum-L1 loss, keeping the post-step pose of the
iteration with the lowest pre-step loss; a call can resume another's Adam
run (the depth-loss-threshold doubling). The loop runs eagerly; the
candidate bookkeeping and the non-finite-loss guard stay on the device, so
no iteration waits on the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from splatam_torch.core.losses import compute_binned, slam_loss
from splatam_torch.core.optim import AdamState, adam_step, init_adam
from splatam_torch.core.transforms import normalize
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import Camera


class TrackResult(NamedTuple):
    best_rot: torch.Tensor  # (4,)
    best_tran: torch.Tensor  # (3,)
    best_loss: torch.Tensor  # ()
    nonfinite: torch.Tensor  # () iterations whose update was skipped
    last_losses: Dict[str, torch.Tensor]  # the last iteration's losses
    final_rot: torch.Tensor  # (4,) post-step pose of the last iteration
    final_tran: torch.Tensor  # (3,)
    opt: AdamState  # pass back through ``resume`` to continue
    sat_depth: torch.Tensor | None  # the last render's, for the next binning

    @property
    def resume_state(self):
        """Carry for continuing this optimization: the depth-loss-threshold
        doubling continues the SAME Adam run (`scripts/splatam.py:745-758`)."""
        return (
            {"rot": self.final_rot, "tran": self.final_tran},
            self.opt, self.best_rot, self.best_tran, self.best_loss,
            self.sat_depth,
        )


def initialize_camera_pose(
    params: Dict[str, torch.Tensor], time_idx: int, forward_prop: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constant-velocity initialization (`scripts/splatam.py:429-448`)."""
    rots, trans = params["cam_unnorm_rots"], params["cam_trans"]
    with torch.no_grad():
        if time_idx > 1 and forward_prop:
            r1 = normalize(rots[0, :, time_idx - 1])
            r2 = normalize(rots[0, :, time_idx - 2])
            rot = normalize(r1 + (r1 - r2))
            t1, t2 = trans[0, :, time_idx - 1], trans[0, :, time_idx - 2]
            return rot, t1 + (t1 - t2)
        return rots[0, :, time_idx - 1].clone(), trans[0, :, time_idx - 1].clone()


def track_frame(
    params: Dict[str, torch.Tensor],
    rot0: torch.Tensor,
    tran0: torch.Tensor,
    frame_im: torch.Tensor,
    frame_depth: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    num_iters: int,
    use_sil_for_loss: bool = True,
    sil_thres: float = 0.99,
    ignore_outlier_depth_loss: bool = False,
    loss_w_im: float = 0.5,
    loss_w_depth: float = 1.0,
    lr_rot: float = 0.0004,
    lr_tran: float = 0.002,
    rebin_every: int = 10,
    fixed_binning: bool = False,
    resume=None,
    on_segment=None,
) -> TrackResult:
    """Track one frame from the pose (``rot0``, ``tran0``).

    Binning is frozen for ``rebin_every`` iterations and redone at the
    current pose, capped at the latest render's per-tile saturation depth;
    ``rebin_every=0`` bins afresh every iteration. ``fixed_binning`` bins
    once, at (``rot0``, ``tran0``), for every iteration of the call (the
    JAX ``track_frame``'s ``fixed_binning``). ``resume`` (a previous
    result's ``resume_state``) continues the same Adam run: pose, moments,
    step count and best candidate carry over. ``on_segment(done, rot,
    tran)`` runs after the last iteration of each binning segment (every
    ``rebin_every`` iterations and at the end; only at the end with
    ``fixed_binning`` or ``rebin_every=0``) with the iterations done in this
    call and the pose after them: the JAX pipeline's tracking-loss figure
    points."""
    lrs = {"rot": lr_rot, "tran": lr_tran}
    nonfinite = torch.zeros((), dtype=torch.int32, device=rot0.device)
    if resume is None:
        start = {"rot": rot0, "tran": tran0}
        opt = None
        best_rot, best_tran = rot0.detach().clone(), tran0.detach().clone()
        best_loss = torch.tensor(1e20, device=rot0.device)
        sat = None
    else:
        start, opt, best_rot, best_tran, best_loss, sat = resume
    pose = {k: v.detach().clone().requires_grad_() for k, v in start.items()}
    if opt is None:
        opt = init_adam(pose)
    binned, out = None, None
    segment = rebin_every if rebin_every and not fixed_binning else num_iters
    if fixed_binning:
        binned = compute_binned(params, rot0.detach(), tran0.detach(), cam, cfg)
    for i in range(num_iters):
        if not fixed_binning and rebin_every and i % rebin_every == 0:
            binned = compute_binned(
                params, pose["rot"].detach(), pose["tran"].detach(), cam, cfg,
                depth_cap=sat,
            )
        out = slam_loss(
            params, pose["rot"], pose["tran"], frame_im, frame_depth, cam,
            cfg, tracking=True, loss_w_im=loss_w_im,
            loss_w_depth=loss_w_depth, use_sil_for_loss=use_sil_for_loss,
            sil_thres=sil_thres,
            ignore_outlier_depth_loss=ignore_outlier_depth_loss,
            binned=binned,
        )
        g_rot, g_tran = torch.autograd.grad(out.loss, [pose["rot"], pose["tran"]])
        finite = torch.isfinite(out.loss)
        adam_step(pose, {"rot": g_rot, "tran": g_tran}, opt, lrs, eps=1e-8,
                  apply=finite)
        with torch.no_grad():
            better = (out.loss < best_loss) & finite
            best_rot = torch.where(better, pose["rot"], best_rot)
            best_tran = torch.where(better, pose["tran"], best_tran)
            best_loss = torch.where(better, out.loss.detach(), best_loss)
            nonfinite = nonfinite + (~finite).int()
        sat = out.sat_depth
        done = i + 1
        if on_segment is not None and (done % segment == 0 or done == num_iters):
            on_segment(done, pose["rot"].detach(), pose["tran"].detach())
    last = {} if out is None else {k: v.detach() for k, v in out.losses.items()}
    return TrackResult(
        best_rot=best_rot, best_tran=best_tran, best_loss=best_loss,
        nonfinite=nonfinite, last_losses=last,
        final_rot=pose["rot"].detach(), final_tran=pose["tran"].detach(),
        opt=opt, sat_depth=sat,
    )
