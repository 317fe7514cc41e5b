"""Map optimization: per-iteration Gaussian Adam step + pruning.

Counterpart of ``splatam_tpu/slam/mapping.py`` (`scripts/splatam.py:844-911`,
`prune_gaussians` `utils/slam_external.py:167-188`). Pruning removes rows
from the parameters, the variables and the Adam moments.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from splatam_torch.core.losses import slam_loss
from splatam_torch.core.optim import (
    AdamState,
    adam_step,
    init_adam,
    prune_state,
    reset_param_state,
)
from splatam_torch.core.params import GAUSSIAN_KEYS, remove_gaussians
from splatam_torch.render.binning import Binned, RasterConfig
from splatam_torch.render.camera import Camera


class MapStepResult(NamedTuple):
    losses: Dict[str, torch.Tensor]
    seen: torch.Tensor  # (N,) bool
    radius: torch.Tensor  # (N,) int32
    sat_depth: torch.Tensor  # (T,)
    nonfinite: torch.Tensor  # () bool: the update was skipped
    # (N,) ||dL/dmeans2D|| (track_means2d_grad; zeros otherwise)
    means2d_grad_norm: torch.Tensor
    # do_ba only: the bundle-adjusted keyframe pose and its Adam state
    cam_rot: torch.Tensor | None = None
    cam_tran: torch.Tensor | None = None
    pose_opt: AdamState | None = None


def init_mapping_optimizer(params: Dict[str, torch.Tensor]) -> AdamState:
    return init_adam({k: params[k] for k in GAUSSIAN_KEYS})


def map_step(
    params: Dict[str, torch.Tensor],
    opt_state: AdamState,
    cam_rot: torch.Tensor,
    cam_tran: torch.Tensor,
    frame_im: torch.Tensor,
    frame_depth: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    lrs: Dict[str, float],
    sil_thres: float = 0.5,
    use_sil_for_loss: bool = False,
    ignore_outlier_depth_loss: bool = False,
    loss_w_im: float = 0.5,
    loss_w_depth: float = 1.0,
    track_means2d_grad: bool = False,
    do_ba: bool = False,
    pose_opt: AdamState | None = None,
    binned: Binned | None = None,
) -> MapStepResult:
    """One mapping Adam iteration on the Gaussians, in place. A non-finite
    loss skips the update (on the device).

    The keyframe pose stays fixed unless ``do_ba`` (bundle adjustment,
    `scripts/splatam.py:232-238`): then it takes its own Adam step with
    ``lrs``' ``cam_unnorm_rots`` / ``cam_trans`` rates (eps 1e-15), its
    moments carried in ``pose_opt`` (fresh where None), and the result
    holds the new pose and moments. ``track_means2d_grad`` gives the
    screen-space mean gradient norms Inria densification accumulates."""
    gauss = {k: params[k].detach().requires_grad_() for k in GAUSSIAN_KEYS}
    p = dict(params)
    p.update(gauss)
    pose = {"cam_unnorm_rots": cam_rot.detach().clone().requires_grad_(do_ba),
            "cam_trans": cam_tran.detach().clone().requires_grad_(do_ba)}
    dummy = None
    if track_means2d_grad:
        dummy = torch.zeros((gauss["means3D"].shape[0], 2),
                            device=frame_im.device, requires_grad=True)
    out = slam_loss(
        p, pose["cam_unnorm_rots"], pose["cam_trans"], frame_im, frame_depth,
        cam, cfg, tracking=False, do_ba=do_ba, loss_w_im=loss_w_im,
        loss_w_depth=loss_w_depth, use_sil_for_loss=use_sil_for_loss,
        sil_thres=sil_thres,
        ignore_outlier_depth_loss=ignore_outlier_depth_loss,
        means2d_dummy=dummy, binned=binned,
    )
    wrt = [gauss[k] for k in GAUSSIAN_KEYS]
    if do_ba:
        wrt += [pose["cam_unnorm_rots"], pose["cam_trans"]]
    if track_means2d_grad:
        wrt.append(dummy)
    grads = list(torch.autograd.grad(out.loss, wrt))
    finite = torch.isfinite(out.loss)
    m2d_norm = torch.zeros_like(gauss["means3D"][:, 0]).detach()
    if track_means2d_grad:
        m2d_norm = torch.where(
            finite, torch.linalg.vector_norm(grads.pop(), dim=-1), m2d_norm)
    if do_ba:
        pose_grads = dict(zip(pose, grads[len(GAUSSIAN_KEYS):]))
        pose = {k: v.detach() for k, v in pose.items()}
        if pose_opt is None:
            pose_opt = init_adam(pose)
        adam_step(pose, pose_grads, pose_opt,
                  {k: lrs.get(k, 0.0) for k in pose}, eps=1e-15, apply=finite)
    adam_step(
        {k: params[k] for k in GAUSSIAN_KEYS},
        dict(zip(GAUSSIAN_KEYS, grads)), opt_state,
        {k: lrs[k] for k in GAUSSIAN_KEYS}, eps=1e-15, apply=finite,
    )
    return MapStepResult(
        losses={k: v.detach() for k, v in out.losses.items()},
        seen=out.radius > 0, radius=out.radius, sat_depth=out.sat_depth,
        nonfinite=~finite, means2d_grad_norm=m2d_norm,
        cam_rot=pose["cam_unnorm_rots"] if do_ba else None,
        cam_tran=pose["cam_trans"] if do_ba else None,
        pose_opt=pose_opt if do_ba else None,
    )


def inverse_sigmoid(x: float) -> float:
    return float(torch.log(torch.tensor(x / (1 - x))))


@torch.no_grad()
def prune_gaussians(
    params: Dict[str, torch.Tensor],
    variables: Dict[str, torch.Tensor],
    opt_state: AdamState,
    it: int,
    prune_dict: Dict,
    scene_radius: float,
):
    """`prune_gaussians` parity. Returns (params, variables, changed):
    ``changed`` says the Gaussian set or its opacities changed, so frozen
    binnings are stale."""
    changed = False
    if it <= prune_dict["stop_after"]:
        if it >= prune_dict["start_after"] and it % prune_dict["prune_every"] == 0:
            if it == prune_dict["stop_after"]:
                thresh = prune_dict["final_removal_opacity_threshold"]
            else:
                thresh = prune_dict["removal_opacity_threshold"]
            remove = torch.sigmoid(params["logit_opacities"][:, 0]) < thresh
            if it >= prune_dict["remove_big_after"]:
                big = torch.exp(params["log_scales"]).max(dim=1).values
                remove = remove | (big > 0.1 * scene_radius)
            if bool(remove.any()):
                keep = ~remove
                params, variables = remove_gaussians(params, variables, keep)
                prune_state(opt_state, GAUSSIAN_KEYS, keep)
                changed = True
        if (
            it > 0
            and prune_dict.get("reset_opacities", False)
            and it % prune_dict["reset_opacities_every"] == 0
        ):
            params = dict(params)
            params["logit_opacities"] = torch.full_like(
                params["logit_opacities"], inverse_sigmoid(0.01)
            )
            reset_param_state(opt_state, "logit_opacities")
            changed = True
    return params, variables, changed
