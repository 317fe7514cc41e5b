"""Inria-3DGS gradient-driven densification (clone + split) and LR schedule.

Counterpart of ``splatam_tpu/slam/inria_densify.py`` (`densify`,
`accumulate_mean2d_gradient`, `utils/slam_external.py:100-105,196-243`;
`get_expon_lr_func`, `:246-288`), on the port's growing tensors: clones and
split children are appended at the end of the map with zero Adam moments,
and removed Gaussians take their rows and moments with them. The selection
runs on the device; the split samples are drawn from a numpy ``Generator``
in the JAX package's order, so one seed gives the same new Gaussians in
both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from splatam_torch.core.optim import (
    AdamState,
    cat_state_zeros,
    prune_state,
    reset_param_state,
)
from splatam_torch.core.params import (
    GAUSSIAN_KEYS,
    Params,
    Variables,
    append_gaussians,
    remove_gaussians,
)
from splatam_torch.render.geometry import quat_to_rotmat
from splatam_torch.slam.mapping import inverse_sigmoid


def accumulate_mean2d_gradient(
    variables: Variables, means2d_grad_norm: torch.Tensor, seen: torch.Tensor
) -> Variables:
    """Add each seen Gaussian's screen-space gradient norm to its
    accumulator and count the view (`slam_external.py:100-105`)."""
    variables = dict(variables)
    variables["means2D_gradient_accum"] = variables["means2D_gradient_accum"] + (
        torch.where(seen, means2d_grad_norm, torch.zeros_like(means2d_grad_norm))
    )
    variables["denom"] = variables["denom"] + seen.float()
    return variables


@torch.no_grad()
def densify(
    params: Params,
    variables: Variables,
    opt_state: AdamState,
    it: int,
    densify_dict: Dict,
    scene_radius: float,
    rng: np.random.Generator,
):
    """Clone/split densification, pruning and opacity reset
    (`slam_external.py:196-243`). Returns (params, variables, opt_state);
    the moments in ``opt_state`` are updated in place."""
    if it > densify_dict["stop_after"]:
        return params, variables, opt_state

    if it >= densify_dict["start_after"] and it % densify_dict["densify_every"] == 0:
        accum = variables["means2D_gradient_accum"]
        denom = variables["denom"]
        grads = torch.nan_to_num(torch.where(
            denom > 0, accum / torch.clamp(denom, min=1), torch.zeros_like(accum)))
        scales = torch.exp(params["log_scales"]).expand(-1, 3)
        max_scale = scales.max(dim=1).values
        hot = grads >= densify_dict["grad_thresh"]
        small = max_scale <= 0.01 * scene_radius
        to_clone, to_split = hot & small, hot & ~small
        n = densify_dict["num_to_split_into"]

        new_vals = {k: [params[k][to_clone]] for k in GAUSSIAN_KEYS}
        if bool(to_split.any()):
            rep = torch.nonzero(to_split)[:, 0].repeat(n)
            stds = scales[rep]
            samples = torch.as_tensor(
                rng.normal(0.0, 1.0, tuple(stds.shape)).astype(np.float32),
                device=stds.device) * stds
            rots = quat_to_rotmat(params["unnorm_rotations"][rep])
            offset = torch.einsum("nij,nj->ni", rots, samples)
            for k in GAUSSIAN_KEYS:
                v = params[k][rep]
                if k == "means3D":
                    v = v + offset
                elif k == "log_scales":
                    v = torch.log(torch.exp(v) / (0.8 * n))
                new_vals[k].append(v)
        stacked = {k: torch.cat(v) for k, v in new_vals.items()}
        m = stacked["means3D"].shape[0]
        if m:
            params, variables = append_gaussians(params, variables, stacked,
                                                 time_idx=it)
            cat_state_zeros(opt_state, GAUSSIAN_KEYS, m)

        # split sources go (`slam_external.py:224-226`), then opacity / size
        # pruning (`:228-236`), over the grown map
        remove = torch.cat([to_split, to_split.new_zeros(m)])
        if it == densify_dict["stop_after"]:
            thresh = densify_dict["final_removal_opacity_threshold"]
        else:
            thresh = densify_dict["removal_opacity_threshold"]
        remove |= torch.sigmoid(params["logit_opacities"][:, 0]) < thresh
        if it >= densify_dict["remove_big_after"]:
            big = torch.exp(params["log_scales"]).max(dim=1).values
            remove |= big > 0.1 * scene_radius
        if bool(remove.any()):
            keep = ~remove
            params, variables = remove_gaussians(params, variables, keep)
            prune_state(opt_state, GAUSSIAN_KEYS, keep)
        variables = dict(variables)
        for k in ("means2D_gradient_accum", "denom", "max_2D_radius"):
            variables[k] = torch.zeros_like(variables[k])

    if (
        it > 0
        and densify_dict.get("reset_opacities", False)
        and it % densify_dict["reset_opacities_every"] == 0
    ):
        params = dict(params)
        params["logit_opacities"] = torch.full_like(
            params["logit_opacities"], inverse_sigmoid(0.01)
        )
        reset_param_state(opt_state, "logit_opacities")
    return params, variables, opt_state


def get_expon_lr_func(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Plenoxels-style log-linear LR decay (`slam_external.py:260-288`)."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
            )
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper
