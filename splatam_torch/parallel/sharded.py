"""Keyframe-batch data parallelism with tile-sharded renders.

Counterpart of ``splatam_tpu/parallel/sharded.py``: ``batched_map_step`` is
one Adam step on the mean mapping loss over a batch of keyframes, the batch
split over the ``data`` ranks of a mesh and, with
``RasterConfig.shard_axis == "tiles"``, each keyframe's render split over
the ``tiles`` ranks (``rasterize_rows_sharded``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from splatam_torch.core.losses import slam_loss
from splatam_torch.core.optim import AdamState, adam_step
from splatam_torch.core.params import GAUSSIAN_KEYS
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import Camera


def batched_map_step(
    params: Dict[str, torch.Tensor],
    active: torch.Tensor,  # (N,) bool
    opt_state: AdamState,
    cam_rots: torch.Tensor,  # (B, 4)
    cam_trans: torch.Tensor,  # (B, 3)
    frames_im: torch.Tensor,  # (B, 3, H, W)
    frames_depth: torch.Tensor,  # (B, 1, H, W)
    cam: Camera,
    cfg: RasterConfig,
    lrs,
    sil_thres: float = 0.5,
    use_sil_for_loss: bool = False,
    ignore_outlier_depth_loss: bool = False,
    loss_w_im: float = 0.5,
    loss_w_depth: float = 1.0,
    mesh=None,
) -> Tuple[Dict[str, torch.Tensor], AdamState, torch.Tensor]:
    """One Adam step (eps 1e-15) on the mean mapping loss over the keyframe
    batch. Returns (params, opt_state, loss): the Gaussian tensors and the
    moments are updated in place, inactive rows' gradients are zero.

    Every rank passes the whole batch and the same parameters; the ``data``
    ranks of ``mesh`` take B / n_data keyframes each, in order, and each
    keyframe's render goes over the ``tiles`` ranks when ``cfg.shard_axis``
    is ``"tiles"`` and that axis has more than one rank (the render sums
    its gradients over them). The gradients and the loss are then summed
    over the ``data`` ranks, so every rank takes the same step. Without a
    mesh (or on a one-rank one) the whole batch runs here."""
    b = cam_rots.shape[0]
    n_data = 1 if mesh is None else mesh.shape.get("data", 1)
    if b % n_data:
        raise ValueError(f"batch {b} does not split over {n_data} data ranks")
    per = b // n_data
    d = 0 if mesh is None else mesh.coords.get("data", 0)
    gauss = {k: params[k].detach().requires_grad_() for k in GAUSSIAN_KEYS}
    p = dict(params)
    p.update(gauss)
    total = torch.zeros((), device=frames_im.device)
    for i in range(d * per, (d + 1) * per):
        out = slam_loss(
            p, cam_rots[i], cam_trans[i], frames_im[i], frames_depth[i], cam,
            cfg, tracking=False, loss_w_im=loss_w_im,
            loss_w_depth=loss_w_depth, use_sil_for_loss=use_sil_for_loss,
            sil_thres=sil_thres,
            ignore_outlier_depth_loss=ignore_outlier_depth_loss,
            active=active, mesh=mesh,
        )
        total = total + out.loss
    grads = torch.autograd.grad(total, [gauss[k] for k in GAUSSIAN_KEYS])
    group = None if mesh is None else mesh.group("data")
    # one collective for the loss and every gradient
    flat = torch.cat([total.detach().reshape(1)]
                     + [g.reshape(-1) for g in grads])
    if group is not None:
        dist.all_reduce(flat, group=group)
    flat = flat / b
    loss, at = flat[0], 1
    keep = active.to(flat.device)
    mean_grads = {}
    for k, g in zip(GAUSSIAN_KEYS, grads):
        n = g.numel()
        g = flat[at: at + n].reshape(g.shape)
        at += n
        mean_grads[k] = torch.where(keep.reshape(-1, *([1] * (g.ndim - 1))),
                                    g, torch.zeros_like(g))
    adam_step({k: params[k] for k in GAUSSIAN_KEYS}, mean_grads, opt_state,
              dict(lrs), eps=1e-15)
    return params, opt_state, loss
