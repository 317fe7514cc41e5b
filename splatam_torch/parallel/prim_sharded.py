"""Gaussian-primitive sharding: each rank holds 1/n of the Gaussians, runs
their preprocess, and only compact render records go over the wire.

Counterpart of ``splatam_tpu/parallel/prim_sharded.py``. Each rank of the
mesh axis

  * holds N/n rows of the Gaussian dict (and so 1/n of the Adam moments),
    and runs ``transform_to_frame`` and ``preprocess`` on them only;
  * packs its survivors into render records (``RECORD``: screen mean,
    conic, opacity, depth, global id, the fused 6 features, and the tile
    rect with its tile count) and all-gathers only those;
  * renders its band of tile rows from the gathered records, as
    ``pallas_sharded`` does, and the bands are gathered into the image.

In the backward pass the record gather's transpose is a reduce-scatter, so
each rank gets exactly its shard's parameter gradients; the pose gradients
are all-reduced. The records are the port's own layout, not the JAX
package's 16-row attribute table.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_torch.core.losses import depth_silhouette_colors
from splatam_torch.core.transforms import normalize, transform_to_frame
from splatam_torch.parallel.mesh import all_gather_rows, reduce_scatter_rows
from splatam_torch.parallel.pallas_sharded import (
    _band_bounds,
    _render,
    _stack,
    assemble,
    assemble_sat,
    band_body,
    gather_bands,
    sum_grads_over,
)
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import Camera
from splatam_torch.render.geometry import Projected, grid_dims, preprocess
from splatam_torch.render.render_tiled import RenderAux, RenderOutput

NFEAT = 6  # RGB, depth, silhouette, depth^2 (the fused mapping render)
# record columns: means2d 0-1, conic 2-4, opacity 5, depth 6, global id 7,
# features 8-13, rect min 14-15, rect max 16-17, tiles touched 18 (the
# integers are exact in float32 below 2^24)
FEAT0, RECT0 = 8, 8 + NFEAT
RECORD = RECT0 + 5


def shard_records(shard: dict, active, cam_rot, cam_tran, cam: Camera,
                  offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_local, RECORD) render records of one shard of the Gaussian dict,
    whose first row is Gaussian ``offset`` of the whole map, and its
    (n_local,) radii. Differentiable in the shard and the pose."""
    iso = shard["log_scales"].shape[1] == 1
    log_scales = shard["log_scales"].expand(-1, 3) if iso else shard["log_scales"]
    pts, rots, _ = transform_to_frame(
        shard["means3D"], shard["unnorm_rotations"], cam_rot, cam_tran,
        transform_rots=not iso, gaussians_grad=True, camera_grad=True,
    )
    proj = preprocess(pts, torch.exp(log_scales), normalize(rots), cam,
                      active=active)
    feats = torch.cat([shard["rgb_colors"],
                       depth_silhouette_colors(pts, cam.viewmatrix)], dim=-1)
    n = pts.shape[0]
    gid = torch.arange(offset, offset + n, device=pts.device,
                       dtype=torch.float32)
    rect = torch.cat([proj.rect_min, proj.rect_max,
                      proj.tiles_touched[:, None]], dim=-1).float()
    rec = torch.cat([
        proj.means2d, proj.conic,
        torch.sigmoid(shard["logit_opacities"]).reshape(n, 1),
        proj.depths[:, None], gid[:, None], feats, rect], dim=-1)
    return rec, proj.radius


def records_band(records: torch.Tensor, cam: Camera, cfg: RasterConfig,
                 rows, cols=None):
    """One band's render from the gathered (N, RECORD) records: the
    per-band body of ``pallas_sharded`` on the records' projection."""
    rect = records[:, RECT0:].detach().round().to(torch.int32)
    proj = Projected(
        means2d=records[:, 0:2], depths=records[:, 6],
        conic=records[:, 2:5], radius=torch.zeros_like(rect[:, 0]),
        rect_min=rect[:, 0:2], rect_max=rect[:, 2:4],
        tiles_touched=rect[:, 4])
    return band_body(proj, records[:, 5], records[:, FEAT0:RECT0], cam, cfg,
                     rows, cols)


class _GatherRecords(torch.autograd.Function):
    """All-gather of every rank's (n_local, C) records along rows; the
    backward reduce-scatters (sums over the ranks, then slices) the
    cotangent: each rank's bands add to every rank's records."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, reduce_scatter_rows(g, ctx.group)


def render_prim_sharded(
    params: dict,
    active: torch.Tensor,
    cam_rot: torch.Tensor,
    cam_tran: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    mesh,
    axis_name: str = "prims",
) -> tuple[RenderOutput, RenderAux]:
    """Fused 6-channel render (RGB, depth, silhouette, depth^2) of the map
    whose rows are split over ``axis_name`` of ``mesh``.

    ``params`` (means3D, rgb_colors, unnorm_rotations, logit_opacities,
    log_scales) and ``active`` hold this rank's shard: rows
    [r * n_local, (r + 1) * n_local) of the map, the same n_local on every
    rank (the map's size must divide the axis). Every rank returns the
    whole image; ``radius`` is its shard's. Differentiable: the parameter
    gradients are this shard's, the pose gradients summed over the ranks.
    Call the backward on every rank with the same loss of the image."""
    ndev = mesh.shape[axis_name]
    r = mesh.index(axis_name)
    group = mesh.group(axis_name)
    nloc = params["means3D"].shape[0]
    cam_rot, cam_tran = sum_grads_over(group, cam_rot, cam_tran)
    rec, radius = shard_records(params, active, cam_rot, cam_tran, cam,
                                r * nloc)
    records = rec if group is None else _GatherRecords.apply(group, rec)
    grid_x, grid_y = grid_dims(cam)
    rb = _band_bounds(grid_y, ndev, None)
    cb = np.array([0, grid_x], np.int32)
    band = records_band(records, cam, cfg, rb[r: r + 2])
    stack, num, sat = gather_bands(group, band, rb, cb,
                                   [(i, 0) for i in range(ndev)], cam)
    return _render(stack, NFEAT, radius, num, sat)


def render_prim_shards(shards, actives, cam_rot, cam_tran, cam: Camera,
                       cfg: RasterConfig):
    """``render_prim_sharded`` over len(shards) shards in this process: the
    shards' records concatenated as the all-gather gives them, every band
    rendered in turn and assembled. Returns (render, aux, records)."""
    ndev = len(shards)
    nloc = shards[0]["means3D"].shape[0]
    recs = [shard_records(s, a, cam_rot, cam_tran, cam, i * nloc)
            for i, (s, a) in enumerate(zip(shards, actives))]
    records = torch.cat([rec for rec, _ in recs])
    grid_x, grid_y = grid_dims(cam)
    rb = _band_bounds(grid_y, ndev, None)
    cb = np.array([0, grid_x], np.int32)
    bands = [records_band(records, cam, cfg, rb[i: i + 2])
             for i in range(ndev)]
    stack = assemble([[_stack(b)] for b in bands], rb, cb, cam.image_height,
                     cam.image_width)
    sat = assemble_sat([[b.sat_depth] for b in bands], rb, cb)
    out, aux = _render(stack, NFEAT, torch.cat([rad for _, rad in recs]),
                       sum(b.num_instances for b in bands), sat)
    return out, aux, records


def gathered_bytes_per_gaussian() -> dict:
    """Bytes per Gaussian that the record gather moves, against what full
    replication would hold per rank (parameters, and with them the Adam
    moments)."""
    record = RECORD * 4
    replicated = (3 + 3 + 4 + 1 + 3) * 4  # params (anisotropic)
    return {
        "gathered_record_bytes": record,
        "replicated_param_bytes": replicated,
        "replicated_param_plus_opt_bytes": 3 * replicated,
    }


def shard_slices(n: int, ndev: int):
    """Row slices of the ``ndev`` equal shards of an ``n``-row map."""
    if n % ndev:
        raise ValueError(f"map of {n} rows does not divide {ndev} shards")
    per = n // ndev
    return [slice(i * per, (i + 1) * per) for i in range(ndev)]

