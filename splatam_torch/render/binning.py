"""Tile binning: instance expansion, per-tile alpha cull, (tile, depth) sort.

Counterpart of the math of ``splatam_tpu/render/binning.py``
(``_expand_instances`` and ``bin_gaussians_csr``), without its static-shape
machinery: tensors here have the sizes the data gives them, so there are no
capacities, no overflow flags and no chunk-aligned windows. The output is the
CUDA reference's ``identifyTileRanges`` form: one depth-sorted gid stream and
a ``[start, end)`` range per tile.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from splatam_torch.render.camera import Camera
from splatam_torch.render.geometry import ALPHA_MIN, TILE, Projected, grid_dims

# Safety slack on the tile-cull bound, in power units (binning.py:267).
CULL_EPS = 1e-3
# Headroom on the per-tile saturation-depth cap (binning.py:273).
SAT_MARGIN = 1.05


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer settings.

    Accepts every field the JAX ``RasterConfig`` defines, so the same config
    dicts load. Only ``chunk`` (instances staged per batch in the kernels,
    which also sets the granularity of the saturation depth) and ``layout``
    are read; the capacities and TPU scheduling options have no meaning
    here and are ignored. Every ``layout`` runs the aligned kernels.
    """

    max_instances: int = 2**20
    max_per_tile: int = 1024
    chunk: int = 128
    max_stream: int | None = None
    max_chunks: int | None = None
    backend: str = "auto"
    reduction: str = "sort"
    scan_impl: str = "mxu"
    pad_slack: float = 0.65
    align_windows: bool = True
    shard_axis: str | None = None
    layout: str = "split"
    max_chunks_tail: int | None = None
    grid_group: int = 1


class Binned(NamedTuple):
    """Depth-sorted instance stream with per-tile ranges."""

    sorted_gid: torch.Tensor  # (K,) int32 gaussian id per sorted instance
    ranges: torch.Tensor  # (T, 2) int32 [start, end) of each tile in the stream
    counts: torch.Tensor  # (T,) int32 instances per tile
    gid_hist: torch.Tensor  # (N,) int32 surviving instances per gaussian
    num_instances: int  # K


def bin_gaussians_csr(
    proj: Projected,
    cam: Camera,
    cfg: RasterConfig,
    opacities: torch.Tensor | None = None,
    depth_cap: torch.Tensor | None = None,
) -> Binned:
    """Expand, cull and sort the (gaussian, tile) instances of a view.

    Each instance is tested against the exact maximum alpha the gaussian
    reaches anywhere in the tile (the box minimum of its quadratic form,
    binning.py:365-402) and dropped below ALPHA_MIN: such instances add
    exactly nothing, in the kernels and in the plain version. ``depth_cap``
    ((T,) f32, +inf = uncapped) also drops instances deeper than SAT_MARGIN
    times the tile's cap: a previous render found every pixel of the tile
    dead before that depth. Ties at equal depth keep the gid-major emission
    order (a stable sort), as in JAX.
    """
    proj = proj.detach()
    dev = proj.depths.device
    n = proj.tiles_touched.shape[0]
    grid_x, grid_y = grid_dims(cam)
    num_tiles = grid_x * grid_y

    tt = proj.tiles_touched.to(torch.int64)
    gid = torch.repeat_interleave(torch.arange(n, device=dev), tt)
    starts = torch.cumsum(tt, 0) - tt
    local = torch.arange(gid.shape[0], device=dev) - starts[gid]
    rmin = proj.rect_min.to(torch.int64)[gid]
    rect_w = torch.clamp(proj.rect_max[:, 0] - proj.rect_min[:, 0], min=1).to(
        torch.int64
    )[gid]
    ty = rmin[:, 1] + torch.div(local, rect_w, rounding_mode="floor")
    tx = rmin[:, 0] + local % rect_w

    if opacities is None:
        log_op = torch.zeros(n, device=dev)
    else:
        log_op = torch.log(torch.clamp(opacities.detach().reshape(-1), min=1e-30))
    log_amin = torch.log(torch.tensor(ALPHA_MIN, dtype=torch.float32, device=dev))
    headroom = (log_op - log_amin + CULL_EPS)[gid]
    mx, my = proj.means2d[gid, 0], proj.means2d[gid, 1]
    ca, cb, cc = proj.conic[gid, 0], proj.conic[gid, 1], proj.conic[gid, 2]
    x_lo = (tx * TILE).to(torch.float32)
    y_lo = (ty * TILE).to(torch.float32)
    dxlo, dxhi = x_lo - mx, x_lo + (TILE - 1) - mx
    dylo, dyhi = y_lo - my, y_lo + (TILE - 1) - my

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def edge_x(x):  # dx fixed, dy free in [dylo, dyhi]
        return q(x, torch.minimum(torch.maximum(-cb * x / cc, dylo), dyhi))

    def edge_y(y):  # dy fixed, dx free in [dxlo, dxhi]
        return q(torch.minimum(torch.maximum(-cb * y / ca, dxlo), dxhi), y)

    inside = (dxlo <= 0.0) & (0.0 <= dxhi) & (dylo <= 0.0) & (0.0 <= dyhi)
    q_min = torch.where(
        inside,
        torch.zeros_like(mx),
        torch.minimum(
            torch.minimum(edge_x(dxlo), edge_x(dxhi)),
            torch.minimum(edge_y(dylo), edge_y(dyhi)),
        ),
    )
    keep = ~(q_min > headroom)
    tile_id = ty * grid_x + tx
    depth = proj.depths[gid]
    if depth_cap is not None:
        cap = depth_cap.to(dev)[torch.clamp(tile_id, 0, num_tiles - 1)]
        keep = keep & ~(depth > cap * SAT_MARGIN)

    gid, tile_id, depth = gid[keep], tile_id[keep], depth[keep]
    # (tile, depth) key: depths of expanded instances are > 0.001, so their
    # f32 bit patterns order like the values
    key = (tile_id << 32) | depth.view(torch.int32).to(torch.int64)
    order = torch.sort(key, stable=True).indices
    sorted_gid = gid[order].to(torch.int32)
    counts = torch.bincount(tile_id, minlength=num_tiles)
    ends = torch.cumsum(counts, 0)
    ranges = torch.stack([ends - counts, ends], dim=-1).to(torch.int32)
    return Binned(
        sorted_gid=sorted_gid,
        ranges=ranges,
        counts=counts.to(torch.int32),
        gid_hist=torch.bincount(gid, minlength=n).to(torch.int32),
        num_instances=int(sorted_gid.shape[0]),
    )
