"""Image tile bands rendered per rank: the render sharded over tile rows
(and columns, on a 2-D grid).

Counterpart of ``splatam_tpu/parallel/pallas_sharded.py``. Every rank holds
the Gaussians whole, owns a band of tile rows (a cell of a 2-D grid), bins
only the instances that fall in it (rects clipped before expansion, so the
stream shrinks with the band) and composites the band with the same kernels
as the whole image (B1/B2 aligned, B3a-d split). The bands are gathered into
the image with a differentiable all-gather; the gradients of the replicated
inputs are all-reduced over the ranks in the backward pass, which is what
``shard_map``'s transpose gives in JAX.

Ported are the math and the contract, not the SPMD adaptations: a band is
rendered at its own height (JAX pads every band to the tallest, as one
executable serves all devices) and no instance capacity exists. The
partitions are host-side numpy, bit for bit the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from splatam_torch.parallel.mesh import all_gather_rows
from splatam_torch.render.binning import RasterConfig, bin_gaussians_csr
from splatam_torch.render.camera import Camera
from splatam_torch.render.geometry import (
    MEDIAN_DEPTH_INIT,
    TILE,
    Projected,
    grid_dims,
    preprocess,
)
from splatam_torch.render.raster import SAT_INF, pack_attrs, rasterize_tiles
from splatam_torch.render.render_tiled import RenderAux, RenderOutput

# ---------------------------------------------------------------------------
# Host-side partitions (pallas_sharded.py:31-154 of the JAX package)
# ---------------------------------------------------------------------------


def band_partition(row_loads, ndev: int) -> np.ndarray:
    """Optimal contiguous partition of tile rows into ``ndev`` bands: the
    linear-partition DP minimising the largest band load. Returns the
    (ndev + 1,) int32 tile-row bounds (band d owns rows [b[d], b[d + 1]);
    empty bands allowed). The render is exact whatever the bounds; stale
    loads only cost balance."""
    loads = np.asarray(row_loads, dtype=np.int64)
    g = loads.shape[0]
    pre = np.concatenate([[0], np.cumsum(loads)])
    inf = np.iinfo(np.int64).max
    dp = np.full((ndev + 1, g + 1), inf, dtype=np.int64)
    choice = np.zeros((ndev + 1, g + 1), dtype=np.int32)
    dp[0, 0] = 0
    for d in range(1, ndev + 1):
        for i in range(g + 1):
            # band d covers rows [j, i); cost = max(dp[d-1, j], load(j, i))
            j = np.arange(i + 1)
            cost = np.maximum(dp[d - 1, : i + 1], pre[i] - pre[: i + 1])
            best = int(np.argmin(cost))
            dp[d, i] = cost[best]
            choice[d, i] = j[best]
    bounds = [g]
    i = g
    for d in range(ndev, 0, -1):
        i = int(choice[d, i])
        bounds.append(i)
    return np.asarray(bounds[::-1], dtype=np.int32)


def row_loads_from_counts(counts, grid_x: int) -> np.ndarray:
    """(grid_y,) per-tile-row instance loads from a binning's (T,) counts."""
    return np.asarray(counts).reshape(-1, grid_x).sum(axis=1)


def _axis_partition_minimax(band_loads, n: int) -> np.ndarray:
    """Partition the columns of ``band_loads`` (B, L) into ``n`` contiguous
    parts minimising the largest (band, part) load. Exact DP. Returns the
    (n + 1,) bounds."""
    bl = np.asarray(band_loads, dtype=np.int64)
    b, g = bl.shape
    pre = np.concatenate([np.zeros((b, 1), np.int64), np.cumsum(bl, 1)], 1)
    inf = np.iinfo(np.int64).max
    dp = np.full((n + 1, g + 1), inf, dtype=np.int64)
    choice = np.zeros((n + 1, g + 1), dtype=np.int32)
    dp[0, 0] = 0
    for d in range(1, n + 1):
        for i in range(g + 1):
            cell = (pre[:, i : i + 1] - pre[:, : i + 1]).max(axis=0)  # (i+1,)
            cost = np.maximum(dp[d - 1, : i + 1], cell)
            best = int(np.argmin(cost))
            dp[d, i] = cost[best]
            choice[d, i] = best
    bounds = [g]
    i = g
    for d in range(n, 0, -1):
        i = int(choice[d, i])
        bounds.append(i)
    return np.asarray(bounds[::-1], dtype=np.int32)


def grid_partition(counts, grid_x: int, ndev: int):
    """2-D load-balanced tile partition over an (nr x nc) rank grid: every
    factorisation nr * nc == ndev in both axis orders, each solved by the
    exact minimax DP, keeping the smallest largest cell. Returns
    (row_bounds (nr+1,), col_bounds (nc+1,), cell_loads (nr, nc))."""
    loads = np.asarray(counts, dtype=np.int64).reshape(-1, grid_x)

    def cells(rb, cb):
        return np.array(
            [
                [
                    loads[rb[i] : rb[i + 1], cb[j] : cb[j + 1]].sum()
                    for j in range(len(cb) - 1)
                ]
                for i in range(len(rb) - 1)
            ]
        )

    best = None
    for nr in range(1, ndev + 1):
        if ndev % nr:
            continue
        nc = ndev // nr
        for order in ("rows_first", "cols_first"):
            if order == "rows_first":
                rb = band_partition(loads.sum(axis=1), nr)
                bands = np.stack(
                    [loads[rb[i] : rb[i + 1]].sum(axis=0) for i in range(nr)]
                )
                cb = _axis_partition_minimax(bands, nc)
            else:
                cb = band_partition(loads.sum(axis=0), nc)
                bands = np.stack(
                    [
                        loads[:, cb[j] : cb[j + 1]].sum(axis=1)
                        for j in range(nc)
                    ]
                )
                rb = _axis_partition_minimax(bands, nr)
            cl = cells(rb, cb)
            if best is None or cl.max() < best[2].max():
                best = (rb, cb, cl)
    return best


def equal_bands(grid: int, n: int) -> np.ndarray:
    """The JAX package's default bands: ceil(grid / n) tile rows each (the
    last ones shorter or empty)."""
    per = (grid + n - 1) // n
    return np.minimum(np.arange(n + 1) * per, grid).astype(np.int32)


# ---------------------------------------------------------------------------
# The per-band body: no communication
# ---------------------------------------------------------------------------


class BandOutput(NamedTuple):
    """One band's render in band-local pixels, tile-padded: (C, gyl * 16,
    gxl * 16) images, C = the feature channels."""

    color: torch.Tensor  # features with the background composed
    depth: torch.Tensor  # (1, ...) median depth, 15 where unset
    final_t: torch.Tensor  # (...)
    sat_depth: torch.Tensor  # (gyl, gxl) per tile, +inf where unsaturated
    num_instances: int


def local_band(proj: Projected, ty0: int, gyl: int, tx0: int = 0,
               gxl: Optional[int] = None) -> Projected:
    """Clip the tile rects to the band [ty0, ty0 + gyl) x [tx0, tx0 + gxl),
    recount tiles_touched, and shift rects and means2d into band-local
    coordinates (binning's tile-alpha cull compares means2d with tile pixel
    boxes, so both live in one frame). The shift keeps means2d's gradient."""
    rm, rx = proj.rect_min, proj.rect_max
    if gxl is None:
        rx0, rx1 = rm[:, 0], rx[:, 0]
    else:
        rx0 = torch.clamp(rm[:, 0] - tx0, 0, gxl)
        rx1 = torch.clamp(rx[:, 0] - tx0, 0, gxl)
    ry0 = torch.clamp(rm[:, 1] - ty0, 0, gyl)
    ry1 = torch.clamp(rx[:, 1] - ty0, 0, gyl)
    touched = (rx1 - rx0) * (ry1 - ry0)
    touched = torch.where(proj.tiles_touched > 0, touched,
                          torch.zeros_like(touched))
    shift = torch.tensor([float(tx0 * TILE), float(ty0 * TILE)],
                         device=proj.means2d.device)
    return proj._replace(
        means2d=proj.means2d - shift,
        rect_min=torch.stack([rx0, ry0], dim=-1),
        rect_max=torch.stack([rx1, ry1], dim=-1),
        tiles_touched=touched,
    )


def band_body(proj: Projected, opacities: torch.Tensor, colors: torch.Tensor,
              cam: Camera, cfg: RasterConfig, rows: Sequence[int],
              cols: Optional[Sequence[int]] = None) -> BandOutput:
    """Render tile rows ``rows`` = (ty0, ty1) (and columns ``cols``, else
    all) of a view whose preprocess, with the global camera, is ``proj``:
    bin on the band-local grid in ``cfg.layout``, pack, composite with the
    kernels of that layout. No communication."""
    grid_x, _ = grid_dims(cam)
    ty0, ty1 = int(rows[0]), int(rows[1])
    tx0, tx1 = (0, grid_x) if cols is None else (int(cols[0]), int(cols[1]))
    gyl, gxl = ty1 - ty0, tx1 - tx0
    nfeat = colors.shape[-1]
    dev = colors.device
    if gyl <= 0 or gxl <= 0:
        # an empty band still joins the backward's collectives: its zero
        # output is tied to the inputs
        tie = 0.0 * (colors[:0].sum() + opacities[:0].sum()
                     + proj.means2d[:0].sum() + proj.conic[:0].sum())
        hb, wb = max(gyl, 0) * TILE, max(gxl, 0) * TILE
        zero = torch.zeros((nfeat, hb, wb), device=dev) + tie
        return BandOutput(zero, zero[:1] + MEDIAN_DEPTH_INIT, zero[0] + 1.0,
                          torch.full((max(gyl, 0), max(gxl, 0)),
                                     float("inf"), device=dev), 0)
    local = local_band(proj, ty0, gyl, tx0, None if cols is None else gxl)
    cam_band = dataclasses.replace(cam, image_height=gyl * TILE,
                                   image_width=gxl * TILE)
    binned = bin_gaussians_csr(local.detach(), cam_band, cfg,
                               opacities=opacities)
    attrs = pack_attrs(local.means2d, local.conic, opacities, local.depths,
                       colors)
    res = rasterize_tiles(attrs, binned, gxl, cfg.chunk, nfeat=nfeat)

    def to_image(blocks):  # (T, C, 256) channel-major -> (C, h, w)
        c = blocks.shape[1]
        img = blocks.reshape(gyl, gxl, c, TILE, TILE)
        return img.permute(2, 0, 3, 1, 4).reshape(c, gyl * TILE, gxl * TILE)

    color_img, aux_img = to_image(res.color), to_image(res.aux)
    final_t = aux_img[1]
    bg = torch.zeros(nfeat, dtype=torch.float32, device=dev)
    k = min(nfeat, cam.bg.shape[0])
    bg[:k] = cam.bg[:k]
    color = color_img[:nfeat] + final_t[None] * bg[:, None, None]
    depth = torch.where(aux_img[0] > 0.0, aux_img[0],
                        torch.full_like(aux_img[0], MEDIAN_DEPTH_INIT))
    sat = res.aux[:, 2, 0].detach()
    sat = torch.where(sat < SAT_INF, sat, torch.full_like(sat, float("inf")))
    return BandOutput(color, depth[None], final_t, sat.reshape(gyl, gxl),
                      binned.num_instances)


def rasterize_band(means3d, colors, opacities, scales, rotations, cam: Camera,
                   cfg: RasterConfig, rows, cols=None, active=None
                   ) -> tuple[BandOutput, Projected]:
    """``band_body`` after ``preprocess`` with the global camera: what one
    rank of ``rasterize_rows_sharded`` computes."""
    opacities = opacities.reshape(-1)
    proj = preprocess(means3d, scales, rotations, cam, active=active)
    return band_body(proj, opacities, colors, cam, cfg, rows, cols), proj


# ---------------------------------------------------------------------------
# Assembly and the collectives
# ---------------------------------------------------------------------------


def assemble(cells: List[List[torch.Tensor]], band_starts, col_starts,
             height: int, width: int) -> torch.Tensor:
    """Place band (r, c)'s (C, h, w) image (tile-padded, possibly wider
    than the band) at its tile rows and columns: the JAX package's constant
    row and column gathers (``_src``), as slices and concatenations."""
    rows = []
    for r, row in enumerate(cells):
        h = (int(band_starts[r + 1]) - int(band_starts[r])) * TILE
        parts = [img[:, :h, : (int(col_starts[c + 1]) - int(col_starts[c]))
                     * TILE] for c, img in enumerate(row)]
        rows.append(torch.cat(parts, dim=2))
    return torch.cat(rows, dim=1)[:, :height, :width]


def assemble_sat(cells: List[List[torch.Tensor]], band_starts,
                 col_starts) -> torch.Tensor:
    """(T,) per-tile saturation depths from the bands' (gyl, gxl) tables."""
    rows = []
    for r, row in enumerate(cells):
        h = int(band_starts[r + 1]) - int(band_starts[r])
        rows.append(torch.cat([t[:h, : int(col_starts[c + 1])
                                 - int(col_starts[c])]
                               for c, t in enumerate(row)], dim=1))
    return torch.cat(rows, dim=0).reshape(-1)


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward all-reduces (sums) the gradients over
    ``group``, in one collective: the transpose of replicating the inputs
    over the ranks that each render a part of the image."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.shapes = [t.shape for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):  # unused outputs come as zeros
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        sizes = [int(np.prod(s)) for s in ctx.shapes]
        return (None, *(g.reshape(s) for g, s in
                        zip(flat.split(sizes), ctx.shapes)))


def sum_grads_over(group, *tensors):
    """``tensors`` as they are, with their gradients summed over ``group``
    (nothing without a group)."""
    if group is None:
        return tensors
    live = [i for i, t in enumerate(tensors)
            if t is not None and t.requires_grad]
    if not live:
        return tensors
    out = list(tensors)
    for i, t in zip(live, _SumGrads.apply(group, *(tensors[i] for i in live))):
        out[i] = t
    return tuple(out)


class _GatherReplicated(torch.autograd.Function):
    """All-gather of equal-shape tensors along a new leading axis. The
    caller's loss is the same on every rank of ``group`` (it reads the
    assembled image), so the backward hands each rank its own slice of the
    cotangent, which every rank holds whole."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.rank = dist.get_rank(group)
        return all_gather_rows(x[None], group)

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.rank]


def gather_replicated(group, x: torch.Tensor) -> torch.Tensor:
    if group is None:
        return x[None]
    return _GatherReplicated.apply(group, x)


def _band_bounds(grid: int, n: int, starts) -> np.ndarray:
    if starts is None:
        return equal_bands(grid, n)
    starts = np.asarray(starts, dtype=np.int32)
    if starts.shape != (n + 1,) or starts[0] != 0 or starts[-1] != grid:
        raise ValueError(f"band bounds {starts.tolist()} do not cover the "
                         f"{grid} tiles in {n} bands")
    return starts


def _render(stack: torch.Tensor, nfeat: int, radius, num_instances: int,
            sat_depth: torch.Tensor) -> tuple[RenderOutput, RenderAux]:
    """(features, depth, final T) stacked in one (nfeat + 2, H, W) image ->
    the render and its aux, as ``rasterize_tiled`` returns them."""
    return (RenderOutput(color=stack[:nfeat], radius=radius,
                         depth=stack[nfeat: nfeat + 1],
                         final_t=stack[nfeat + 1]),
            RenderAux(num_instances=num_instances, sat_depth=sat_depth))


def _stack(band: BandOutput) -> torch.Tensor:
    return torch.cat([band.color, band.depth, band.final_t[None]])


def rasterize_bands(means3d, colors, opacities, scales, rotations,
                    cam: Camera, cfg: RasterConfig, band_starts,
                    col_starts=None, active=None
                    ) -> tuple[RenderOutput, RenderAux, list]:
    """Every band (every cell of a 2-D grid) rendered in turn in this
    process with the per-band body, and assembled as
    ``rasterize_rows_sharded`` assembles the gathered bands. Returns the
    render, its aux and ((ty0, ty1), (tx0, tx1), instances) per cell."""
    grid_x, grid_y = grid_dims(cam)
    rb = _band_bounds(grid_y, len(band_starts) - 1, band_starts)
    cb = (np.array([0, grid_x], np.int32) if col_starts is None else
          _band_bounds(grid_x, len(col_starts) - 1, col_starts))
    opacities = opacities.reshape(-1)
    proj = preprocess(means3d, scales, rotations, cam, active=active)
    cells = [[band_body(proj, opacities, colors, cam, cfg, rb[r: r + 2],
                        None if col_starts is None else cb[c: c + 2])
              for c in range(len(cb) - 1)] for r in range(len(rb) - 1)]
    loads = [((int(rb[r]), int(rb[r + 1])), (int(cb[c]), int(cb[c + 1])),
              o.num_instances) for r, row in enumerate(cells)
             for c, o in enumerate(row)]
    stack = assemble([[_stack(o) for o in row] for row in cells], rb, cb,
                     cam.image_height, cam.image_width)
    sat = assemble_sat([[o.sat_depth for o in row] for row in cells], rb, cb)
    out, aux = _render(stack, colors.shape[-1], proj.radius,
                       sum(n for _, _, n in loads), sat)
    return out, aux, loads


def gather_bands(group, band: BandOutput, rb, cb, cells, cam: Camera):
    """All-gather every rank's band over ``group`` and assemble: ``cells``
    lists the (row, column) band of each group rank. One differentiable
    gather of the image channels, padded to the tallest band and the widest
    column, and one of the instance counts and tile tables. Returns the
    (nfeat + 2, H, W) stack, the instances summed over the bands and the
    (T,) saturation depths."""
    hp, wp = int(np.diff(rb).max()), int(np.diff(cb).max())
    img = _stack(band)
    img = F.pad(img, (0, wp * TILE - img.shape[2], 0, hp * TILE - img.shape[1]))
    sat = torch.full((hp, wp), float("inf"), device=img.device)
    sat[: band.sat_depth.shape[0], : band.sat_depth.shape[1]] = band.sat_depth
    meta = torch.cat([torch.tensor([float(band.num_instances)],
                                   device=img.device), sat.reshape(-1)])
    imgs = gather_replicated(group, img)
    metas = gather_replicated(group, meta.double())
    where = {tuple(rc): i for i, rc in enumerate(cells)}
    n_rows, n_cols = len(rb) - 1, len(cb) - 1
    stack = assemble([[imgs[where[(r, c)]] for c in range(n_cols)]
                      for r in range(n_rows)], rb, cb, cam.image_height,
                     cam.image_width)
    sats = assemble_sat([[metas[where[(r, c)], 1:].float().reshape(hp, wp)
                          for c in range(n_cols)] for r in range(n_rows)],
                        rb, cb)
    return stack, int(metas[:, 0].sum().item()), sats


def rasterize_rows_sharded(
    means3d: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    mesh,
    axis_name: str = "tiles",
    active: torch.Tensor | None = None,
    band_starts=None,
    col_starts=None,
    axis_name_x: str | None = None,
) -> tuple[RenderOutput, RenderAux]:
    """Render with tile rows split over ``axis_name`` of ``mesh`` (and tile
    columns over ``axis_name_x``: a 2-D grid from ``grid_partition``).

    This rank renders its band (cell) with the per-band body; the bands are
    all-gathered over the axes' group and placed at their rows and columns,
    so every rank returns the whole image (as ``rasterize_tiled`` does).
    ``band_starts`` / ``col_starts`` ((n + 1,) tile bounds, from
    ``band_partition`` / ``grid_partition``) replace the equal bands. The
    gradients of the inputs come back summed over the group: call the
    backward on every rank, with the same loss of the image.
    ``num_instances`` is summed over the bands; there is no overflow."""
    grid_x, grid_y = grid_dims(cam)
    rb = _band_bounds(grid_y, mesh.shape[axis_name], band_starts)
    if axis_name_x is None:
        axes, cb = (axis_name,), np.array([0, grid_x], np.int32)
    else:
        if col_starts is None:
            raise ValueError("2-D sharding needs col_starts")
        axes = (axis_name, axis_name_x)
        cb = _band_bounds(grid_x, mesh.shape[axis_name_x], col_starts)
    group = mesh.group(*axes)
    opacities = opacities.reshape(-1)
    means3d, colors, opacities, scales, rotations = sum_grads_over(
        group, means3d, colors, opacities, scales, rotations)
    r = mesh.index(axis_name)
    c = 0 if axis_name_x is None else mesh.index(axis_name_x)
    band, proj = rasterize_band(
        means3d, colors, opacities, scales, rotations, cam, cfg,
        rb[r: r + 2], None if axis_name_x is None else cb[c: c + 2],
        active=active)
    # each group rank's (row, column) band, in group-rank order
    cells = ([(0, 0)] if group is None else
             [rc if axis_name_x is not None else (rc[0], 0)
              for rc in mesh.group_rank_coords(*axes)])
    stack, num, sat = gather_bands(group, band, rb, cb, cells, cam)
    return _render(stack, colors.shape[-1], proj.radius, num, sat)
