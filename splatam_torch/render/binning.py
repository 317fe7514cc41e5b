"""Tile binning: instance expansion, per-tile alpha cull, (tile, depth) sort.

Counterpart of the math of ``splatam_tpu/render/binning.py``
(``_expand_instances``, ``bin_gaussians_csr`` and ``bin_gaussians_split``),
without its static-shape machinery: tensors here have the sizes the data
gives them, so there are no capacities, no overflow flags and no pads. Two
layouts of the sorted stream, chosen by ``RasterConfig.layout``:

- ``"aligned"``: the CUDA reference's ``identifyTileRanges`` form, one
  depth-sorted gid stream and a ``[start, end)`` range per tile (kernels
  B1/B2).
- ``"split"`` (the default, as in JAX): every tile's whole chunks back to
  back in an interior region, and the sub-chunk residues paired two per
  chunk in a tail region (kernels B3a-d).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
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
    (``"split"`` or ``"aligned"``, see the module docstring) are read; the
    capacities and TPU scheduling options have no meaning here and are
    ignored.
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


class BinnedSplit(NamedTuple):
    """Split stream layout (``layout="split"``): zero-waste interiors plus
    paired residue tails (``splatam_tpu/render/binning.py::BinnedSplit``).

    Every tile's first ``chunk * (count // chunk)`` instances occupy whole
    chunks of the interior region, one tile per chunk, in the tile's own
    depth order. The remaining ``count % chunk`` residues are packed two per
    chunk into the tail region by the optimal pairing (the largest residues
    that fit nobody get a chunk alone). The interior kernels (B3a, B3c) hand
    each tile's end state to the tail kernels (B3b, B3d) through a per-tile
    carry. The JAX capacities and pads (``nci``/``nct`` pads, ``tblk``) and
    the solo flag packed into the skip bits have no counterpart here;
    ``int_ranges`` is the port's own table: the interior kernels walk it.
    """

    sorted_gid: torch.Tensor  # ((NCi + NCt) * chunk,) int32: interior
    # chunks, then tail chunks; tail rows at and past a chunk's lim are 0
    chunk_meta: torch.Tensor  # (NCi,) int32 interior chunk: tile << 1 | first
    int_ranges: torch.Tensor  # (T, 2) int32 [start, end) of each tile's
    # interior in sorted_gid, whole chunks (empty where the tile has none)
    tmeta: torch.Tensor  # (NCt,) int32 tail chunk: tile_a << 1 | has_interior_a
    tsl: torch.Tensor  # (NCt,) int32 send << 16 | lim: rows [0, send) are
    # tile A's residue, [send, lim) tile B's
    tbt: torch.Tensor  # (NCt,) int32 tile_b << 1 | has_interior_b (tile_b
    # is tile_a, and send == lim, where the chunk holds one residue)
    mask_int: torch.Tensor  # (T,) bool: the tile has interior chunks
    mask_a: torch.Tensor  # (T,) bool: the tile is a tail chunk's A segment
    mask_b: torch.Tensor  # (T,) bool: the tile is a tail chunk's B segment
    tail_cid: torch.Tensor  # (T,) int32 tail chunk of the tile (0 if none)
    tail_role: torch.Tensor  # (T,) int32 0 = A segment, 1 = B segment
    counts: torch.Tensor  # (T,) int32 instances per tile
    gid_hist: torch.Tensor  # (N,) int32 surviving instances per gaussian
    num_instances: int  # K


def pair_residues(r: np.ndarray, chunk: int):
    """The optimal pairing of per-tile residues ``r`` (T,) into tail chunks
    (binning.py:711-760): sort residues descending (stable in tile order);
    m pairs are feasible iff the 2m smallest pair up in reverse order, a
    certificate monotone in m, so a binary search finds the largest count
    M. The R - 2M largest residues get chunks alone (chunk id = rank);
    rank j in [R - M, R) is the B segment of its mirror R - 1 - j.
    Returns (rank order of tiles, chunk id per rank, B-role per rank,
    residue count R, tail chunks used)."""
    t_len = r.shape[0]
    order = np.argsort(np.where(r > 0, -r, 1), kind="stable")
    rs = r[order]
    big_r = int((r > 0).sum())

    def feasible(m):
        i = np.arange(m)
        return bool(np.all(rs[big_r - 2 * m + i] + rs[big_r - 1 - i] <= chunk))

    lo, hi = 0, big_r // 2
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if feasible(mid) else (lo, mid - 1)
    used_t = big_r - lo
    i = np.arange(t_len)
    cid = np.where(i < used_t, i, big_r - 2 * lo + (big_r - 1 - i))
    role_b = (i >= used_t) & (i < big_r)
    return order, cid, role_b, big_r, used_t


def bin_gaussians_split(
    proj: Projected,
    cam: Camera,
    cfg: RasterConfig,
    opacities: torch.Tensor | None = None,
    depth_cap: torch.Tensor | None = None,
) -> BinnedSplit:
    """Split-stream binning (see ``BinnedSplit``): the same expansion, cull
    and sort as the aligned layout; only the placement differs. The
    per-tile tables (T entries) are built on the host, the K-sized stream
    is gathered on the device."""
    chunk = cfg.chunk
    sorted_gid, counts_t, gid_hist = _expand_sorted(proj, cam, opacities,
                                                    depth_cap)
    dev = sorted_gid.device
    counts = counts_t.cpu().numpy().astype(np.int64)
    t_len = counts.shape[0]
    starts = np.cumsum(counts) - counts
    q, r = counts // chunk, counts % chunk

    # interior: tile t's whole chunks at chunk index ioff[t] onward
    ioff = np.cumsum(q) - q
    itile = np.repeat(np.arange(t_len), q)
    first = np.ones(itile.shape[0], bool)
    first[1:] = itile[1:] != itile[:-1]
    imeta = (itile << 1) | first
    isrc = starts[itile] + (np.arange(itile.shape[0]) - ioff[itile]) * chunk
    int_ranges = np.stack([ioff, ioff + q], axis=-1) * chunk

    # tail: A and B segment (tile, residue, has_interior, stream source)
    order, cid, role_b, big_r, used_t = pair_residues(r, chunk)
    vals = np.stack([order, r[order], q[order] > 0,
                     starts[order] + q[order] * chunk], axis=-1)
    seg = np.zeros((2, used_t, 4), np.int64)
    a_rank = np.arange(t_len) < big_r
    a_rank &= ~role_b
    seg[0, cid[a_rank]] = vals[a_rank]
    seg[1, cid[role_b]] = vals[role_b]
    a, b = seg
    has_b = b[:, 1] > 0
    tmeta = (a[:, 0] << 1) | a[:, 2]
    tbt = (np.where(has_b, b[:, 0], a[:, 0]) << 1) | np.where(has_b, b[:, 2],
                                                              a[:, 2])
    send = a[:, 1]
    lim = send + np.where(has_b, b[:, 1], 0)

    mask_a = np.zeros(t_len, bool)
    mask_a[order[a_rank]] = True
    mask_b = np.zeros(t_len, bool)
    mask_b[order[role_b]] = True
    tail_cid = np.zeros(t_len, np.int64)
    tail_role = np.zeros(t_len, np.int64)
    ranked = order[:big_r]
    tail_cid[ranked] = cid[:big_r]
    tail_role[ranked] = role_b[:big_r]

    # the split gid stream: one (send, lim, source A, source B) row per chunk
    table = torch.as_tensor(np.concatenate([
        np.stack([np.full_like(isrc, chunk), np.full_like(isrc, chunk), isrc,
                  np.zeros_like(isrc)], axis=-1),
        np.stack([send, lim, a[:, 3], b[:, 3] - send], axis=-1),
    ]).reshape(-1, 4), device=dev)
    j = torch.arange(chunk, device=dev)
    src = torch.where(j < table[:, :1], table[:, 2:3] + j, table[:, 3:4] + j)
    valid = j < table[:, 1:2]
    src = torch.where(valid, src, torch.zeros_like(src))
    gid = sorted_gid[src] if sorted_gid.numel() else src.to(torch.int32)
    gid = torch.where(valid, gid, torch.zeros_like(gid)).reshape(-1)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev).to(
            torch.int32)

    return BinnedSplit(
        sorted_gid=gid.to(torch.int32).contiguous(),
        chunk_meta=i32(imeta),
        int_ranges=i32(int_ranges.reshape(t_len, 2)),
        tmeta=i32(tmeta),
        tsl=i32((send << 16) | lim),
        tbt=i32(tbt),
        mask_int=torch.as_tensor(q > 0, device=dev),
        mask_a=torch.as_tensor(mask_a, device=dev),
        mask_b=torch.as_tensor(mask_b, device=dev),
        tail_cid=i32(tail_cid),
        tail_role=i32(tail_role),
        counts=counts_t.to(torch.int32),
        gid_hist=gid_hist,
        num_instances=int(sorted_gid.shape[0]),
    )


def _expand_sorted(proj: Projected, cam: Camera, opacities, depth_cap):
    """Expand, cull and sort the (gaussian, tile) instances of a view.
    Returns (sorted_gid (K,) int32, counts (T,) int64, gid_hist (N,) int32).

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
    return (gid[order].to(torch.int32),
            torch.bincount(tile_id, minlength=num_tiles),
            torch.bincount(gid, minlength=n).to(torch.int32))


def bin_gaussians_csr(
    proj: Projected,
    cam: Camera,
    cfg: RasterConfig,
    opacities: torch.Tensor | None = None,
    depth_cap: torch.Tensor | None = None,
) -> Binned | BinnedSplit:
    """Bin a view in the layout ``cfg.layout`` names (see
    ``_expand_sorted`` for the cull and the sort): ``"split"`` dispatches to
    ``bin_gaussians_split``, as in JAX (binning.py:882-883)."""
    if cfg.layout == "split":
        return bin_gaussians_split(proj, cam, cfg, opacities, depth_cap)
    if cfg.layout != "aligned":
        raise ValueError(f"unknown raster layout {cfg.layout!r}")
    sorted_gid, counts, gid_hist = _expand_sorted(proj, cam, opacities,
                                                  depth_cap)
    ends = torch.cumsum(counts, 0)
    ranges = torch.stack([ends - counts, ends], dim=-1).to(torch.int32)
    return Binned(
        sorted_gid=sorted_gid,
        ranges=ranges,
        counts=counts.to(torch.int32),
        gid_hist=gid_hist,
        num_instances=int(sorted_gid.shape[0]),
    )
