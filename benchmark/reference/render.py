"""Plain reference of the Gaussian-splatting render SplaTAM optimises.

Written from the published algorithm (the reference CUDA rasterizer's
preprocess and tile compositing, `diff-gaussian-rasterization`
forward.cu / backward.cu), in plain PyTorch with autograd, and sharing no
code with the program: EWA projection with the field-of-view clamp 1.3
tan(fov) and the +0.3 low-pass, radius ceil(3 sqrt(lambda_max)) and its
tile rectangle, a per-tile depth sort, front-to-back alpha compositing
with the alpha cap 0.99 and floor 1/255, and a pixel that stops where its
transmittance would fall below 1e-4.

The compositing runs over blocks of whole tiles (every pair of a tile's
list with every pixel of the tile), so that a render of a million
Gaussians at 1296x968 fits in a few GiB; its backward recomputes each
block under autograd. ``dtype`` is the precision of the whole
computation: float32 for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

TILE = 16
NPIX = TILE * TILE
ALPHA_CAP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
# pixel pairs (tile pixel x instance) per block of the compositing
BLOCK_PAIRS = 1 << 24
# slack, in units of the Gaussian's exponent, of the test that a Gaussian
# reaches alpha 1/255 somewhere in a tile
CULL_EPS = 1e-3


class Cam(NamedTuple):
    """A pinhole camera at a world-to-camera ``view`` (4x4)."""

    width: int
    height: int
    view: torch.Tensor  # (4, 4) float32
    proj: torch.Tensor  # (4, 4) float32: OpenGL projection @ view
    tanfovx: float
    tanfovy: float

    @property
    def grid(self):
        return (self.width + TILE - 1) // TILE, (self.height + TILE - 1) // TILE

    @property
    def focal(self):
        return (self.width / (2.0 * self.tanfovx),
                self.height / (2.0 * self.tanfovy))


def make_cam(width: int, height: int, k: np.ndarray, w2c: np.ndarray,
             device, near: float = 0.01, far: float = 100.0) -> Cam:
    k = np.asarray(k, np.float64)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    gl = np.array([
        [2 * fx / width, 0.0, -(width - 2 * cx) / width, 0.0],
        [0.0, 2 * fy / height, -(height - 2 * cy) / height, 0.0],
        [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
        [0.0, 0.0, 1.0, 0.0]])
    w2c = np.asarray(w2c, np.float64)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Cam(width, height, t(w2c), t(gl @ w2c),
               float(width / (2.0 * fx)), float(height / (2.0 * fy)))


def unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-24))


def rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix, (..., 3, 3)."""
    w, x, y, z = unit(q).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


class Projected(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coordinates, pixel centres integral
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # (N,) view-space z
    rect: torch.Tensor  # (N, 4) int64 tile rectangle x0, y0, x1, y1 (exclusive)
    valid: torch.Tensor  # (N,) bool


def project(pts: torch.Tensor, scales: torch.Tensor, rots: torch.Tensor,
            cam: Cam) -> Projected:
    """EWA projection of Gaussians (``pts`` in the world frame the camera
    ``cam`` looks at; ``scales`` (N, 3); ``rots`` (N, 4))."""
    view, proj = cam.view.to(pts.dtype), cam.proj.to(pts.dtype)
    p_view = pts @ view[:3, :3].T + view[:3, 3]
    z = p_view[:, 2]
    valid = z > 0.001
    p_hom = pts @ proj[:3, :3].T + proj[:3, 3]
    wclip = pts @ proj[3, :3] + proj[3, 3]
    p_w = 1.0 / torch.where(valid, wclip + 1e-7, torch.ones_like(wclip))
    mx = ((p_hom[:, 0] * p_w + 1.0) * cam.width - 1.0) * 0.5
    my = ((p_hom[:, 1] * p_w + 1.0) * cam.height - 1.0) * 0.5
    # 3D covariance R S S^T R^T
    r = rotmat(rots)
    m = r * scales[:, None, :]
    cov3 = m @ m.transpose(1, 2)
    # Jacobian of the perspective map at the clamped view position
    tz = torch.where(valid, z, torch.ones_like(z))
    limx, limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    tx = torch.clamp(p_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -limy, limy) * tz
    fx, fy = cam.focal
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
        torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], -2)
    t = jac @ view[:3, :3]
    cov2 = t @ cov3 @ t.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    valid = valid & (det != 0)
    det_inv = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0))).float()
        gx, gy = cam.grid
        fmx, fmy = mx.detach().float(), my.detach().float()

        def tile(v, hi):
            return torch.clamp(torch.floor(v / TILE), 0, hi).long()

        rect = torch.stack([tile(fmx - radius, gx), tile(fmy - radius, gy),
                            tile(fmx + radius + TILE - 1, gx),
                            tile(fmy + radius + TILE - 1, gy)], -1)
        area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        valid = valid & (area > 0)
    return Projected(torch.stack([mx, my], -1), conic, z, rect, valid)


def tile_pairs(proj: Projected, cam: Cam):
    """Every (Gaussian, tile) pair of the 3-sigma rectangles, sorted by tile
    and, within a tile, by depth (ties by Gaussian index). Returns
    (gid (K,), tile (K,)), int64."""
    rect = proj.rect
    w = (rect[:, 2] - rect[:, 0]).clamp(min=0)
    n = torch.where(proj.valid, w * (rect[:, 3] - rect[:, 1]).clamp(min=0),
                    torch.zeros_like(w))
    gid = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device), n)
    start = torch.cumsum(n, 0) - n
    local = torch.arange(gid.shape[0], device=n.device) - start[gid]
    wg = w[gid]
    tx = rect[gid, 0] + local % wg
    ty = rect[gid, 1] + local // wg
    tile = ty * cam.grid[0] + tx
    order = torch.sort(proj.depth.detach().float()[gid], stable=True).indices
    gid, tile = gid[order], tile[order]
    order = torch.sort(tile, stable=True).indices
    return gid[order], tile[order]


@torch.no_grad()
def cull(gid, tile, proj: Projected, opac, cam: Cam):
    """Keep the pairs whose Gaussian reaches alpha 1/255 somewhere in the
    tile's box of pixel centres: the exponent's least value over the box
    (zero where the mean lies inside it, else the least over its four
    edges) against log(opacity * 255), with CULL_EPS of slack."""
    m2 = proj.means2d.detach().float()[gid]
    ca, cb, cc = proj.conic.detach().float()[gid].unbind(-1)
    gx = cam.grid[0]
    x_lo = ((tile % gx) * TILE).float() - m2[:, 0]
    y_lo = ((tile // gx) * TILE).float() - m2[:, 1]
    x_hi, y_hi = x_lo + (TILE - 1), y_lo + (TILE - 1)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def along_x(dx):  # dx fixed, dy over [y_lo, y_hi]
        return q(dx, torch.clamp(-cb * dx / cc, min=y_lo, max=y_hi))

    def along_y(dy):
        return q(torch.clamp(-cb * dy / ca, min=x_lo, max=x_hi), dy)

    inside = (x_lo <= 0) & (x_hi >= 0) & (y_lo <= 0) & (y_hi >= 0)
    least = torch.minimum(torch.minimum(along_x(x_lo), along_x(x_hi)),
                          torch.minimum(along_y(y_lo), along_y(y_hi)))
    least = torch.where(inside, torch.zeros_like(least), least)
    room = torch.log(torch.clamp(opac.detach().float(), min=1e-30))[gid] \
        - math.log(ALPHA_MIN) + CULL_EPS
    keep = ~(least > room)
    return gid[keep], tile[keep]


def count_pairs(proj: Projected) -> int:
    """The number of (Gaussian, tile) pairs of the 3-sigma rectangles."""
    rect = proj.rect
    area = ((rect[:, 2] - rect[:, 0]).clamp(min=0)
            * (rect[:, 3] - rect[:, 1]).clamp(min=0))
    return int(torch.where(proj.valid, area, torch.zeros_like(area)).sum())


def _plan(tile: torch.Tensor, num_tiles: int):
    """Blocks of tiles, longest lists first: [(tiles (B,), list length L)]
    with B * NPIX * L at most BLOCK_PAIRS (at least one tile each)."""
    counts = torch.bincount(tile, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(counts, descending=True, stable=True).indices
    c_host = counts[order].tolist()
    blocks, i = [], 0
    while i < num_tiles and c_host[i] > 0:
        length = c_host[i]
        j = min(num_tiles, i + max(1, BLOCK_PAIRS // (NPIX * length)))
        while c_host[j - 1] == 0:
            j -= 1
        blocks.append((order[i:j], length))
        i = j
    return counts, starts, blocks


def _composite_rows(tiles, gx, m2, con, op, feat):
    """Composite one block of tiles from its rows, each (B, L, ...) in
    depth order (padding rows have opacity 0). Returns color (B, NPIX, F)
    and final transmittance (B, NPIX)."""
    p = torch.arange(NPIX, device=tiles.device)
    px = ((tiles % gx)[:, None] * TILE + p % TILE).to(m2.dtype)
    py = ((tiles // gx)[:, None] * TILE + p // TILE).to(m2.dtype)
    dx = m2[:, None, :, 0] - px[:, :, None]
    dy = m2[:, None, :, 1] - py[:, :, None]
    ca, cb, cc = (con[:, None, :, i] for i in range(3))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op[:, None, :] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_CAP)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    after = torch.cumprod(1.0 - alpha, -1)
    live = after >= T_STOP
    before = torch.cat([torch.ones_like(after[..., :1]), after[..., :-1]], -1)
    wgt = torch.where(live, alpha * before, torch.zeros_like(alpha))
    color = torch.bmm(wgt, feat)
    final_t = torch.where(live, after, torch.ones_like(after)).amin(-1)
    return color, final_t


def _padded(*tabs):
    return [torch.cat([t, t.new_zeros((1,) + t.shape[1:])]) for t in tabs]


class _Composite(torch.autograd.Function):
    """Tile compositing; forward in blocks without a graph, backward by
    recomputing each block under autograd."""

    @staticmethod
    def forward(ctx, m2, con, op, feat, gid, tile, cam_dims):
        width, height = cam_dims
        gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
        nt = gx * gy
        tabs = _padded(m2, con, op, feat)
        counts, starts, blocks = _plan(tile, nt)
        color = feat.new_zeros((nt, NPIX, feat.shape[1]))
        final_t = feat.new_ones((nt, NPIX))
        plan = []
        for tiles, length in blocks:
            j = torch.arange(length, device=gid.device)
            inside = j[None, :] < counts[tiles, None]
            pos = torch.clamp(starts[tiles, None] + j[None, :],
                              max=gid.shape[0] - 1)
            idx = torch.where(inside, gid[pos], torch.full_like(pos, m2.shape[0]))
            c, t = _composite_rows(tiles, gx, *(tab[idx] for tab in tabs))
            color[tiles] = c
            final_t[tiles] = t
            plan.append((tiles, idx))
        ctx.plan, ctx.dims = plan, (gx, gy)
        ctx.save_for_backward(m2, con, op, feat)
        return (_to_image(color, gx, gy, width, height),
                _to_image(final_t[..., None], gx, gy, width, height)[0])

    @staticmethod
    def backward(ctx, g_img, g_t):
        gx, gy = ctx.dims
        g_color = _to_blocks(g_img, gx, gy)
        g_final = _to_blocks(g_t[None], gx, gy)[..., 0]
        tabs = _padded(*ctx.saved_tensors)
        grads = [torch.zeros_like(t) for t in tabs]
        for tiles, idx in ctx.plan:
            rows = [t[idx].detach().requires_grad_() for t in tabs]
            with torch.enable_grad():
                c, t = _composite_rows(tiles, gx, *rows)
                gr = torch.autograd.grad([c, t], rows,
                                         [g_color[tiles], g_final[tiles]])
            flat = idx.reshape(-1)
            for acc, g in zip(grads, gr):
                acc.index_add_(0, flat, g.reshape((-1,) + g.shape[2:]))
        return (*(g[:-1] for g in grads), None, None, None)


def _to_image(blocks, gx, gy, width, height):
    """(T, NPIX, F) tile blocks -> (F, H, W) image."""
    f = blocks.shape[-1]
    img = blocks.reshape(gy, gx, TILE, TILE, f).permute(4, 0, 2, 1, 3)
    return img.reshape(f, gy * TILE, gx * TILE)[:, :height, :width]


def _to_blocks(img, gx, gy):
    """(F, H, W) image -> (T, NPIX, F) tile blocks, zero past the edges."""
    f, h, w = img.shape
    full = img.new_zeros((f, gy * TILE, gx * TILE))
    full[:, :h, :w] = img
    return full.reshape(f, gy, TILE, gx, TILE).permute(1, 3, 2, 4, 0) \
        .reshape(gy * gx, NPIX, f)


def bin_view(proj: Projected, opac, cam: Cam):
    """The tile lists of a view: the 3-sigma pairs the Gaussian reaches
    alpha 1/255 in, by tile and depth. (gid, tile)."""
    gid, tile = tile_pairs(proj, cam)
    return cull(gid, tile, proj, opac, cam)


def render(pts, scales, rots, opac, feats, cam: Cam, binning=None):
    """Render Gaussians (world-frame ``pts`` for ``cam``) with per-Gaussian
    features ``feats`` (N, F): every tile composites its list in order.
    ``binning`` (gid, tile) gives the lists, made at another pose or state
    of the same Gaussians (frozen binning); by default they are made here.
    Returns (image (F, H, W), final T (H, W), the projection, the
    binning). Differentiable in every tensor input."""
    proj = project(pts, scales, rots, cam)
    op = torch.where(proj.valid, opac, torch.zeros_like(opac))
    if binning is None:
        binning = bin_view(proj, op, cam)
    gid, tile = binning
    img, final_t = _Composite.apply(proj.means2d, proj.conic, op, feats, gid,
                                    tile, (cam.width, cam.height))
    return img, final_t, proj, binning


def ssim(img1: torch.Tensor, img2: torch.Tensor, window: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of (C, H, W) images: a Gaussian window, zero padding."""
    c = img1.shape[0]
    g = torch.tensor([math.exp(-((x - window // 2) ** 2) / (2 * sigma ** 2))
                      for x in range(window)], dtype=img1.dtype,
                     device=img1.device)
    g = g / g.sum()
    win = (g[:, None] @ g[None, :]).expand(c, 1, window, window)

    def conv(x):
        return torch.nn.functional.conv2d(x[None], win, padding=window // 2,
                                          groups=c)[0]

    mu1, mu2 = conv(img1), conv(img2)
    s11 = conv(img1 * img1) - mu1 * mu1
    s22 = conv(img2 * img2) - mu2 * mu2
    s12 = conv(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()
