"""The work an iteration needs, counted from the map and the camera, and
the card's peaks: the yardstick of the roofline and ``mfu`` metrics.

A render is counted from the 3-sigma tile rectangles of the reference
rasterizer (``benchmark.reference.render.count_pairs``): every (Gaussian,
tile) pair times the 256 pixels of the tile, whatever culling the program
does. Per pixel pair the forward and the backward take the f32 operation
counts below (exp counted as one). Bytes count each input read once and
each output written once. Preprocess and Adam add a fixed count per
Gaussian and iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import render as R
from benchmark.reference import slam as RS

# NVIDIA H100 SXM data sheet, at the 700 W limit: f32 outside the tensor
# cores (where the compositing kernels do their arithmetic), HBM bandwidth
F32_PEAK_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
NPIX = 256
# f32 operations per (pixel, instance) pair: the forward's alpha 16, the
# transmittance test and weight 4, the median-depth crossing 2, then 2 per
# feature channel for the blend; the backward's replay of alpha and the
# test 19, then 2 per channel for its colour term, the suffix, dalpha,
# d/dopacity and dpower 12, the five geometry rows 16, the crossing 2, the
# feature rows 1 per channel and the per-pixel sum of each gradient row
# 7 + 1 per channel (frozen here from the port's kernel bounds)
FWD_OPS = (22, 2)
BWD_OPS = (56, 4)
FEATS = 6  # RGB, depth, silhouette, depth^2, rendered together
GRAD_FEATS = 4  # the loss's cotangents: RGB and depth
# per Gaussian and iteration: projection, covariances, conic and radius
# (~150), their backward (~300), Adam over the isotropic map's 12 values
# (~150)
GAUSSIAN_OPS = 600
ROWS = 16  # the attribute table's f32 entries per Gaussian


def render_cost(pairs: int, gaussians: int, width: int, height: int,
                backward: bool):
    """(operations, least seconds) of one render of ``pairs`` (Gaussian,
    tile) pairs, with its backward when ``backward``; the least time is
    taken per kernel, forward and backward, as bytes or operations
    bound it."""
    tiles = ((width + 15) // 16) * ((height + 15) // 16)
    block = tiles * 8 * NPIX * 4  # one (tiles, 8, 256) f32 block
    common = gaussians * ROWS * 4 + pairs * 4 + tiles * 2 * 4
    f_ops = pairs * NPIX * (FWD_OPS[0] + FWD_OPS[1] * FEATS)
    f_s = max((common + 2 * block) / HBM_BYTES_S, f_ops / F32_PEAK_FLOPS)
    if not backward:
        return f_ops, f_s
    b_ops = pairs * NPIX * (BWD_OPS[0] + BWD_OPS[1] * GRAD_FEATS)
    b_s = max((common + 4 * block + gaussians * ROWS * 4) / HBM_BYTES_S,
              b_ops / F32_PEAK_FLOPS)
    return f_ops + b_ops, f_s + b_s


@torch.no_grad()
def pairs_at(g: dict, c2w, k, width: int, height: int) -> int:
    """The (Gaussian, tile) pairs of the map ``g`` seen from the
    camera-to-world pose ``c2w`` with intrinsics ``k``."""
    dev = g["means3D"].device
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    q = RS.rotation_quaternion(w2c[:3, :3]).to(dev)
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    pts = g["means3D"] @ w2c[:3, :3].T + w2c[:3, 3]
    rots = R.unit(RS.quat_mult(q[None], R.unit(g["unnorm_rotations"])))
    proj = R.project(pts, torch.exp(g["log_scales"]).expand(-1, 3), rots,
                     R.make_cam(width, height, k, np.eye(4), dev))
    return R.count_pairs(proj)
