"""The 3-sigma pair count equals a brute-force count on a tiny scene."""
import math

import numpy as np
import torch

from benchmark.reference import render as R


def test_pair_count_brute_force():
    g = torch.Generator().manual_seed(3)
    n, w, h = 300, 70, 45
    pts = torch.randn(n, 3, generator=g) * torch.tensor([1.0, 0.6, 0.4]) + torch.tensor([0, 0, 3.0])
    pts[:5, 2] = -1.0  # behind the camera: culled
    scales = torch.rand(n, 3, generator=g) * 0.08 + 0.005
    rots = R.unit(torch.randn(n, 4, generator=g))
    k = np.array([[50.0, 0, 34.5], [0, 50.0, 22.0], [0, 0, 1]])
    cam = R.make_cam(w, h, k, np.eye(4), "cpu")
    proj = R.project(pts, scales, rots, cam)
    gx, gy = cam.grid
    brute = 0
    for i in range(n):
        if pts[i, 2] <= 0.001:
            continue
        a, b, c = (float(x) for x in proj.conic[i])
        det_inv = a * c - b * b
        ca, cb, cc = c / det_inv, -b / det_inv, a / det_inv  # the 2D covariance
        mid = 0.5 * (ca + cc)
        lam = mid + math.sqrt(max(mid * mid - (ca * cc - cb * cb), 0.1))
        r = math.ceil(3 * math.sqrt(lam))
        mx, my = (float(x) for x in proj.means2d[i])
        for ty in range(gy):
            for tx in range(gx):
                x0, y0 = tx * 16, ty * 16
                # the tile rectangle of the reference rasterizer's getRect
                if (math.floor((mx - r) / 16) <= tx < math.floor((mx + r + 15) / 16)
                        and math.floor((my - r) / 16) <= ty < math.floor((my + r + 15) / 16)):
                    brute += 1
    assert brute > 0
    assert R.count_pairs(proj) == brute
    gid, tile = R.tile_pairs(proj, cam)
    assert gid.shape[0] == brute
    assert bool((tile[1:] >= tile[:-1]).all())
