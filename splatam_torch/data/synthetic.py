"""Procedural RGB-D sequence for tests and benchmarks.

Counterpart of ``splatam_tpu/data/synthetic.py``: a textured two-plane
Gaussian scene, rendered with the port's own ``rasterize_tiled`` along a
slowly moving camera. ``dataset[idx] -> (color HxWx3 [0..255], depth HxWx1,
intrinsics 4x4, c2w)``, the gradslam loader contract.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_torch.device import resolve_device
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import replace_pose, setup_camera
from splatam_torch.render.render_tiled import rasterize_tiled


def _wall(rng, nx, ny, z, extent, color_fn, jitter=0.02):
    xs = np.linspace(-extent, extent, nx)
    ys = np.linspace(-extent * 0.75, extent * 0.75, ny)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack(
        [gx.ravel(), gy.ravel(),
         np.full(gx.size, z) + rng.normal(0, jitter, gx.size)],
        axis=-1,
    )
    return pts.astype(np.float32), color_fn(pts).astype(np.float32)


class SyntheticDataset:
    """A textured two-plane scene observed by a slowly moving camera."""

    def __init__(self, num_frames: int = 20, width: int = 128,
                 height: int = 96, seed: int = 0, motion_scale: float = 1.0,
                 device=None):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.w, self.h = width, height
        f = width * 0.9
        self.k = np.array(
            [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], dtype=np.float64
        )

        def tex1(p):
            return np.stack(
                [
                    0.5 + 0.5 * np.sin(3.1 * p[:, 0]) * np.cos(2.3 * p[:, 1]),
                    0.5 + 0.5 * np.cos(2.7 * p[:, 0] + 1.0),
                    0.5 + 0.5 * np.sin(1.9 * p[:, 1] + 0.5),
                ],
                axis=-1,
            )

        def tex2(p):
            return np.stack(
                [
                    0.5 + 0.5 * np.cos(5.0 * p[:, 0]),
                    0.3 + 0.3 * np.sin(4.0 * p[:, 1]),
                    0.6 + 0.4 * np.sin(2.0 * (p[:, 0] + p[:, 1])),
                ],
                axis=-1,
            )

        p1, c1 = _wall(rng, 48, 36, 3.0, 2.2, tex1)
        p2, c2 = _wall(rng, 24, 18, 2.0, 0.7, tex2)
        p2[:, 0] += 0.4
        self.means = np.concatenate([p1, p2])
        self.colors = np.concatenate([c1, c2])
        n = self.means.shape[0]
        self.opac = np.full(n, 0.98, np.float32)
        spacing = 2 * 2.2 / 48
        self.scales = np.full((n, 3), spacing * 0.7, np.float32)
        self.quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))

        # smooth translation + small yaw; inter-frame deltas ~1 cm / ~0.1 deg
        self.poses = []
        for t in range(num_frames):
            s = motion_scale * t / 50.0
            yaw = 0.05 * np.sin(2 * np.pi * s)
            c2w = np.eye(4)
            c2w[:3, :3] = np.array(
                [
                    [np.cos(yaw), 0, np.sin(yaw)],
                    [0, 1, 0],
                    [-np.sin(yaw), 0, np.cos(yaw)],
                ]
            )
            c2w[:3, 3] = [0.10 * np.sin(2 * np.pi * s),
                          0.05 * np.sin(4 * np.pi * s), 0.10 * s]
            self.poses.append(c2w)
        inv0 = np.linalg.inv(self.poses[0])
        self.poses = [inv0 @ p for p in self.poses]

        # stands in for the JAX dataset's backend="jnp" renders, which have
        # no stream layout: any layout renders the same frames
        self._cfg = RasterConfig(chunk=64, layout="aligned")
        self._cam0 = setup_camera(width, height, self.k, np.eye(4),
                                  device=self.device)
        self._cache = {}

    def __len__(self):
        return len(self.poses)

    @torch.no_grad()
    def __getitem__(self, idx):
        if idx in self._cache:
            return self._cache[idx]
        cam = replace_pose(self._cam0, self.k, np.linalg.inv(self.poses[idx]))
        out, _ = rasterize_tiled(
            self.means, self.colors, self.opac, self.scales, self.quats, cam,
            cfg=self._cfg, device=self.device,
        )
        color = np.clip(out.color.cpu().numpy(), 0, 1).transpose(1, 2, 0) * 255.0
        depth = out.depth.cpu().numpy()[0]
        # hole pixels (nothing hit) -> invalid depth 0
        depth = np.where(out.final_t.cpu().numpy() > 0.5, 0.0, depth)[..., None]
        k4 = np.eye(4)
        k4[:3, :3] = self.k
        item = (
            color.astype(np.float32),
            depth.astype(np.float32),
            k4.astype(np.float32),
            self.poses[idx].astype(np.float32),
        )
        self._cache[idx] = item
        return item
