"""The benchmark's RGB-D sequence, made on the device from a seed.

A textured scene of two surfaces, ray-cast exactly per pixel: a back wall
at ``wall_z`` metres with a sinusoidal relief, and a tilted panel in front
of it (the two textured planes of ``splatam_torch/data/synthetic.py``,
rewritten so that every frame is computed on the device in a few batched
calls instead of rendered from Gaussians). The wall is unbounded, so every
pixel has a valid depth and frame 0 back-projects every pixel, as a
Replica frame does. The camera follows synthetic.py's smooth path: a
translation of about a centimetre and a yaw of about a third of a degree
per frame at ``period`` frames per cycle.

The seed sets the textures' phases and the phase of the wall's relief
only: every seed gives the same sizes, the same path and the same
surfaces up to their relief, so the amount of work does not depend on it.

``Sequence[t] -> (color HxWx3 in [0, 255], depth HxWx1, K 4x4, c2w 4x4)``,
numpy float32 on the host: the loader contract of the program's datasets.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def camera_matrix(cam: dict) -> np.ndarray:
    """The 3x3 intrinsics of a configuration's ``camera`` entry."""
    return np.array([[cam["fx"], 0.0, cam["cx"]],
                     [0.0, cam["fy"], cam["cy"]],
                     [0.0, 0.0, 1.0]], dtype=np.float64)


def path_poses(motion: dict, frames: int, phase: float) -> np.ndarray:
    """(frames, 4, 4) float64 camera-to-world poses along the path,
    relative to the first (so pose 0 is the identity)."""
    poses = np.zeros((frames, 4, 4))
    for t in range(frames):
        s = t / motion["period"] + phase
        yaw = motion["yaw"] * math.sin(2 * math.pi * s)
        c, si = math.cos(yaw), math.sin(yaw)
        poses[t] = np.eye(4)
        poses[t, :3, :3] = [[c, 0, si], [0, 1, 0], [-si, 0, c]]
        poses[t, :3, 3] = [motion["tx"] * math.sin(2 * math.pi * s),
                           motion["ty"] * math.sin(4 * math.pi * s),
                           motion["tz"] * (s - phase)]
    inv0 = np.linalg.inv(poses[0])
    rel = np.einsum("ij,tjk->tik", inv0, poses)
    rel[0] = np.eye(4)
    return rel, poses


def _texture(x, y, freq, ph):
    """Three smooth colour channels plus a finer pattern, in [0, 1]."""
    f1, f2, f3, fine = freq
    r = 0.5 + 0.35 * torch.sin(f1 * x + ph[0]) * torch.cos(f2 * y + ph[1])
    g = 0.5 + 0.35 * torch.cos(f2 * x + f3 * y + ph[2])
    b = 0.5 + 0.35 * torch.sin(f3 * y + ph[3])
    d = 0.15 * torch.sin(fine * x + ph[4]) * torch.sin(fine * y + ph[5])
    return torch.stack([r + d, g - d, b + d], -1).clamp(0.0, 1.0)


def render_frames(scene: dict, cam: dict, c2w: torch.Tensor,
                  ph: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ray-cast a batch of frames. ``c2w`` (B, 4, 4) absolute poses on the
    device, ``ph`` (12,) texture phases. Returns color (B, H, W, 3) in
    [0, 255] and depth (B, H, W, 1), float32."""
    dev = c2w.device
    h, w = cam["height"], cam["width"]
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                          torch.arange(w, device=dev, dtype=torch.float32),
                          indexing="ij")
    d_cam = torch.stack([(u - cam["cx"]) / cam["fx"],
                         (v - cam["cy"]) / cam["fy"], torch.ones_like(u)], -1)
    rot, org = c2w[:, :3, :3], c2w[:, :3, 3]
    d = torch.einsum("bij,hwj->bhwi", rot, d_cam)  # world ray per unit depth
    o = org[:, None, None, :]
    dx, dy, dz = d.unbind(-1)
    ox, oy, oz = o.unbind(-1)
    # the wall z = z0 + a sin(kx x + p) sin(ky y + q): a fixed point in the
    # camera depth s (a contraction while a k |dx / dz| < 1)
    wall = scene["wall"]
    s = (wall["z"] - oz) / dz
    for _ in range(wall["iterations"]):
        x, y = ox + s * dx, oy + s * dy
        relief = wall["a"] * torch.sin(wall["k"] * x + ph[10]) \
            * torch.sin(wall["k"] * y + ph[11])
        s = (wall["z"] + relief - oz) / dz
    x, y = ox + s * dx, oy + s * dy
    color = _texture(x, y, wall["freq"], ph[0:6])
    depth = s
    # the panel: z = z0 + gx (x - x0) + gy y, a rectangle about (x0, 0)
    pan = scene["panel"]
    denom = dz - pan["gx"] * dx - pan["gy"] * dy
    sp = (pan["z"] + pan["gx"] * (ox - pan["x0"]) + pan["gy"] * oy - oz) / denom
    px, py = ox + sp * dx, oy + sp * dy
    hit = ((sp > 0) & (sp < s) & ((px - pan["x0"]).abs() <= pan["half_w"])
           & (py.abs() <= pan["half_h"]))
    pcol = _texture(px, py, pan["freq"], ph[6:12])
    color = torch.where(hit[..., None], pcol, color)
    depth = torch.where(hit, sp, depth)
    return color * 255.0, depth[..., None]


class Sequence:
    """``frames`` frames of the scene for one seed, kept on the device;
    indexing copies one to the host, as a loader hands it over."""

    def __init__(self, scene: dict, motion: dict, cam: dict, frames: int,
                 seed: int, device, batch: int = 16):
        rng = np.random.default_rng(seed)
        tex_ph = rng.uniform(0.0, 2 * math.pi, 12)
        self.k = camera_matrix(cam)
        self.poses, absolute = path_poses(motion, frames, motion["phase"])
        dev = torch.device(device)
        ph = torch.as_tensor(tex_ph, dtype=torch.float32, device=dev)
        c2w = torch.as_tensor(absolute, dtype=torch.float32, device=dev)
        colors, depths = [], []
        for b0 in range(0, frames, batch):
            c, d = render_frames(scene, cam, c2w[b0:b0 + batch], ph)
            colors.append(c)
            depths.append(d)
        self.color = torch.cat(colors)  # (F, H, W, 3) in [0, 255]
        self.depth = torch.cat(depths)  # (F, H, W, 1)
        k4 = np.eye(4)
        k4[:3, :3] = self.k
        self._k4 = k4.astype(np.float32)

    def __len__(self):
        return self.color.shape[0]

    def __getitem__(self, t):
        if not 0 <= t < len(self):
            raise IndexError(
                f"the sequence has {len(self)} frames and frame {t} was asked "
                "for: the run outlasted the frames made ahead")
        return (self.color[t].cpu().numpy(), self.depth[t].cpu().numpy(),
                self._k4, self.poses[t].astype(np.float32))

    def frame(self, t):
        """Frame ``t`` on the device as the loader's arrays become the
        program's (3, H, W) in [0, 1] and (1, H, W): the division by 255 is
        numpy's on the host arrays, so both sides see the same bits."""
        color, depth = self.color[t].cpu().numpy(), self.depth[t].cpu().numpy()
        im = (np.transpose(color, (2, 0, 1)) / 255.0).astype(np.float32)
        d = np.transpose(depth, (2, 0, 1)).astype(np.float32)
        dev = self.color.device
        return torch.as_tensor(im, device=dev), torch.as_tensor(d, device=dev)
