"""Plain reference of SplaTAM's steps: the first map, tracking's and
mapping's losses and Adam steps, pruning and the densification mask.

Follows SplaTAM (`scripts/splatam.py`: `get_pointcloud`,
`initialize_params`, `get_loss`, `add_new_gaussians`, `prune_gaussians`)
and torch's Adam, in plain PyTorch on this package's ``render``; it imports
nothing of the program. ``dtype`` is the precision everything is computed
in: float32 for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.render import Cam, render, rotmat, ssim, unit

GAUSS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities",
         "log_scales")


def backproject(color, depth, k, w2c, mask=None):
    """Pixels to world points, colours and projective squared scales
    ((z / f)^2, f the mean focal length): (points (M, 3), colours (M, 3),
    msd (M,)). ``color`` (3, H, W) in [0, 1], ``depth`` (1, H, W)."""
    _, h, w = color.shape
    dev, dt = color.device, color.dtype
    fx, fy, cx, cy = (float(k[0][0]), float(k[1][1]), float(k[0][2]),
                      float(k[1][2]))
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=dt),
                            torch.arange(w, device=dev, dtype=dt),
                            indexing="ij")
    z = depth[0].reshape(-1)
    pc = torch.stack([((xx - cx) / fx).reshape(-1) * z,
                      ((yy - cy) / fy).reshape(-1) * z, z], -1)
    c2w = torch.as_tensor(np.linalg.inv(np.asarray(w2c, np.float64)),
                          dtype=dt, device=dev)
    pts = pc @ c2w[:3, :3].T + c2w[:3, 3]
    cols = color.reshape(3, -1).T
    msd = (z / ((fx + fy) / 2)) ** 2
    if mask is None:
        mask = z > 0
    return pts[mask], cols[mask], msd[mask]


def new_gaussians(pts, cols, msd, isotropic=True):
    """SplaTAM's initial values of Gaussians at ``pts``."""
    m = pts.shape[0]
    ls = torch.log(torch.sqrt(torch.clamp(msd, min=1e-12)))[:, None]
    return {
        "means3D": pts, "rgb_colors": cols,
        "unnorm_rotations": torch.tensor([1.0, 0, 0, 0], dtype=pts.dtype,
                                         device=pts.device).expand(m, 4).clone(),
        "logit_opacities": pts.new_zeros((m, 1)),
        "log_scales": ls if isotropic else ls.expand(m, 3).clone(),
    }


def quat_mult(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def render_at(g, rot, tran, cam: Cam, binning=None):
    """The six-channel render (RGB, depth, silhouette, depth^2) of
    Gaussians ``g`` at the camera pose (``rot`` unnormalised quaternion,
    ``tran``) relative to ``cam``, on ``binning``'s tile lists if given.
    Returns (image (6, H, W), final T, projection, binning)."""
    q = unit(rot)
    pts = g["means3D"] @ rotmat(q).T + tran
    iso = g["log_scales"].shape[1] == 1
    rots = g["unnorm_rotations"] if iso else quat_mult(q[None], unit(g["unnorm_rotations"]))
    scales = torch.exp(g["log_scales"]).expand(-1, 3)
    view = cam.view.to(pts.dtype)
    z = pts @ view[2, :3] + view[2, 3]
    feats = torch.cat([g["rgb_colors"],
                       torch.stack([z, torch.ones_like(z), z * z], -1)], -1)
    opac = torch.sigmoid(g["logit_opacities"][:, 0])
    return render(pts, scales, unit(rots), opac, feats, cam, binning)


def tracking_loss(img, gt_im, gt_depth, cfg):
    """SplaTAM's tracking loss: per-pixel sums over the silhouette mask
    (and, with ``ignore_outlier_depth_loss``, the median-error mask)."""
    depth, sil = img[3], img[4]
    unc = (img[5] - depth * depth).detach()
    gd = gt_depth[0]
    with torch.no_grad():
        err = (gd - depth).abs() * (gd > 0)
        mask = gd > 0
        if cfg["ignore_outlier_depth_loss"]:
            s = torch.sort(err.reshape(-1).float()).values
            n = s.shape[0]
            med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
            mask = mask & (err < 10.0 * med)
        mask = mask & ~torch.isnan(depth) & ~torch.isnan(unc)
        if cfg["use_sil_for_loss"]:
            mask = mask & (sil > cfg["sil_thres"])
        m = mask.to(img.dtype)
    l_depth = ((gd - depth).abs() * m).sum()
    l_im = ((gt_im - img[:3]).abs() * m).sum()
    w = cfg["loss_weights"]
    return w["im"] * l_im + w["depth"] * l_depth


def mapping_loss(img, gt_im, gt_depth, cfg):
    """SplaTAM's mapping loss: mean depth L1 over valid depth, and
    0.8 L1 + 0.2 (1 - SSIM) on RGB."""
    depth = img[3]
    unc = (img[5] - depth * depth).detach()
    gd = gt_depth[0]
    with torch.no_grad():
        mask = (gd > 0) & ~torch.isnan(depth) & ~torch.isnan(unc)
        m = mask.to(img.dtype)
    l_depth = ((gd - depth).abs() * m).sum() / torch.clamp(m.sum(), min=1)
    l_im = 0.8 * (img[:3] - gt_im).abs().mean() + 0.2 * (1 - ssim(img[:3], gt_im))
    w = cfg["loss_weights"]
    return w["im"] * l_im + w["depth"] * l_depth


class Adam:
    """torch's Adam with one step count: eps outside the square root."""

    def __init__(self, params, lrs, eps, b1=0.9, b2=0.999):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.lrs, self.eps, self.b1, self.b2, self.t = lrs, eps, b1, b2, 0

    @torch.no_grad()
    def step(self, params, grads, lrs=None):
        lrs = self.lrs if lrs is None else lrs
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            p -= lrs[k] * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                                     + self.eps)

    def keep(self, rows):
        for d in (self.m, self.v):
            for k in d:
                d[k] = d[k][rows]


def forward_pose(rots, trans):
    """The constant-velocity start from the two previous poses."""
    r1, r2 = unit(rots[1]), unit(rots[0])
    return unit(r1 + (r1 - r2)), trans[1] + (trans[1] - trans[0])


def track_steps(g, rot0, tran0, gt_im, gt_depth, cam, cfg, steps):
    """``steps`` Adam steps of tracking from (rot0, tran0) on the map ``g``,
    the tile lists made every ``rebin_every`` steps (10 unless the
    configuration says otherwise) at the pose then and kept in between
    (frozen binning). Returns (losses, first gradients {rot, tran}, final
    pose {rot, tran})."""
    rebin = cfg.get("rebin_every", 10)
    binning = None
    pose = {"rot": rot0.clone(), "tran": tran0.clone()}
    lrs = {"rot": cfg["lrs"]["cam_unnorm_rots"], "tran": cfg["lrs"]["cam_trans"]}
    opt = Adam(pose, lrs, eps=1e-8)
    g = {k: v.detach() for k, v in g.items()}
    losses, first = [], None
    for i in range(steps):
        leaf = {k: v.detach().requires_grad_() for k, v in pose.items()}
        if not rebin or i % rebin == 0:
            binning = None
        img, _, _, binning = render_at(g, leaf["rot"], leaf["tran"], cam,
                                       binning)
        loss = tracking_loss(img, gt_im, gt_depth, cfg)
        gr = dict(zip(leaf, torch.autograd.grad(loss, list(leaf.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.clone() for k, v in gr.items()}
        opt.step(pose, gr)
    return losses, first, pose


def prune_rows(g, it, prune, scene_radius):
    """The rows SplaTAM's pruning keeps after mapping iteration ``it``
    (None where it keeps every row)."""
    if not (it <= prune["stop_after"] and it >= prune["start_after"]
            and it % prune["prune_every"] == 0):
        return None
    thresh = (prune["final_removal_opacity_threshold"]
              if it == prune["stop_after"] else prune["removal_opacity_threshold"])
    remove = torch.sigmoid(g["logit_opacities"][:, 0]) < thresh
    if it >= prune["remove_big_after"]:
        remove = remove | (torch.exp(g["log_scales"]).amax(1) > 0.1 * scene_radius)
    return None if not bool(remove.any()) else ~remove


def map_steps(g, frames, cam, cfg, scene_radius):
    """Mapping's Adam steps on the map ``g``, one per entry of ``frames``
    ((rot, tran, gt_im, gt_depth, keyframe id) of the keyframe it samples),
    with the pruning between them. A keyframe's tile lists are made at its
    first step and kept for ``rebin_every`` steps (frozen binning), and
    made anew after pruning. Returns (losses, first gradients, final map,
    the indices of the starting rows it kept)."""
    rebin = cfg.get("rebin_every", 10)
    binned = {}  # keyframe id -> (binning, the step it was made at)
    g = {k: v.detach().clone() for k, v in g.items()}
    opt = Adam(g, {k: cfg["lrs"][k] for k in GAUSS}, eps=1e-15)
    kept = torch.arange(g["means3D"].shape[0], device=g["means3D"].device)
    losses, first = [], None
    for it, (rot, tran, gt_im, gt_depth, kf) in enumerate(frames):
        leaf = {k: v.detach().requires_grad_() for k, v in g.items()}
        made = binned.get(kf)
        if not rebin or made is None or it - made[1] >= rebin:
            made = None
        img, _, _, b = render_at(leaf, rot, tran, cam,
                                 None if made is None else made[0])
        if made is None:
            binned[kf] = (b, it)
        loss = mapping_loss(img, gt_im, gt_depth, cfg)
        gr = dict(zip(GAUSS, torch.autograd.grad(loss, [leaf[k] for k in GAUSS])))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.clone() for k, v in gr.items()}
        opt.step(g, gr)
        if cfg.get("prune_gaussians", False):
            rows = prune_rows(g, it, cfg["pruning_dict"], scene_radius)
            if rows is not None:
                binned.clear()
                g = {k: v[rows] for k, v in g.items()}
                opt.keep(rows)
                kept = kept[rows]
    return losses, first, g, kept


@torch.no_grad()
def densify_mask(g, rot, tran, gt_depth, cam, sil_thres):
    """The pixels SplaTAM's densification adds Gaussians at: where the
    silhouette is below ``sil_thres``, or the render lies behind the
    ground truth by more than 50 median depth errors."""
    img, _, _, _ = render_at(g, rot, tran, cam)
    depth, sil = img[3], img[4]
    gd = gt_depth[0]
    err = (gd - depth).abs() * (gd > 0)
    s = torch.sort(err.reshape(-1).float()).values
    n = s.shape[0]
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    miss = (sil < sil_thres) | ((depth > gd) & (err > 50 * med))
    return miss & (gd > 0)


def rotation_quaternion(r) -> torch.Tensor:
    """A rotation matrix's unit quaternion (w, x, y, z), w >= 0, computed
    in float64 on the host."""
    m = np.asarray(r.detach().cpu(), np.float64) if torch.is_tensor(r) else np.asarray(r)
    tr = np.trace(m)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        v = [0.0, 0.0, 0.0]
        v[i] = 0.25 * s
        v[j] = (m[j, i] + m[i, j]) / s
        v[k] = (m[k, i] + m[i, k]) / s
        q = [(m[k, j] - m[j, k]) / s] + v
    q = np.asarray(q) / np.linalg.norm(q)
    q = q if q[0] >= 0 else -q
    dev = r.device if torch.is_tensor(r) else "cpu"
    return torch.as_tensor(q, dtype=torch.float32, device=dev)


def pose_of(c2w, dev):
    """(rot, tran) of the world-to-camera pose of a camera-to-world matrix."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    return (rotation_quaternion(w2c[:3, :3]).to(dev),
            torch.as_tensor(w2c[:3, 3], dtype=torch.float32, device=dev))


def training_loss(img, gt_im, gt_depth, w):
    """Offline 3DGS's loss: 0.8 L1 + 0.2 (1 - SSIM) on RGB, and L1 of the
    rendered depth where the ground truth has depth, over every pixel."""
    valid = (gt_depth != 0).to(img.dtype)
    l_im = 0.8 * (img[:3] - gt_im).abs().mean() + 0.2 * (1 - ssim(img[:3], gt_im))
    l_depth = (img[3:4] * valid - gt_depth).abs().mean()
    return w["im"] * l_im + w["depth"] * l_depth


def train_steps(g, frames, cam, weights):
    """Offline training's Adam steps on the map ``g``, one per entry of
    ``frames`` ((frame id, learning rates, gt_im, gt_depth, (rot, tran))),
    each render binned afresh. Returns (losses, first gradients, final
    map)."""
    g = {k: v.detach().clone() for k, v in g.items()}
    opt = Adam(g, frames[0][1], eps=1e-15)
    losses, first = [], None
    for _, lrs, gt_im, gt_depth, (rot, tran) in frames:
        leaf = {k: v.detach().requires_grad_() for k, v in g.items()}
        img, _, _, _ = render_at(leaf, rot, tran, cam)
        loss = training_loss(img, gt_im, gt_depth, weights)
        gr = dict(zip(GAUSS, torch.autograd.grad(loss, [leaf[k] for k in GAUSS])))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.clone() for k, v in gr.items()}
        opt.step(g, gr, lrs)
    return losses, first, g
