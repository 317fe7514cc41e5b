"""The benchmark's measured program: one SplaTAM mapping iteration at
Replica width, chained.

Counterpart of ``bench.py:31-277`` (``make_scene``, ``parse_mode``,
``setup``). The fused 6-channel mapping loss (RGB, depth, silhouette,
depth^2; ``core.losses.slam_loss`` with ``tracking=False``) against a zero
image and a constant depth of 2.5 m, rendered and differentiated through
every gaussian parameter. The iteration takes the gradient only and moves
the parameters by ``1e-20`` times it (no Adam), so each iteration depends on
the one before. Binning is frozen for ``rebin_every`` iterations, then
recomputed at the current parameters and the latest render's saturation
depths, as the SLAM driver does.

JAX's capacity sizing (``count_instances``, ``sized_config``) and window
alignment (``alignment_order``) have nothing to size here: the port's
tensors take the sizes the data gives them and its ranges are ragged. The
saturation-trim probe stays: render once, take each tile's saturation
depth, and re-bin with it as ``depth_cap``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from splatam_torch.core.losses import (
    LossOutput,
    _frame_inputs,
    compute_binned,
    depth_silhouette_colors,
    slam_loss,
)
from splatam_torch.core.params import GAUSSIAN_KEYS
from splatam_torch.device import resolve_device
from splatam_torch.render.binning import Binned, BinnedSplit, RasterConfig
from splatam_torch.render.camera import Camera, setup_camera
from splatam_torch.render.geometry import grid_dims, preprocess
from splatam_torch.render.raster import pack_attrs

# chunk 256 is the split layout's best on this scene on the TPU (bench.py)
BENCH_CHUNK = 256
# mode tokens of bench.py that choose TPU-only levers: the reduction, the
# transmittance scan and window alignment. Accepted and ignored.
IGNORED_TOKENS = ("sort", "perm", "scatter", "mxu", "roll", "align", "noalign")


def make_scene(n: int = 200_000, w: int = 1200, h: int = 680, seed: int = 0):
    """``bench.py::make_scene`` in numpy: a box of small isotropic gaussians
    in front of the camera at depth 1..6, same seed and draw order.
    Returns (raw parameters, w, h, intrinsics k)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2.2, 2.2, n), rng.uniform(-1.3, 1.3, n),
                      rng.uniform(1.0, 6.0, n)], axis=-1).astype(np.float32)
    k = [[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]]
    params = {
        "means3D": means,
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": (rng.normal(size=(n, 4))
                             + np.array([2.0, 0, 0, 0])).astype(np.float32),
        "logit_opacities": rng.normal(1.0, 1.0, (n, 1)).astype(np.float32),
        "log_scales": rng.uniform(-5.2, -3.8, (n, 1)).astype(np.float32),
    }
    return params, w, h, k


def parse_mode(base: RasterConfig, mode: str | None):
    """Apply ``+``-separated mode tokens to ``base`` (``bench.py:60``):
    ``aligned`` / ``split`` set the layout, ``cNNN`` the chunk, ``notrim``
    drops the saturation trim; ``IGNORED_TOKENS`` are accepted and change
    nothing. Returns (config, {"trim": bool}); an unknown token raises."""
    opts = {"trim": True}
    for tok in (mode or "").split("+"):
        if not tok or tok in IGNORED_TOKENS:
            continue
        if tok in ("aligned", "split"):
            base = dataclasses.replace(base, layout=tok)
        elif tok.startswith("c") and tok[1:].isdigit():
            base = dataclasses.replace(base, chunk=int(tok[1:]))
        elif tok == "notrim":
            opts["trim"] = False
        else:
            raise ValueError(f"unknown bench mode token: {tok}")
    return base, opts


@dataclasses.dataclass
class BenchProgram:
    """The measured program and its inputs (``bench.py::setup``'s dict)."""

    params: Dict[str, torch.Tensor]  # the gaussians: GAUSSIAN_KEYS
    cam: Camera
    cfg: RasterConfig
    pose: tuple  # (rotation quaternion (4,), translation (3,)): identity
    gt_im: torch.Tensor  # (3, H, W) zeros
    gt_depth: torch.Tensor  # (1, H, W) 2.5 m
    sat0: torch.Tensor | None  # per-tile saturation caps of the probe render
    iters: int
    rebin_every: int
    num_kept: int  # instances of the trimmed binning
    num_kept_untrimmed: int

    @property
    def w(self) -> int:
        return self.cam.image_width

    @property
    def h(self) -> int:
        return self.cam.image_height

    def loss(self, gauss, binned) -> LossOutput:
        """The mapping loss of ``gauss`` on a frozen binning."""
        return slam_loss(
            gauss, *self.pose, self.gt_im, self.gt_depth, self.cam, self.cfg,
            tracking=False, loss_w_im=0.5, loss_w_depth=1.0,
            use_sil_for_loss=False, sil_thres=0.5,
            ignore_outlier_depth_loss=False, binned=binned,
        )

    def bin_now(self, gauss, sat) -> Binned | BinnedSplit:
        """Bin at ``gauss`` with the saturation caps ``sat`` (None: none)."""
        return compute_binned(gauss, *self.pose, self.cam, self.cfg,
                              depth_cap=sat)

    def loss_and_grads(self, gauss, binned):
        """(loss output, {key: dL/dkey}) of one iteration."""
        leaves = {k: v.detach().requires_grad_() for k, v in gauss.items()}
        out = self.loss(leaves, binned)
        grads = torch.autograd.grad(out.loss, list(leaves.values()))
        return out, dict(zip(leaves, grads))

    def run(self) -> torch.Tensor:
        """``iters`` chained iterations from the scene's gaussians and the
        probe's caps, re-binning at the head of every ``rebin_every`` block.
        Returns the last loss plus 1e-20 times a parameter, so no
        iteration's gradient is dead work."""
        g, sat, loss = dict(self.params), self.sat0, None
        for _ in range(self.iters // self.rebin_every):
            binned = self.bin_now(g, sat)
            for _ in range(self.rebin_every):
                out, grads = self.loss_and_grads(g, binned)
                with torch.no_grad():
                    g = {k: v + 1e-20 * grads[k] for k, v in g.items()}
                sat, loss = out.sat_depth, out.loss.detach()
        return loss + 1e-20 * g["means3D"][0, 0]

    @torch.no_grad()
    def stream_inputs(self):
        """The compositing kernels' inputs as the loss builds them for the
        scene's gaussians on the trimmed binning: (the (N, 16) attribute
        table with the six mapping channels, the binning, grid_x)."""
        g = self.params
        binned = self.bin_now(g, self.sat0)
        pts, rots, scales = _frame_inputs(g, *self.pose, False, False)
        proj = preprocess(pts, scales, rots, self.cam)
        feats = torch.cat(
            [g["rgb_colors"], depth_silhouette_colors(pts, self.cam.viewmatrix)],
            dim=-1)
        attrs = pack_attrs(proj.means2d, proj.conic,
                           torch.sigmoid(g["logit_opacities"]).reshape(-1),
                           proj.depths, feats)
        return attrs, binned, grid_dims(self.cam)[0]


def setup(
    mode: str | None = None,
    iters: int = 10,
    rebin_every: int = 10,
    n: int = 200_000,
    w: int = 1200,
    h: int = 680,
    device=None,
) -> BenchProgram:
    """Build the measured program (``bench.py::setup``) on ``device`` (None:
    CUDA, raising without it). The defaults are ``bench.py``'s: 200k
    gaussians at 1200x680, split layout, chunk 256, 10 iterations, binning
    frozen for 10. Runs the saturation-trim probe render (one forward)
    unless the mode says ``notrim``."""
    if iters % rebin_every != 0:
        raise ValueError("iters must be a multiple of rebin_every")
    dev = resolve_device(device)
    cfg, opts = parse_mode(RasterConfig(chunk=BENCH_CHUNK), mode)
    params_np, w, h, k = make_scene(n, w, h)
    params = {key: torch.as_tensor(params_np[key], device=dev)
              for key in GAUSSIAN_KEYS}
    cam = setup_camera(w, h, k, np.eye(4), device=dev)
    # made once, as bench.py does: a tensor made from host data inside the
    # loop would be a copy that waits for the device every iteration
    prog = BenchProgram(
        params=params, cam=cam, cfg=cfg,
        pose=(torch.tensor([1.0, 0, 0, 0], device=dev),
              torch.zeros(3, device=dev)),
        gt_im=torch.zeros((3, h, w), device=dev),
        gt_depth=torch.full((1, h, w), 2.5, device=dev),
        sat0=None, iters=iters, rebin_every=rebin_every, num_kept=0,
        num_kept_untrimmed=0)
    probe = prog.bin_now(params, None)
    prog.num_kept_untrimmed = prog.num_kept = probe.num_instances
    if opts["trim"]:
        with torch.no_grad():
            prog.sat0 = prog.loss(params, probe).sat_depth
        prog.num_kept = prog.bin_now(params, prog.sat0).num_instances
    return prog
