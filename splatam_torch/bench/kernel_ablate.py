"""P1: the aligned backward B2 taken apart stage by stage.

Counterpart of ``tools/kernel_ablate.py``: B2's pass on the benchmark's real
aligned stream (``bench.scene.setup("aligned")``, chunk 256, the trimmed
binning), cut after each stage of ``STAGES``; successive differences price
the stages. Kernel ``csrc/probe_ablate.cu`` (one template instance per
stage, ``raster.KERNELS["P1"]``); ``ablate_plain`` beside it computes the
same per-pixel outputs from ``raster.raster_bwd_plain``'s arithmetic.

The stages follow B2's own structure; where the TPU tool has a stage of the
same name it measures the counterpart. The TPU's ``dma_phi`` (its constant
MXU basis blocks) has none: B2 makes its basis in registers. ``moments``,
``reduce`` and ``full`` split the TPU's ``full`` delta into the pixel sums
on the tensor cores, the block-level reduction into the shared accumulator
and the flush into the per-gaussian table.

Usage: python -m splatam_torch.bench.kernel_ablate [--iters 30] [--n N]
  [--w W] [--h H] [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from splatam_torch.bench.scene import setup
from splatam_torch.bench.timing import device_name, time_ms
from splatam_torch.render import raster
from splatam_torch.render.binning import Binned
from splatam_torch.render.geometry import ALPHA_CAP, ALPHA_MIN

STAGES = ("dma0", "dma_lean", "dma_tile", "dma", "alpha", "scan", "gc",
          "moments", "reduce", "full")
WHAT = {
    "dma0": "block start, one write per pixel",
    "dma_lean": "staging every batch of the range into shared memory",
    "dma_tile": "the tile's cotangent inputs (grad_inputs)",
    "dma": "gid staging, the saturation-exit loop control",
    "alpha": "eval_pair's alpha for every pair",
    "scan": "transmittance and pixel death",
    "gc": "gc, suffix, dalpha, d/dopacity, dpower",
    "moments": "dop, w to shared; pixel moments, feature sums (mma)",
    "reduce": "the warps' sums over the block (slots, one barrier)",
    "full": "the flush: rows recombined, atomicAdd into (N, 16): B2",
}
SUB = 16  # B2's warp sub-batch (raster_common.cuh): the mma's M
WARPS = raster.NPIX // 32
NFEAT = 4  # the mapping loss's gradient channels (slam_loss's grad_feats)


class AblationInputs(NamedTuple):
    """One view's B2 inputs: the stream, the forward's blocks and the
    cotangents."""

    attrs: torch.Tensor  # (N, 16)
    binned: Binned
    grid_x: int
    chunk: int
    color: torch.Tensor  # (T, 8, 256) forward outputs
    aux: torch.Tensor
    g_color: torch.Tensor  # (T, 8, 256) cotangents
    g_aux: torch.Tensor
    nfeat: int


def ablation_inputs(attrs, binned: Binned, grid_x, chunk,
                    nfeat=NFEAT) -> AblationInputs:
    """The forward (B1, or its plain version on the CPU) of ``binned`` and
    cotangents as the tool makes them: normal * 1e-3 on the first ``nfeat``
    color channels and on the final T, from a fixed seed; no median depth
    (the mapping loss's setting, as the benchmark runs B2)."""
    if not isinstance(binned, Binned):
        raise ValueError("the ablation runs B2's aligned layout (Binned)")
    args = (attrs, binned.sorted_gid, binned.ranges, grid_x, chunk, False)
    if attrs.is_cuda:
        color, aux = raster.raster_fwd_cuda(*args)
    else:
        color, aux, _ = raster.raster_fwd_plain(*args)
    rng = np.random.default_rng(0)

    def normal(shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * 1e-3,
                            device=attrs.device)

    g_color = normal(color.shape)
    g_color[:, nfeat:] = 0.0
    g_aux = torch.zeros_like(aux)
    g_aux[:, 1] = normal(aux[:, 1].shape)
    return AblationInputs(attrs, binned, grid_x, chunk, color, aux, g_color,
                          g_aux, nfeat)


def ablate_cuda(stage: str, x: AblationInputs) -> torch.Tensor:
    """Launch P1's ``stage``. Returns the (T, 256) per-pixel output, or for
    ``full`` the (N, 16) gradient table."""
    b = x.binned
    raster._check_common(x.attrs, b.sorted_gid, b.ranges, x.chunk)
    t = b.ranges.shape[0]
    raster._check_grad_inputs(t, x.color, x.aux, x.g_color, x.g_aux, x.nfeat)
    full = stage == "full"
    pix = x.attrs.new_empty((1,) if full else (t, raster.NPIX))
    grad = torch.zeros_like(x.attrs) if full else x.attrs.new_empty((1,))
    raster.ABLATE_KERNEL.launch(
        x.attrs.device, x.attrs.data_ptr(), b.sorted_gid.data_ptr(),
        b.ranges.data_ptr(), STAGES.index(stage), t, x.grid_x, x.chunk,
        x.nfeat, 0, x.color.data_ptr(), x.aux.data_ptr(),
        x.g_color.data_ptr(), x.g_aux.data_ptr(), pix.data_ptr(),
        grad.data_ptr(),
    )
    return grad if full else pix


def ablate_plain(stage: str, x: AblationInputs) -> torch.Tensor:
    """Plain P1: the stage's per-pixel output in tensor ops, one batch of
    ``chunk`` instance positions at a time over every tile (the B2 plain
    version's arithmetic, ``raster._bwd_segments``)."""
    b, attrs = x.binned, x.attrs
    args = (attrs, b.sorted_gid, b.ranges, x.grid_x, x.chunk)
    if stage == "full":
        return raster.raster_bwd_plain(*args, x.color, x.aux, x.g_color,
                                       x.g_aux, x.nfeat, False)
    t = b.ranges.shape[0]
    if stage == "dma0":
        return attrs.new_ones((t, raster.NPIX))
    dev = attrs.device
    tiles = torch.arange(t, device=dev)
    px, py = raster._pixel_centers(tiles, x.grid_x)
    p = torch.arange(raster.NPIX, device=dev)
    ga, _ = raster._ga_gdep(x.color, x.aux, x.g_color, x.g_aux)
    trans, dead, accw = raster._fresh_bwd(t, attrs)
    acc = attrs.new_zeros((t, raster.NPIX))
    for rows, gid, valid in raster._blocks(*args[:3], x.chunk):
        if stage in ("dma_lean", "dma_tile", "dma"):
            n = valid.sum(1)[:, None]  # the batch's instances per tile
            j = (p[None, :] // raster.ROWS) % n.clamp(min=1)
            r = (p % raster.ROWS)[None, :].expand(t, -1)
            step = acc + rows[tiles[:, None], j, r]
            if stage == "dma":
                step = step + gid[tiles[:, None], j].float()
            acc = torch.where(n > 0, step, acc)
            continue
        dx, dy, praw, epow, raw, alpha = raster._pairs(rows, px, py)
        if stage == "alpha":
            acc = acc + alpha.sum(1)
            continue
        t_before, live, _, trans, dead = raster._replay(alpha, trans, dead)
        zero = torch.zeros_like(alpha)
        w = torch.where(live, alpha * t_before, zero)
        if stage == "scan":
            acc = acc + w.sum(1)
            continue
        gc = torch.einsum("tfp,tcf->tcp", x.g_color, rows[..., raster.ROW_FEAT0:])
        prefix = accw[:, None] + torch.cumsum(w * gc, dim=1)
        accw = prefix[:, -1]
        dalpha = torch.where(
            live, t_before * gc - (ga[:, None] - prefix) / (1 - alpha), zero)
        unclamped = (raw >= ALPHA_MIN) & (raw < ALPHA_CAP)
        dop = torch.where(unclamped, dalpha * epow, zero)
        dpower = torch.where(praw <= 0, dop, zero) * rows[..., raster.ROW_OP, None]
        if stage == "gc":
            acc = acc + dpower.sum(1)
            continue
        gcol = x.g_color.clone()
        gcol[:, x.nfeat:] = 0.0
        # B2 keeps d/dopacity where the power was not clamped (dpower is
        # the opacity times it) and adds the rest apart
        gated = torch.where(praw <= 0, dop, zero)
        if stage == "moments":
            acc = acc + _lane_sums(gated, w, gcol)
            continue
        if stage != "reduce":
            raise ValueError(f"unknown stage {stage!r}")
        # the block's sums: the six moments of the gated d/dopacity, the
        # d/dopacity added apart, no median depth (the probe runs without
        # carry_depth), the feature sums; pixel p reads column p % 16 of
        # instances p // 16, p // 16 + 16, ... of the batch
        c = dop.shape[1]
        s_acc = torch.cat([
            torch.einsum("tcp,pb->tbc", gated, tile_basis(dev)),
            (dop - gated).sum(-1)[:, None], dop.new_zeros((t, 1, c)),
            torch.einsum("tcp,tfp->tfc", w, gcol),
        ], dim=1)  # (T, 16, C)
        pad = s_acc.new_zeros((t, raster.ROWS, -c % SUB))
        by_pos = torch.cat([s_acc, pad], -1).reshape(t, raster.ROWS, -1, SUB)
        acc = acc + by_pos.sum(2).permute(0, 2, 1).reshape(t, raster.NPIX)
    return acc


def tile_basis(device) -> torch.Tensor:
    """(NPIX, 6) moment basis (1, x, y, x^2, xy, y^2) of every pixel of a
    tile, centred on the tile: |x|, |y| <= 7.5."""
    p = torch.arange(raster.NPIX, device=device)
    xs = (p % raster.TILE).float() - 7.5
    ys = (p // raster.TILE).float() - 7.5
    return torch.stack([torch.ones_like(xs), xs, ys, xs * xs, xs * ys,
                        ys * ys], -1)


def _lane_sums(gated, w, gcol):
    """``moments``' per-pixel output: each warp's mma sums over its own 32
    pixels (instances as rows: the moments of the gated d/dopacity in
    columns 0-5 of one product, the feature sums in columns 0-7 of the
    other), each lane's C-fragment entries summed, batch position c in rows
    c % 8 of the fragment (c % 16 and c % 16 + 8 of the sub-batch), columns
    2t, 2t + 1 at lane 4g + t."""
    t, c, _ = gated.shape
    basis = tile_basis(gated.device).reshape(WARPS, 32, 6)
    cm = torch.einsum("tcwq,wqb->tcwb", gated.reshape(t, c, WARPS, 32), basis)
    cm = torch.cat([cm, cm.new_zeros((t, c, WARPS, 2))], -1)
    cf = torch.einsum("tcwq,tfwq->tcwf", w.reshape(t, c, WARPS, 32),
                      gcol.reshape(t, -1, WARPS, 32))
    pairs = (cm + cf).reshape(t, c, WARPS, 4, 2).sum(-1)  # (T, C, warp, t)
    pad = pairs.new_zeros((t, -c % 8, WARPS, 4))
    by_row = torch.cat([pairs, pad], 1).reshape(t, -1, 8, WARPS, 4).sum(1)
    return by_row.permute(0, 2, 1, 3).reshape(t, raster.NPIX)


def ablate(stage: str, x: AblationInputs) -> torch.Tensor:
    """P1's ``stage`` on a CUDA tensor, its plain version on a CPU one."""
    return (ablate_cuda if x.attrs.is_cuda else ablate_plain)(stage, x)


def run(n=200_000, w=1200, h=680, iters=30, device=None):
    """Time every stage on the benchmark's aligned stream (B1's forward for
    the cotangent inputs). Prints the table; returns {stage: ms per pass}
    with the tile count under ``"tiles"``."""
    prog = setup("aligned", n=n, w=w, h=h, device=device)
    attrs, binned, grid_x = prog.stream_inputs()
    x = ablation_inputs(attrs, binned, grid_x, prog.cfg.chunk)
    dev = attrs.device
    tiles = binned.ranges.shape[0]
    ms = {s: time_ms(lambda s=s: ablate(s, x), iters, dev) for s in STAGES}
    print(f"[ablate] {device_name(dev)}: B2 stage ablation on the bench's "
          f"aligned stream, {n} gaussians at {w}x{h}, chunk {x.chunk}, "
          f"K={binned.num_instances}, {tiles} tile blocks, {iters} passes",
          flush=True)
    print(f"[ablate] {'stage':9s} {'ms/pass':>10s} {'ns/block':>10s} "
          f"{'delta':>9s}  what the stage adds", flush=True)
    prev = None
    for s in STAGES:
        ns = ms[s] * 1e6 / tiles
        delta = "" if prev is None else f"{ns - prev:+9.1f}"
        print(f"[ablate] {s:9s} {ms[s]:10.4f} {ns:10.1f} {delta:>9s}  {WHAT[s]}",
              flush=True)
        prev = ns
    return dict(ms, tiles=tiles)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.n, args.w, args.h, args.iters, args.device)


if __name__ == "__main__":
    main()
