"""Tile compositing: the kernels B1/B2, their plain versions, and autograd.

Counterpart of ``splatam_tpu/render/pallas_raster.py`` for the aligned
layout. The differentiable boundary is the per-gaussian (N, 16) attribute
table (``pack_attrs``), as in the JAX package's ``_make_raster_fn``: the
forward returns channel-major ``color`` and ``aux`` blocks (T, 8, 256), the
backward returns (N, 16) per-gaussian gradients.

On a CUDA tensor the forward and backward launch the hand-written kernels
in ``csrc/raster_fwd.cu`` and ``csrc/raster_bwd.cu`` (built with nvcc at
first use, bound with ctypes); a failed build or launch raises. On a CPU
tensor they run ``raster_fwd_plain`` / ``raster_bwd_plain``, the same
arithmetic in tensor ops, which the tests also hold against the JAX package
and ``chip_smoke.py`` holds the kernels against on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from splatam_torch.render.binning import Binned
from splatam_torch.render.geometry import (
    ALPHA_CAP,
    ALPHA_MIN,
    T_STOP,
    TILE,
)

# attribute rows of the (N, ROWS) table (pallas_raster.py:64-67)
ROW_X, ROW_Y, ROW_CA, ROW_CB, ROW_CC, ROW_OP, ROW_DEPTH, ROW_GID = range(8)
ROW_FEAT0 = 8
NFEAT_PAD = 8
ROWS = ROW_FEAT0 + NFEAT_PAD
NPIX = TILE * TILE
# aux row 2 where a tile never saturated; +inf at the RenderAux boundary
SAT_INF = 1e30
MAX_CHUNK = 512  # shared-memory batch limit of the kernels

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("raster_fwd", "raster_bwd")


class RasterOut(NamedTuple):
    """Raw per-tile outputs, channel-major."""

    color: torch.Tensor  # (T, 8, NPIX) blended features, no background
    aux: torch.Tensor  # (T, 8, NPIX): 0 median-depth sum, 1 final T,
    # 2 saturation depth (SAT_INF if the tile never saturated), rest 0


def pack_attrs(
    blend_xy: torch.Tensor,  # (N, 2)
    conic: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,)
    depths: torch.Tensor,  # (N,)
    feats: torch.Tensor,  # (N, F), F <= NFEAT_PAD
) -> torch.Tensor:
    """(N, 16) attribute rows in ROW_* order; feature rows zero-padded."""
    n, f = feats.shape
    if f > NFEAT_PAD:
        raise ValueError(f"at most {NFEAT_PAD} feature channels, got {f}")
    gid = torch.arange(n, dtype=torch.float32, device=feats.device)
    pad = feats.new_zeros((n, NFEAT_PAD - f))
    return torch.cat(
        [
            blend_xy, conic, opacities.reshape(n, 1), depths.reshape(n, 1),
            gid[:, None], feats, pad,
        ],
        dim=1,
    ).contiguous()


# ---------------------------------------------------------------------------
# Kernel build and launch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "raster_common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_kernels(names=KERNEL_SOURCES) -> dict:
    """Compile the named kernel sources that are not built yet, all at once
    (one nvcc per source, started together). Returns {name: compiler log}
    for the sources it compiled; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


class CudaKernel:
    """A ctypes-bound kernel entry with its launch count.

    ``launches`` goes up by one for every launch of the kernel, and for
    nothing else."""

    def __init__(self, source: str, symbol: str, n_ptr_head: int,
                 n_int: int, n_ptr_tail: int):
        self.source = source
        self.symbol = symbol
        self.argtypes = (
            [ctypes.c_void_p] * n_ptr_head + [ctypes.c_int] * n_int
            + [ctypes.c_void_p] * (n_ptr_tail + 1)  # + the stream
        )
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            build_kernels((self.source,))
            lib = ctypes.CDLL(str(_library_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = self._entry()(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


# raster_fwd(attrs, gid, ranges, num_tiles, grid_x, chunk, carry_depth,
#            color, aux, stream)
FWD_KERNEL = CudaKernel("raster_fwd", "raster_fwd", 3, 4, 2)
# raster_bwd(attrs, gid, ranges, num_tiles, grid_x, chunk, nfeat,
#            carry_depth, color, aux, g_color, g_aux, grad, stream)
BWD_KERNEL = CudaKernel("raster_bwd", "raster_bwd", 3, 5, 5)


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _check_common(attrs, sorted_gid, ranges, chunk):
    _check(attrs, "attrs", torch.float32, (attrs.shape[0], ROWS))
    _check(sorted_gid, "sorted_gid", torch.int32)
    _check(ranges, "ranges", torch.int32, (ranges.shape[0], 2))
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def raster_fwd_cuda(attrs, sorted_gid, ranges, grid_x, chunk, carry_depth=True):
    """Launch B1. Returns (color, aux), each (T, 8, NPIX)."""
    _check_common(attrs, sorted_gid, ranges, chunk)
    t = ranges.shape[0]
    color = torch.empty((t, NFEAT_PAD, NPIX), dtype=torch.float32,
                        device=attrs.device)
    aux = torch.empty_like(color)
    FWD_KERNEL.launch(
        attrs.device, attrs.data_ptr(), sorted_gid.data_ptr(),
        ranges.data_ptr(), t, grid_x, chunk, int(carry_depth),
        color.data_ptr(), aux.data_ptr(),
    )
    return color, aux


def raster_bwd_cuda(attrs, sorted_gid, ranges, grid_x, chunk, color, aux,
                    g_color, g_aux, nfeat, carry_depth=True):
    """Launch B2. Returns the (N, 16) per-gaussian gradient table."""
    _check_common(attrs, sorted_gid, ranges, chunk)
    t = ranges.shape[0]
    for name, x in (("color", color), ("aux", aux), ("g_color", g_color),
                    ("g_aux", g_aux)):
        _check(x, name, torch.float32, (t, NFEAT_PAD, NPIX))
    if not 0 <= nfeat <= NFEAT_PAD:
        raise ValueError(f"nfeat must be in [0, {NFEAT_PAD}], got {nfeat}")
    grad = torch.zeros_like(attrs)
    BWD_KERNEL.launch(
        attrs.device, attrs.data_ptr(), sorted_gid.data_ptr(),
        ranges.data_ptr(), t, grid_x, chunk, nfeat, int(carry_depth),
        color.data_ptr(), aux.data_ptr(), g_color.data_ptr(),
        g_aux.data_ptr(), grad.data_ptr(),
    )
    return grad


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in tensor ops, one instance
# position at a time over every tile and pixel at once
# ---------------------------------------------------------------------------


def _pixel_centers(t: int, grid_x: int, device):
    tile = torch.arange(t, device=device)
    p = torch.arange(NPIX, device=device)
    px = ((tile % grid_x)[:, None] * TILE + (p % TILE)[None, :]).float()
    py = ((tile // grid_x)[:, None] * TILE + (p // TILE)[None, :]).float()
    return px, py


def _pairs(a, px, py):
    """Per-(instance, pixel) quantities for a (T, C, ROWS) block of
    instances, (T, C, NPIX) each, in the association of raster_common.cuh's
    eval_pair."""
    x, y = a[..., ROW_X, None], a[..., ROW_Y, None]
    ca, cb, cc = a[..., ROW_CA, None], a[..., ROW_CB, None], a[..., ROW_CC, None]
    dx, dy = x - px[:, None], y - py[:, None]
    praw = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    epow = torch.exp(torch.clamp(praw, max=0.0))
    raw = a[..., ROW_OP, None] * epow
    alpha = torch.clamp(raw, max=ALPHA_CAP)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    return dx, dy, praw, epow, raw, alpha


def _replay(alpha, trans, dead):
    """The transmittance recursion over a (T, C, NPIX) block, one instance
    at a time, as the kernels run it: a pixel dies where T (1 - alpha)
    falls below T_STOP, and then keeps its T. Returns (T before each
    instance, live mask, alive-before mask, T after the block, dead after
    the block)."""
    before, lives, alives = [], [], []
    for j in range(alpha.shape[1]):
        test = trans * (1 - alpha[:, j])
        live = ~dead & (test >= T_STOP)
        before.append(trans)
        lives.append(live)
        alives.append(~dead)
        dead = dead | (test < T_STOP)
        trans = torch.where(live, test, trans)
    return (torch.stack(before, 1), torch.stack(lives, 1),
            torch.stack(alives, 1), trans, dead)


def _blocks(attrs, sorted_gid, ranges, chunk):
    """Yield ((T, C, ROWS) rows, (T, C) gids, (T, C) valid)
    for each batch of ``chunk`` instance positions of every tile's range,
    rows zero past a tile's count."""
    counts = (ranges[:, 1] - ranges[:, 0]).long()
    kmax = int(counts.max()) if counts.numel() else 0
    for c0 in range(0, kmax, chunk):
        j = torch.arange(c0, min(c0 + chunk, kmax), device=attrs.device)
        valid = j[None, :] < counts[:, None]
        pos = ranges[:, :1].long() + j[None, :]
        pos = torch.where(valid, pos, torch.zeros_like(pos))
        gid = sorted_gid.long()[pos] if sorted_gid.numel() else pos
        gid = torch.where(valid, gid, torch.zeros_like(gid))
        rows = torch.where(valid[..., None], attrs[gid], attrs.new_zeros(()))
        yield rows, gid, valid


def raster_fwd_plain(attrs, sorted_gid, ranges, grid_x, chunk,
                     carry_depth=True):
    """Plain B1. Returns (color, aux, evaluated): ``evaluated`` (T, NPIX)
    counts the instances each pixel evaluates, up to and including the one
    where it dies. Written without in-place ops, so autograd can
    differentiate it."""
    t = ranges.shape[0]
    dev = attrs.device
    px, py = _pixel_centers(t, grid_x, dev)
    trans = attrs.new_ones((t, NPIX))
    dead = torch.zeros((t, NPIX), dtype=torch.bool, device=dev)
    color = attrs.new_zeros((t, NFEAT_PAD, NPIX))
    dsum = attrs.new_zeros((t, NPIX))
    sat = attrs.new_full((t,), SAT_INF)
    saturated = torch.zeros(t, dtype=torch.bool, device=dev)
    evaluated = torch.zeros((t, NPIX), dtype=torch.int64, device=dev)
    for rows, _, valid in _blocks(attrs, sorted_gid, ranges, chunk):
        alpha = _pairs(rows, px, py)[-1]
        t_before, live, alive, trans, dead = _replay(alpha, trans, dead)
        evaluated = evaluated + (alive & valid[..., None]).sum(1)
        w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
        color = color + torch.einsum("tcp,tcf->tfp", w, rows[..., ROW_FEAT0:])
        depth = rows[..., ROW_DEPTH]
        if carry_depth:
            test = t_before * (1 - alpha)
            cross = live & (t_before > 0.5) & (test < 0.5)
            dsum = dsum + torch.where(
                cross, depth[..., None], torch.zeros_like(alpha)
            ).sum(1)
        # the kernels check for a dead tile after each batch
        newly = valid.any(1) & ~saturated & dead.all(1)
        batch_max = torch.where(
            valid, depth.detach(), depth.new_full((), -float("inf"))
        ).max(1).values
        sat = torch.where(newly, batch_max, sat)
        saturated = saturated | newly
    aux = torch.cat(
        [
            dsum[:, None],
            trans[:, None],
            sat[:, None, None].expand(t, 1, NPIX),
            attrs.new_zeros((t, 5, NPIX)),
        ],
        dim=1,
    )
    return color, aux, evaluated


def raster_bwd_plain(attrs, sorted_gid, ranges, grid_x, chunk, color, aux,
                     g_color, g_aux, nfeat, carry_depth=True):
    """Plain B2: the same analytic backward as the kernel, in tensor ops.
    Returns the (N, 16) per-gaussian gradient table."""
    t = ranges.shape[0]
    dev = attrs.device
    px, py = _pixel_centers(t, grid_x, dev)
    ga = g_aux[:, 1] * aux[:, 1] + (color * g_color).sum(dim=1)
    gdep = g_aux[:, 0]
    trans = attrs.new_ones((t, NPIX))
    dead = torch.zeros((t, NPIX), dtype=torch.bool, device=dev)
    accw = attrs.new_zeros((t, NPIX))
    grad = torch.zeros_like(attrs)
    for rows, gid, valid in _blocks(attrs, sorted_gid, ranges, chunk):
        dx, dy, praw, epow, raw, alpha = _pairs(rows, px, py)
        t_before, live, _, trans, dead = _replay(alpha, trans, dead)
        zero = torch.zeros_like(alpha)
        gc = torch.einsum("tfp,tcf->tcp", g_color, rows[..., ROW_FEAT0:])
        w = torch.where(live, alpha * t_before, zero)
        prefix = accw[:, None] + torch.cumsum(w * gc, dim=1)
        accw = prefix[:, -1]
        dalpha = torch.where(
            live, t_before * gc - (ga[:, None] - prefix) / (1 - alpha), zero
        )
        unclamped = (raw >= ALPHA_MIN) & (raw < ALPHA_CAP)
        dop = torch.where(unclamped, dalpha * epow, zero)
        dpower = torch.where(praw <= 0, dop, zero) * rows[..., ROW_OP, None]
        ca = rows[..., ROW_CA, None]
        cb = rows[..., ROW_CB, None]
        cc = rows[..., ROW_CC, None]
        g = torch.zeros(rows.shape, dtype=attrs.dtype, device=dev)
        g[..., ROW_X] = (dpower * -(ca * dx + cb * dy)).sum(-1)
        g[..., ROW_Y] = (dpower * -(cc * dy + cb * dx)).sum(-1)
        g[..., ROW_CA] = (dpower * (-0.5 * (dx * dx))).sum(-1)
        g[..., ROW_CB] = (dpower * -(dx * dy)).sum(-1)
        g[..., ROW_CC] = (dpower * (-0.5 * (dy * dy))).sum(-1)
        g[..., ROW_OP] = dop.sum(-1)
        if carry_depth:
            test = t_before * (1 - alpha)
            cross = live & (t_before > 0.5) & (test < 0.5)
            g[..., ROW_DEPTH] = torch.where(cross, gdep[:, None], zero).sum(-1)
        g[..., ROW_FEAT0:ROW_FEAT0 + nfeat] = torch.einsum(
            "tcp,tfp->tcf", w, g_color[:, :nfeat]
        )
        grad.index_add_(0, gid[valid], g[valid])
    return grad


# ---------------------------------------------------------------------------
# Differentiable entry
# ---------------------------------------------------------------------------


class _RasterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, sorted_gid, ranges, grid_x, chunk, nfeat,
                carry_depth):
        if attrs.is_cuda:
            color, aux = raster_fwd_cuda(
                attrs, sorted_gid, ranges, grid_x, chunk, carry_depth
            )
        else:
            color, aux, _ = raster_fwd_plain(
                attrs, sorted_gid, ranges, grid_x, chunk, carry_depth
            )
        ctx.save_for_backward(attrs, sorted_gid, ranges, color, aux)
        ctx.args = (grid_x, chunk, nfeat, carry_depth)
        return color, aux

    @staticmethod
    def backward(ctx, g_color, g_aux):
        attrs, sorted_gid, ranges, color, aux = ctx.saved_tensors
        grid_x, chunk, nfeat, carry_depth = ctx.args
        g_color = (torch.zeros_like(color) if g_color is None
                   else g_color.contiguous())
        g_aux = torch.zeros_like(aux) if g_aux is None else g_aux.contiguous()
        bwd = raster_bwd_cuda if attrs.is_cuda else raster_bwd_plain
        grad = bwd(attrs, sorted_gid, ranges, grid_x, chunk, color, aux,
                   g_color, g_aux, nfeat, carry_depth)
        return grad, None, None, None, None, None, None


def rasterize_tiles(
    attrs: torch.Tensor,  # (N, ROWS) from pack_attrs
    binned: Binned,
    grid_x: int,
    chunk: int,
    nfeat: int = NFEAT_PAD - 2,
    carry_depth: bool = True,
) -> RasterOut:
    """Differentiable compositing of every tile (B1 forward, B2 backward).

    ``nfeat`` bounds the feature gradient rows and ``carry_depth=False``
    drops the median-depth row and zeroes its primal (aux row 0): legal only
    when the caller's loss has zero cotangents there."""
    color, aux = _RasterFn.apply(
        attrs.contiguous(), binned.sorted_gid, binned.ranges, grid_x, chunk,
        nfeat, carry_depth,
    )
    return RasterOut(color=color, aux=aux)
