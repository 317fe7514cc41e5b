"""Tile compositing: the kernels B1/B2 and B3a-d, their plain versions,
and autograd; the Fisher moments kernel B4; and the build and launch
counters of every kernel, the measurement probes P1-P4 included.

Counterpart of ``splatam_tpu/render/pallas_raster.py``. The differentiable
boundary is the per-gaussian (N, 16) attribute table (``pack_attrs``), as in
the JAX package's ``_make_raster_fn`` / ``_make_raster_fn_split``: the
forward returns channel-major ``color`` and ``aux`` blocks (T, 8, 256), the
backward returns (N, 16) per-gaussian gradients. Two stream layouts
(render/binning.py):

- aligned (``Binned``): B1 forward, B2 backward, one tile range each
  (``csrc/raster_fwd.cu``, ``csrc/raster_bwd.cu``);
- split (``BinnedSplit``): B3a interior forward with a per-tile carry, B3b
  residue-pair tail forward seeded from it, which on the card finishes its
  tiles' outputs in place (the plain versions write pair blocks, composed
  by ``compose_split``); B3c interior backward with its own carry, B3d
  tail backward (``csrc/raster_split_fwd.cu``, ``csrc/raster_split_bwd.cu``).

B4 (``csrc/raster_fisher.cu``, ``fisher_moments``) replays the aligned
forward under a constant seed cotangent and sums squared per-pixel
gradients per gaussian: the diagonal Fisher of active view selection.

On a CUDA tensor every wrapper launches its hand-written kernel (built with
nvcc at first use, bound with ctypes); a failed build or launch raises. On
a CPU tensor it runs the plain version, the same arithmetic in tensor ops,
which the tests also hold against the JAX package and ``chip_smoke.py``
holds the kernels against on the card.
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

from splatam_torch.render.binning import Binned, BinnedSplit
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
KERNEL_SOURCES = ("raster_fwd", "raster_bwd", "raster_split_fwd",
                  "raster_split_bwd", "raster_fisher",
                  # the measurement probes P1-P4 (splatam_torch/bench/)
                  "probe_ablate", "probe_ops", "probe_ilp", "probe_step",
                  # B1's stage probe (bench/fwd_stages.py; no TPU kernel)
                  "probe_fwd")
# per-tile carries of the split layout, channel-major (T, rows, NPIX)
FWD_CARRY_ROWS = 3  # signed T (negative = dead), median-depth sum, sat cand
BWD_CARRY_ROWS = 2  # signed T, running prefix of w * gc
# B4's moment rows: the upper triangle of sum_p v v^T over the screen
# quantities v = (x, y, conic a, b, c) in (a, b) order, then sum_p dop^2
TRI_PAIRS = tuple((a, b) for a in range(5) for b in range(a, 5))
FISHER_ROWS = len(TRI_PAIRS) + 1


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
# raster_split_int_fwd(attrs, gid, int_ranges, num_tiles, grid_x, chunk,
#                      carry_depth, color, aux, carry, stream)
SPLIT_INT_FWD_KERNEL = CudaKernel("raster_split_fwd", "raster_split_int_fwd",
                                  3, 4, 3)
# raster_split_tail_fwd(attrs, gid, tmeta, tsl, tbt, carry, num_tail,
#                       tail_base, grid_x, chunk, carry_depth, color, aux,
#                       stream)
SPLIT_TAIL_FWD_KERNEL = CudaKernel("raster_split_fwd",
                                   "raster_split_tail_fwd", 6, 5, 2)
# raster_split_int_bwd(attrs, gid, int_ranges, num_tiles, grid_x, chunk,
#                      nfeat, carry_depth, color, aux, g_color, g_aux, grad,
#                      bcarry, stream)
SPLIT_INT_BWD_KERNEL = CudaKernel("raster_split_bwd", "raster_split_int_bwd",
                                  3, 5, 6)
# raster_split_tail_bwd(attrs, gid, tmeta, tsl, tbt, bcarry, num_tail,
#                       tail_base, grid_x, chunk, nfeat, carry_depth, color,
#                       aux, g_color, g_aux, grad, stream)
SPLIT_TAIL_BWD_KERNEL = CudaKernel("raster_split_bwd",
                                   "raster_split_tail_bwd", 6, 6, 5)
# raster_fisher(attrs, gid, ranges, num_tiles, grid_x, chunk, color, seed,
#               mom, stream)
FISHER_KERNEL = CudaKernel("raster_fisher", "raster_fisher", 3, 3, 3)
# The probes' wrappers and plain versions live in splatam_torch/bench/.
# probe_ablate(attrs, gid, ranges, stage, num_tiles, grid_x, chunk, nfeat,
#              carry_depth, color, aux, g_color, g_aux, pix, grad, stream)
ABLATE_KERNEL = CudaKernel("probe_ablate", "probe_ablate", 3, 6, 6)
# probe_ops(x, op, bf16, reps, steps, chunk, out, stream)
OPS_KERNEL = CudaKernel("probe_ops", "probe_ops", 1, 5, 1)
# probe_ilp(a, b, case, reps, steps, oa, ob, stream)
ILP_KERNEL = CudaKernel("probe_ilp", "probe_ilp", 2, 3, 2)
# probe_step(stream, blk, body, steps, out, stream)
STEP_KERNEL = CudaKernel("probe_step", "probe_step", 2, 2, 1)
KERNELS = {
    "B1": FWD_KERNEL, "B2": BWD_KERNEL, "B3a": SPLIT_INT_FWD_KERNEL,
    "B3b": SPLIT_TAIL_FWD_KERNEL, "B3c": SPLIT_INT_BWD_KERNEL,
    "B3d": SPLIT_TAIL_BWD_KERNEL, "B4": FISHER_KERNEL,
    "P1": ABLATE_KERNEL, "P2": OPS_KERNEL, "P3": ILP_KERNEL,
    "P4": STEP_KERNEL,
}


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


def _check_grad_inputs(t, color, aux, g_color, g_aux, nfeat):
    for name, x in (("color", color), ("aux", aux), ("g_color", g_color),
                    ("g_aux", g_aux)):
        _check(x, name, torch.float32, (t, NFEAT_PAD, NPIX))
    if not 0 <= nfeat <= NFEAT_PAD:
        raise ValueError(f"nfeat must be in [0, {NFEAT_PAD}], got {nfeat}")


def _check_aligned(attrs):
    if attrs.data_ptr() % 16:  # the forward gathers its rows as float4s
        raise ValueError("attrs must be 16-byte aligned")


def raster_fwd_cuda(attrs, sorted_gid, ranges, grid_x, chunk, carry_depth=True):
    """Launch B1. Returns (color, aux), each (T, 8, NPIX)."""
    _check_common(attrs, sorted_gid, ranges, chunk)
    _check_aligned(attrs)
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
    _check_grad_inputs(t, color, aux, g_color, g_aux, nfeat)
    grad = torch.zeros_like(attrs)
    BWD_KERNEL.launch(
        attrs.device, attrs.data_ptr(), sorted_gid.data_ptr(),
        ranges.data_ptr(), t, grid_x, chunk, nfeat, int(carry_depth),
        color.data_ptr(), aux.data_ptr(), g_color.data_ptr(),
        g_aux.data_ptr(), grad.data_ptr(),
    )
    return grad


def _tail_args(binned: BinnedSplit, chunk: int):
    nct = binned.tmeta.shape[0]
    for name in ("tmeta", "tsl", "tbt"):
        _check(getattr(binned, name), name, torch.int32, (nct,))
    return nct, binned.chunk_meta.shape[0] * chunk


def raster_split_int_fwd_cuda(attrs, binned: BinnedSplit, grid_x, chunk,
                              carry_depth=True):
    """Launch B3a. Returns (color, aux, carry): B1's outputs for each
    tile's interior range, and the (T, FWD_CARRY_ROWS, NPIX) carry."""
    _check_common(attrs, binned.sorted_gid, binned.int_ranges, chunk)
    _check_aligned(attrs)
    t = binned.int_ranges.shape[0]
    color = torch.empty((t, NFEAT_PAD, NPIX), dtype=torch.float32,
                        device=attrs.device)
    aux = torch.empty_like(color)
    carry = torch.empty((t, FWD_CARRY_ROWS, NPIX), dtype=torch.float32,
                        device=attrs.device)
    SPLIT_INT_FWD_KERNEL.launch(
        attrs.device, attrs.data_ptr(), binned.sorted_gid.data_ptr(),
        binned.int_ranges.data_ptr(), t, grid_x, chunk, int(carry_depth),
        color.data_ptr(), aux.data_ptr(), carry.data_ptr(),
    )
    return color, aux, carry


def raster_split_tail_fwd_cuda(attrs, binned: BinnedSplit, carry, grid_x,
                               chunk, color, aux, carry_depth=True):
    """Launch B3b (not at all when there is no tail chunk) on B3a's
    ``color`` and ``aux`` (T, 8, NPIX), which it finishes in place: each
    tail segment adds its color into its tile's and writes the tile's aux
    rows 0-2. Returns (color, aux): ``compose_split`` of the plain B3a's
    and B3b's outputs."""
    _check_common(attrs, binned.sorted_gid, binned.int_ranges, chunk)
    _check_aligned(attrs)
    nct, tail_base = _tail_args(binned, chunk)
    t = binned.int_ranges.shape[0]
    _check(carry, "carry", torch.float32, (t, FWD_CARRY_ROWS, NPIX))
    for name, x in (("color", color), ("aux", aux)):
        _check(x, name, torch.float32, (t, NFEAT_PAD, NPIX))
    if nct:
        SPLIT_TAIL_FWD_KERNEL.launch(
            attrs.device, attrs.data_ptr(), binned.sorted_gid.data_ptr(),
            binned.tmeta.data_ptr(), binned.tsl.data_ptr(),
            binned.tbt.data_ptr(), carry.data_ptr(), nct, tail_base, grid_x,
            chunk, int(carry_depth), color.data_ptr(), aux.data_ptr(),
        )
    return color, aux


def raster_split_fwd_cuda(attrs, binned: BinnedSplit, grid_x, chunk,
                          carry_depth=True):
    """The split forward on the card: B3a, then B3b in place on its
    outputs. Returns (color, aux, carry): the tiles' final outputs and
    B3a's carry."""
    color, aux, carry = raster_split_int_fwd_cuda(attrs, binned, grid_x,
                                                  chunk, carry_depth)
    raster_split_tail_fwd_cuda(attrs, binned, carry, grid_x, chunk, color,
                               aux, carry_depth)
    return color, aux, carry


def raster_split_int_bwd_cuda(attrs, binned: BinnedSplit, grid_x, chunk,
                              color, aux, g_color, g_aux, nfeat,
                              carry_depth=True, grad=None):
    """Launch B3c on the composed outputs ``color``/``aux``. Adds into
    ``grad`` (a fresh zero table when None); returns (grad, the
    (T, BWD_CARRY_ROWS, NPIX) backward carry)."""
    _check_common(attrs, binned.sorted_gid, binned.int_ranges, chunk)
    t = binned.int_ranges.shape[0]
    _check_grad_inputs(t, color, aux, g_color, g_aux, nfeat)
    grad = torch.zeros_like(attrs) if grad is None else grad
    _check(grad, "grad", torch.float32, attrs.shape)
    bcarry = torch.empty((t, BWD_CARRY_ROWS, NPIX), dtype=torch.float32,
                         device=attrs.device)
    SPLIT_INT_BWD_KERNEL.launch(
        attrs.device, attrs.data_ptr(), binned.sorted_gid.data_ptr(),
        binned.int_ranges.data_ptr(), t, grid_x, chunk, nfeat,
        int(carry_depth), color.data_ptr(), aux.data_ptr(),
        g_color.data_ptr(), g_aux.data_ptr(), grad.data_ptr(),
        bcarry.data_ptr(),
    )
    return grad, bcarry


def raster_split_tail_bwd_cuda(attrs, binned: BinnedSplit, bcarry, grid_x,
                               chunk, color, aux, g_color, g_aux, nfeat,
                               carry_depth=True, grad=None):
    """Launch B3d (not at all when there is no tail chunk), adding into
    ``grad`` (a fresh zero table when None). Returns grad."""
    _check_common(attrs, binned.sorted_gid, binned.int_ranges, chunk)
    nct, tail_base = _tail_args(binned, chunk)
    t = binned.int_ranges.shape[0]
    _check_grad_inputs(t, color, aux, g_color, g_aux, nfeat)
    _check(bcarry, "bcarry", torch.float32, (t, BWD_CARRY_ROWS, NPIX))
    grad = torch.zeros_like(attrs) if grad is None else grad
    _check(grad, "grad", torch.float32, attrs.shape)
    if nct:
        SPLIT_TAIL_BWD_KERNEL.launch(
            attrs.device, attrs.data_ptr(), binned.sorted_gid.data_ptr(),
            binned.tmeta.data_ptr(), binned.tsl.data_ptr(),
            binned.tbt.data_ptr(), bcarry.data_ptr(), nct, tail_base, grid_x,
            chunk, nfeat, int(carry_depth), color.data_ptr(), aux.data_ptr(),
            g_color.data_ptr(), g_aux.data_ptr(), grad.data_ptr(),
        )
    return grad


def fisher_moments_cuda(attrs, sorted_gid, ranges, grid_x, chunk, color,
                       seed):
    """Launch B4 on the forward's ``color`` blocks (T, 8, NPIX) under the
    per-channel ``seed`` (8,). Returns the (N, FISHER_ROWS) moment table."""
    _check_common(attrs, sorted_gid, ranges, chunk)
    t = ranges.shape[0]
    _check(color, "color", torch.float32, (t, NFEAT_PAD, NPIX))
    _check(seed, "seed", torch.float32, (NFEAT_PAD,))
    mom = torch.zeros((attrs.shape[0], FISHER_ROWS), dtype=torch.float32,
                      device=attrs.device)
    FISHER_KERNEL.launch(
        attrs.device, attrs.data_ptr(), sorted_gid.data_ptr(),
        ranges.data_ptr(), t, grid_x, chunk, color.data_ptr(),
        seed.data_ptr(), mom.data_ptr(),
    )
    return mom


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in tensor ops, one instance
# position at a time over every segment and pixel at once. A segment is a
# range of the stream composited over one tile's pixels: a tile's whole
# range (B1/B2), its interior (B3a/B3c), or one half of a tail chunk
# (B3b/B3d), then starting from the tile's carry.
# ---------------------------------------------------------------------------


def _pixel_centers(tiles, grid_x: int):
    p = torch.arange(NPIX, device=tiles.device)
    px = ((tiles % grid_x)[:, None] * TILE + (p % TILE)[None, :]).float()
    py = ((tiles // grid_x)[:, None] * TILE + (p // TILE)[None, :]).float()
    return px, py


def _pairs(a, px, py):
    """Per-(instance, pixel) quantities for a (S, C, ROWS) block of
    instances, (S, C, NPIX) each, in the association of raster_common.cuh's
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
    """The transmittance recursion over a (S, C, NPIX) block, one instance
    at a time, as the kernels run it: a pixel dies where T (1 - alpha)
    falls below T_STOP, and then keeps its T. Returns (T before each
    instance, live mask, alive-before mask, T after the block, dead after
    the block)."""
    one_minus = 1 - alpha
    if bool(dead.all()):  # nothing left to composite: skip the walk
        t_before = trans[:, None].expand(alpha.shape)
        none = torch.zeros(alpha.shape, dtype=torch.bool, device=alpha.device)
        return t_before, none, none, trans, dead
    before, deads = [], []
    for j in range(alpha.shape[1]):
        test = trans * one_minus[:, j]
        before.append(trans)
        deads.append(dead)
        dead = dead | (test < T_STOP)
        trans = torch.where(dead, trans, test)
    dead_before = torch.stack(deads, 1)
    t_before = torch.stack(before, 1)
    # live: alive before the instance and still alive after it
    live = ~dead_before & (t_before * one_minus >= T_STOP)
    return t_before, live, ~dead_before, trans, dead


def _blocks(attrs, sorted_gid, ranges, chunk):
    """Yield ((S, C, ROWS) rows, (S, C) gids, (S, C) valid)
    for each batch of ``chunk`` instance positions of every segment's range,
    rows zero past a segment's count."""
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


class _FwdState(NamedTuple):
    """Per-segment forward state: (S, NPIX) T, dead, median-depth sum;
    (S,) tile saturated, its saturation depth, and the largest depth of
    the last batch composited (the carry's saturation candidate)."""

    trans: torch.Tensor
    dead: torch.Tensor
    dsum: torch.Tensor
    saturated: torch.Tensor
    sat: torch.Tensor
    cand: torch.Tensor


def _fresh_fwd(s, attrs) -> _FwdState:
    return _FwdState(
        trans=attrs.new_ones((s, NPIX)),
        dead=torch.zeros((s, NPIX), dtype=torch.bool, device=attrs.device),
        dsum=attrs.new_zeros((s, NPIX)),
        saturated=torch.zeros(s, dtype=torch.bool, device=attrs.device),
        sat=attrs.new_full((s,), SAT_INF),
        cand=attrs.new_zeros((s,)),
    )


def _fwd_segments(attrs, sorted_gid, ranges, tiles, grid_x, chunk,
                  carry_depth, st: _FwdState):
    """Composite every segment from state ``st``. Returns (color, the end
    state, evaluated): ``evaluated`` (S, NPIX) counts the instances each
    pixel evaluates, up to and including the one where it dies. Written
    without in-place ops, so autograd can differentiate it."""
    px, py = _pixel_centers(tiles, grid_x)
    trans, dead, dsum, saturated, sat, cand = st
    color = attrs.new_zeros((tiles.shape[0], NFEAT_PAD, NPIX))
    evaluated = torch.zeros(trans.shape, dtype=torch.int64, device=attrs.device)
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
        # the kernels check for a dead tile after each batch and stop there
        run = valid.any(1) & ~saturated
        batch_max = torch.where(
            valid, depth.detach(), depth.new_full((), -float("inf"))
        ).max(1).values
        cand = torch.where(run, batch_max, cand)
        newly = run & dead.all(1)
        sat = torch.where(newly, batch_max, sat)
        saturated = saturated | newly
    return color, _FwdState(trans, dead, dsum, saturated, sat, cand), evaluated


def _aux_block(st: _FwdState):
    """(S, 8, NPIX) aux: median-depth sum, final T, saturation depth."""
    s = st.trans.shape[0]
    return torch.cat(
        [
            st.dsum[:, None],
            st.trans[:, None],
            st.sat[:, None, None].expand(s, 1, NPIX),
            st.trans.new_zeros((s, 5, NPIX)),
        ],
        dim=1,
    )


def raster_fwd_plain(attrs, sorted_gid, ranges, grid_x, chunk,
                     carry_depth=True):
    """Plain B1. Returns (color, aux, evaluated)."""
    t = ranges.shape[0]
    tiles = torch.arange(t, device=attrs.device)
    color, st, evaluated = _fwd_segments(
        attrs, sorted_gid, ranges, tiles, grid_x, chunk, carry_depth,
        _fresh_fwd(t, attrs),
    )
    return color, _aux_block(st), evaluated


def _ga_gdep(color, aux, g_color, g_aux):
    """(T, NPIX) per-pixel backward constants from a tile's final outputs:
    ga (final-T term plus sum of color * dL/dcolor) and dL/d median depth."""
    return (g_aux[:, 1] * aux[:, 1] + (color * g_color).sum(dim=1),
            g_aux[:, 0])


def _bwd_segments(attrs, sorted_gid, ranges, tiles, grid_x, chunk, g_color,
                  ga, gdep, nfeat, carry_depth, grad, trans, dead, accw):
    """The analytic backward (raster_common.cuh's bwd_pair) of every
    segment, from the state (T, dead, prefix of w * gc), with per-segment
    constants ``g_color`` (S, 8, NPIX), ``ga``/``gdep`` (S, NPIX). Adds the
    per-instance rows into ``grad`` in place; returns the end state."""
    dev = attrs.device
    px, py = _pixel_centers(tiles, grid_x)
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
    return trans, dead, accw


def _fresh_bwd(s, attrs):
    return (attrs.new_ones((s, NPIX)),
            torch.zeros((s, NPIX), dtype=torch.bool, device=attrs.device),
            attrs.new_zeros((s, NPIX)))


def raster_bwd_plain(attrs, sorted_gid, ranges, grid_x, chunk, color, aux,
                     g_color, g_aux, nfeat, carry_depth=True):
    """Plain B2: the same analytic backward as the kernel, in tensor ops.
    Returns the (N, 16) per-gaussian gradient table."""
    t = ranges.shape[0]
    grad = torch.zeros_like(attrs)
    _bwd_segments(attrs, sorted_gid, ranges, torch.arange(t, device=attrs.device),
                  grid_x, chunk, g_color, *_ga_gdep(color, aux, g_color, g_aux),
                  nfeat, carry_depth, grad, *_fresh_bwd(t, attrs))
    return grad


def _signed(trans, dead):
    return torch.where(dead, -trans, trans)


def _tail_segments(binned: BinnedSplit, chunk: int):
    """The tail chunks' segments, A then B of each chunk (segment 2c + role):
    (2 NCt,) tiles, (2 NCt, 2) stream ranges, (2 NCt,) has-interior flags."""
    nct = binned.tmeta.shape[0]
    dev = binned.tmeta.device
    sl = binned.tsl.long()
    send, lim = sl >> 16, sl & 0xFFFF
    c0 = binned.chunk_meta.shape[0] * chunk + torch.arange(nct, device=dev) * chunk
    ranges = torch.stack([c0, c0 + send, c0 + send, c0 + lim], -1).reshape(-1, 2)
    meta = torch.stack([binned.tmeta, binned.tbt], -1).reshape(-1).long()
    return meta >> 1, ranges, (meta & 1).bool()


def raster_split_int_fwd_plain(attrs, binned: BinnedSplit, grid_x, chunk,
                               carry_depth=True):
    """Plain B3a. Returns (color, aux, carry, evaluated)."""
    t = binned.int_ranges.shape[0]
    tiles = torch.arange(t, device=attrs.device)
    color, st, evaluated = _fwd_segments(
        attrs, binned.sorted_gid, binned.int_ranges, tiles, grid_x, chunk,
        carry_depth, _fresh_fwd(t, attrs),
    )
    carry = torch.stack(
        [_signed(st.trans, st.dead), st.dsum, st.cand[:, None].expand(t, NPIX)],
        dim=1,
    )
    return color, _aux_block(st), carry, evaluated


def raster_split_tail_fwd_plain(attrs, binned: BinnedSplit, carry, grid_x,
                                chunk, carry_depth=True):
    """Plain B3b. Returns (colorp, auxp, evaluated); colorp and auxp are
    (NCt, 2, 8, NPIX), zero in the B half of a single-residue chunk."""
    tiles, ranges, has_int = _tail_segments(binned, chunk)
    c = carry[tiles]
    hi = has_int[:, None]
    dead = hi & (c[:, 0] < 0)
    cand = torch.where(has_int, c[:, 2, 0], c.new_zeros(()))
    saturated = dead.all(1)
    st = _FwdState(
        trans=torch.where(hi, c[:, 0].abs(), c.new_ones(())),
        dead=dead,
        dsum=torch.where(hi, c[:, 1], c.new_zeros(())),
        saturated=saturated,
        sat=torch.where(saturated, cand, c.new_full((), SAT_INF)),
        cand=cand,
    )
    color, st, evaluated = _fwd_segments(
        attrs, binned.sorted_gid, ranges, tiles, grid_x, chunk, carry_depth, st
    )
    used = (ranges[:, 1] > ranges[:, 0])[:, None, None]
    shape = (-1, 2, NFEAT_PAD, NPIX)
    zero = color.new_zeros(())
    return (torch.where(used, color, zero).reshape(shape),
            torch.where(used, _aux_block(st), zero).reshape(shape), evaluated)


def compose_split(binned: BinnedSplit, color_i, aux_i, colorp, auxp):
    """Per-tile final outputs of the split render (pallas_raster.py:1781)
    from the plain versions' outputs: color is the interior's plus the tail
    segment's contribution; aux is the tail's where the tile has one, else
    the interior's, else that of an empty tile (T 1, never saturated). The
    CPU path's compose, and the reference of B3b's in-place write."""
    zero = color_i.new_zeros(())
    mi = binned.mask_int[:, None, None]
    color = torch.where(mi, color_i, zero)
    empty = torch.zeros_like(aux_i[:1])
    empty[:, 1] = 1.0
    empty[:, 2] = SAT_INF
    aux = torch.where(mi, aux_i, empty)
    if colorp.shape[0]:
        ht = (binned.mask_a | binned.mask_b)[:, None, None]
        idx = (binned.tail_cid * 2 + binned.tail_role).long()
        color = color + torch.where(
            ht, colorp.reshape(-1, NFEAT_PAD, NPIX)[idx], zero)
        aux = torch.where(ht, auxp.reshape(-1, 8, NPIX)[idx], aux)
    return color, aux


def raster_split_int_bwd_plain(attrs, binned: BinnedSplit, grid_x, chunk,
                               color, aux, g_color, g_aux, nfeat,
                               carry_depth=True, grad=None):
    """Plain B3c. Returns (grad, backward carry)."""
    t = binned.int_ranges.shape[0]
    grad = torch.zeros_like(attrs) if grad is None else grad
    trans, dead, accw = _bwd_segments(
        attrs, binned.sorted_gid, binned.int_ranges,
        torch.arange(t, device=attrs.device), grid_x, chunk, g_color,
        *_ga_gdep(color, aux, g_color, g_aux), nfeat, carry_depth, grad,
        *_fresh_bwd(t, attrs),
    )
    return grad, torch.stack([_signed(trans, dead), accw], dim=1)


def raster_split_tail_bwd_plain(attrs, binned: BinnedSplit, bcarry, grid_x,
                                chunk, color, aux, g_color, g_aux, nfeat,
                                carry_depth=True, grad=None):
    """Plain B3d. Returns grad."""
    tiles, ranges, has_int = _tail_segments(binned, chunk)
    grad = torch.zeros_like(attrs) if grad is None else grad
    ga, gdep = _ga_gdep(color, aux, g_color, g_aux)
    c = bcarry[tiles]
    hi = has_int[:, None]
    _bwd_segments(
        attrs, binned.sorted_gid, ranges, tiles, grid_x, chunk, g_color[tiles],
        ga[tiles], gdep[tiles], nfeat, carry_depth, grad,
        torch.where(hi, c[:, 0].abs(), c.new_ones(())), hi & (c[:, 0] < 0),
        torch.where(hi, c[:, 1], c.new_zeros(())),
    )
    return grad


def fisher_moments_plain(attrs, sorted_gid, ranges, grid_x, chunk, color,
                        seed):
    """Plain B4: the same replay and squared per-pixel gradients as the
    kernel, in tensor ops. Returns the (N, FISHER_ROWS) moment table."""
    t = ranges.shape[0]
    tiles = torch.arange(t, device=attrs.device)
    px, py = _pixel_centers(tiles, grid_x)
    gtot = (color * seed[None, :, None]).sum(dim=1)  # (T, NPIX)
    trans, dead, accw = _fresh_bwd(t, attrs)
    mom = attrs.new_zeros((attrs.shape[0], FISHER_ROWS))
    for rows, gid, valid in _blocks(attrs, sorted_gid, ranges, chunk):
        dx, dy, praw, epow, raw, alpha = _pairs(rows, px, py)
        t_before, live, _, trans, dead = _replay(alpha, trans, dead)
        zero = torch.zeros_like(alpha)
        gc = (rows[..., ROW_FEAT0:] * seed).sum(-1)[..., None]  # (S, C, 1)
        w = torch.where(live, alpha * t_before, zero)
        prefix = accw[:, None] + torch.cumsum(w * gc, dim=1)
        accw = prefix[:, -1]
        dalpha = torch.where(
            live, t_before * gc - (gtot[:, None] - prefix) / (1 - alpha), zero
        )
        unclamped = (raw >= ALPHA_MIN) & (raw < ALPHA_CAP)
        dop = torch.where(unclamped, dalpha * epow, zero)
        dpower = torch.where(unclamped & (praw <= 0), dalpha * alpha, zero)
        ca = rows[..., ROW_CA, None]
        cb = rows[..., ROW_CB, None]
        cc = rows[..., ROW_CC, None]
        v = (
            dpower * -(ca * dx + cb * dy),
            dpower * -(cc * dy + cb * dx),
            dpower * (-0.5 * (dx * dx)),
            dpower * -(dx * dy),
            dpower * (-0.5 * (dy * dy)),
        )
        m = torch.stack(
            [(v[a] * v[b]).sum(-1) for a, b in TRI_PAIRS]
            + [(dop * dop).sum(-1)], dim=-1,
        )
        mom.index_add_(0, gid[valid], m[valid])
    return mom


def fisher_moments(attrs, binned: Binned, grid_x: int, chunk: int,
                   seed: torch.Tensor, tile_color=None) -> torch.Tensor:
    """Per-gaussian (N, FISHER_ROWS) squared-gradient moments under the
    per-channel backward ``seed`` (8,), on an aligned binning: B4 on a CUDA
    tensor, its plain version on a CPU one
    (``pallas_raster.py::fisher_moments``).

    ``tile_color`` passes the (T, 8, NPIX) forward color blocks of a render
    at this pose and binning (the gains path's silhouette render) and saves
    this function's own forward (B1); the seed weights only channels that
    both renders compute alike."""
    if not isinstance(binned, Binned):
        raise ValueError("fisher_moments needs an aligned binning (Binned)")
    attrs = attrs.contiguous()
    seed = seed.to(device=attrs.device, dtype=torch.float32).contiguous()
    args = (attrs, binned.sorted_gid, binned.ranges, grid_x, chunk)
    if tile_color is not None:
        color = tile_color.contiguous()
    elif attrs.is_cuda:
        color, _ = raster_fwd_cuda(*args, carry_depth=False)
    else:
        color, _, _ = raster_fwd_plain(*args, carry_depth=False)
    fn = fisher_moments_cuda if attrs.is_cuda else fisher_moments_plain
    return fn(*args, color, seed)


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
        g_color, g_aux = _cotangents(color, aux, g_color, g_aux)
        bwd = raster_bwd_cuda if attrs.is_cuda else raster_bwd_plain
        grad = bwd(attrs, sorted_gid, ranges, grid_x, chunk, color, aux,
                   g_color, g_aux, nfeat, carry_depth)
        return grad, None, None, None, None, None, None


def _cotangents(color, aux, g_color, g_aux):
    return ((torch.zeros_like(color) if g_color is None
             else g_color.contiguous()),
            torch.zeros_like(aux) if g_aux is None else g_aux.contiguous())


class _RasterSplitFn(torch.autograd.Function):
    """B3a + B3b forward (composed by ``compose_split`` on the CPU); B3c +
    B3d backward into one table."""

    @staticmethod
    def forward(ctx, attrs, binned, grid_x, chunk, nfeat, carry_depth):
        if attrs.is_cuda:
            color, aux, _ = raster_split_fwd_cuda(attrs, binned, grid_x, chunk,
                                                  carry_depth)
        else:
            color_i, aux_i, carry, _ = raster_split_int_fwd_plain(
                attrs, binned, grid_x, chunk, carry_depth)
            colorp, auxp, _ = raster_split_tail_fwd_plain(
                attrs, binned, carry, grid_x, chunk, carry_depth)
            color, aux = compose_split(binned, color_i, aux_i, colorp, auxp)
        ctx.save_for_backward(attrs, color, aux)
        ctx.binned = binned
        ctx.args = (grid_x, chunk, nfeat, carry_depth)
        return color, aux

    @staticmethod
    def backward(ctx, g_color, g_aux):
        attrs, color, aux = ctx.saved_tensors
        grid_x, chunk, nfeat, carry_depth = ctx.args
        g_color, g_aux = _cotangents(color, aux, g_color, g_aux)
        if attrs.is_cuda:
            int_bwd, tail_bwd = raster_split_int_bwd_cuda, raster_split_tail_bwd_cuda
        else:
            int_bwd, tail_bwd = raster_split_int_bwd_plain, raster_split_tail_bwd_plain
        args = (grid_x, chunk, color, aux, g_color, g_aux, nfeat, carry_depth)
        grad, bcarry = int_bwd(attrs, ctx.binned, *args)
        grad = tail_bwd(attrs, ctx.binned, bcarry, *args, grad=grad)
        return grad, None, None, None, None, None


def rasterize_tiles(
    attrs: torch.Tensor,  # (N, ROWS) from pack_attrs
    binned: Binned | BinnedSplit,
    grid_x: int,
    chunk: int,
    nfeat: int = NFEAT_PAD - 2,
    carry_depth: bool = True,
) -> RasterOut:
    """Differentiable compositing of every tile, in the binning's layout:
    B1 forward and B2 backward (``Binned``), or B3a/B3b forward and B3c/B3d
    backward (``BinnedSplit``).

    ``nfeat`` bounds the feature gradient rows and ``carry_depth=False``
    drops the median-depth row and zeroes its primal (aux row 0): legal only
    when the caller's loss has zero cotangents there."""
    if isinstance(binned, BinnedSplit):
        color, aux = _RasterSplitFn.apply(
            attrs.contiguous(), binned, grid_x, chunk, nfeat, carry_depth)
    else:
        color, aux = _RasterFn.apply(
            attrs.contiguous(), binned.sorted_gid, binned.ranges, grid_x,
            chunk, nfeat, carry_depth,
        )
    return RasterOut(color=color, aux=aux)
