"""B1's stage table: the forward pass taken apart stage by stage.

Kernel ``render/csrc/probe_fwd.cu`` runs B1's pass, built from B1's own
helpers, cut after each stage of ``STAGES`` (staging, + alpha, + scan,
+ blend = B1). It runs on the stream that ``chip_smoke.py``'s
``[timing]`` gives B1: the benchmark's scene (``bench.scene.setup``) in
the aligned layout at chunk ``CHUNK``, untrimmed, with the six mapping
channels and no median depth. Successive differences price the stages;
each stage's registers per thread and resident blocks per SM are the
runtime's (``cudaFuncGetAttributes``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); B1 itself
(``raster_fwd.cu``) closes the table, read the same way, so that ``blend``
can be held to it. The ``blend`` stage
is held to B1's plain version (color 1e-5 + 1e-4 rel, final T 2e-5,
saturation depth exact) before it is timed; ``warp_slots`` counts the
work B1 does on the stream. A measurement probe, not a port of a TPU
kernel: it runs on no main path, and on the card only.

Usage: python -m splatam_torch.bench.fwd_stages [--iters 20] [--n N]
  [--w W] [--h H]
"""
from __future__ import annotations

import argparse
import ctypes

import torch

from splatam_torch.bench.scene import setup
from splatam_torch.bench.timing import device_name, time_ms
from splatam_torch.render import raster

STAGES = ("staging", "alpha", "scan", "blend")
CHUNK = 128  # probe_fwd.cu's CHUNK
WHAT = {
    "staging": "every batch staged into shared memory",
    "alpha": "eval_pair's alpha, every pair of the range",
    "scan": "transmittance, pixel death, the tile's exit",
    "blend": "the 8-channel blend: B1's loop",
    "B1": "B1 itself (raster_fwd.cu), against blend",
}
# probe_fwd(attrs, gid, ranges, num_tiles, grid_x, stage, color, aux, stream)
PROBE_KERNEL = raster.CudaKernel("probe_fwd", "probe_fwd", 3, 3, 2)


def stage_cuda(stage: str, attrs, binned, grid_x):
    """Launch the probe's ``stage`` at chunk CHUNK (no median depth).
    Returns (color, aux), each (T, 8, NPIX); before ``blend`` color row 0
    holds the stage's per-pixel sum and the other rows are zero."""
    raster._check_common(attrs, binned.sorted_gid, binned.ranges, CHUNK)
    raster._check_aligned(attrs)
    t = binned.ranges.shape[0]
    color = attrs.new_empty((t, raster.NFEAT_PAD, raster.NPIX))
    aux = torch.empty_like(color)
    PROBE_KERNEL.launch(
        attrs.device, attrs.data_ptr(), binned.sorted_gid.data_ptr(),
        binned.ranges.data_ptr(), t, grid_x, STAGES.index(stage),
        color.data_ptr(), aux.data_ptr())
    return color, aux


def check_blend(attrs, binned, grid_x):
    """Hold the ``blend`` stage to B1's plain version."""
    c0, a0, _ = raster.raster_fwd_plain(attrs, binned.sorted_gid,
                                        binned.ranges, grid_x, CHUNK, False)
    c1, a1 = stage_cuda("blend", attrs, binned, grid_x)
    if not (torch.allclose(c1, c0, atol=1e-5, rtol=1e-4)
            and torch.allclose(a1[:, 1], a0[:, 1], atol=2e-5, rtol=1e-4)
            and torch.equal(a1[:, 2:], a0[:, 2:])):
        raise RuntimeError("probe_fwd blend: differs from B1's plain version")


def occupancy(stage: str) -> tuple[int, int]:
    """(registers per thread, resident blocks per SM) of ``stage``'s
    kernel, or of B1 itself at chunk CHUNK with no median depth (``"B1"``),
    on the current card, from the CUDA runtime. Both libraries export
    ``<entry>_occupancy(int, int* regs, int* blocks)``: the int is the
    probe's stage, or B1's chunk."""
    kernel, index = ((raster.FWD_KERNEL, CHUNK) if stage == "B1"
                     else (PROBE_KERNEL, STAGES.index(stage)))
    kernel._entry()  # builds the library
    lib = ctypes.CDLL(str(raster._library_path(kernel.source)))
    fn = getattr(lib, f"{kernel.symbol}_occupancy")
    ptr = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int, ptr, ptr]
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    rc = fn(index, ctypes.byref(regs), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")
    return regs.value, blocks.value


def warp_slots(attrs, binned, grid_x, chunk) -> dict:
    """B1's work on this stream as counts, from its plain version's
    arithmetic (``raster._pairs``, ``raster._replay``): the (pixel,
    instance) pairs evaluated and the share with alpha below 1/255; the
    warp slots (a warp's 32 pixels and one instance, while any of its
    pixels is alive; the tile stops after the batch in which its last
    pixel died), the share in which some pixel adds to the blend, the
    share in which no live pixel reaches 1/255, and the lane-pairs the
    slots hold per evaluated pair; and the tile ranges' length (max, mean
    over all tiles, p99)."""
    t = binned.ranges.shape[0]
    tiles = torch.arange(t, device=attrs.device)
    px, py = raster._pixel_centers(tiles, grid_x)
    trans, dead = attrs.new_ones((t, raster.NPIX)), torch.zeros(
        (t, raster.NPIX), dtype=torch.bool, device=attrs.device)
    stopped = torch.zeros(t, dtype=torch.bool, device=attrs.device)
    n = dict(pairs=0, faint=0, slots=0, blend=0, none_live=0)
    for rows, _, valid in raster._blocks(attrs, binned.sorted_gid,
                                         binned.ranges, chunk):
        alpha = raster._pairs(rows, px, py)[-1]
        _, live, alive, trans, dead = raster._replay(alpha, trans, dead)
        run = (valid & ~stopped[:, None])[..., None]  # (T, C, 1)
        alive = alive & run
        n["pairs"] += int(alive.sum())
        n["faint"] += int((alive & (alpha == 0)).sum())
        warp = (t, alive.shape[1], raster.NPIX // 32, 32)
        slot = alive.reshape(warp).any(-1)
        adds = (live & run & (alpha > 0)).reshape(warp).any(-1)
        reach = (alive & (alpha > 0)).reshape(warp).any(-1)
        n["slots"] += int(slot.sum())
        n["blend"] += int(adds.sum())
        n["none_live"] += int((slot & ~reach).sum())
        stopped = stopped | (valid.any(1) & dead.all(1))
    length = (binned.ranges[:, 1] - binned.ranges[:, 0]).float()
    return dict(
        n, faint_share=n["faint"] / max(n["pairs"], 1),
        blend_share=n["blend"] / max(n["slots"], 1),
        none_live_share=n["none_live"] / max(n["slots"], 1),
        lane_pairs_per_pair=32 * n["slots"] / max(n["pairs"], 1),
        range_max=int(length.max()), range_mean=float(length.mean()),
        range_p99=float(torch.quantile(length, 0.99)))


def run(n=200_000, w=1200, h=680, iters=20):
    """Time every stage, then B1. Prints the table; returns {stage or
    ``"B1"``: ms per pass} with the tile count under ``"tiles"`` and
    ``warp_slots``' counts under ``"counts"``."""
    prog = setup(f"aligned+c{CHUNK}+notrim", n=n, w=w, h=h)
    attrs, binned, grid_x = prog.stream_inputs()
    dev = attrs.device
    tiles = binned.ranges.shape[0]
    check_blend(attrs, binned, grid_x)
    ms = {s: time_ms(lambda s=s: stage_cuda(s, attrs, binned, grid_x),
                     iters, dev)
          for s in STAGES}
    ms["B1"] = time_ms(lambda: raster.raster_fwd_cuda(
        attrs, binned.sorted_gid, binned.ranges, grid_x, CHUNK, False),
        iters, dev)
    print(f"[fwd_stages] {device_name(dev)}: B1 stage ablation, {n} gaussians "
          f"at {w}x{h}, aligned, chunk {CHUNK}, untrimmed, "
          f"K={binned.num_instances}, {tiles} tile blocks, {iters} passes",
          flush=True)
    print(f"[fwd_stages] {'stage':8s} {'ms/pass':>9s} {'ns/block':>9s} "
          f"{'delta':>8s} {'regs':>4s} {'blocks/SM':>9s}  what the stage adds",
          flush=True)
    prev = None
    for s in STAGES + ("B1",):
        ns = ms[s] * 1e6 / tiles
        delta = "" if prev is None else f"{ns - prev:+8.1f}"
        regs, blocks = occupancy(s)
        print(f"[fwd_stages] {s:8s} {ms[s]:9.4f} {ns:9.1f} {delta:>8s} "
              f"{regs:4d} {blocks:9d}  {WHAT[s]}", flush=True)
        prev = ns
    c = warp_slots(attrs, binned, grid_x, CHUNK)
    print(f"[fwd_stages] {c['pairs']} pairs evaluated, "
          f"{c['faint_share']:.1%} with alpha below 1/255; {c['slots']} warp "
          f"slots, {c['blend_share']:.1%} with a pixel that adds to the "
          f"blend, {c['none_live_share']:.1%} with no live pixel at or above "
          f"1/255, {c['lane_pairs_per_pair']:.3f} lane-pairs per evaluated "
          f"pair; tile ranges max {c['range_max']}, mean "
          f"{c['range_mean']:.1f}, p99 {c['range_p99']:.0f}", flush=True)
    return dict(ms, tiles=tiles, counts=c)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--h", type=int, default=680)
    args = ap.parse_args(argv)
    return run(args.n, args.w, args.h, args.iters)


if __name__ == "__main__":
    main()
