"""Where the benchmark's device time goes: ``torch.profiler`` over one run.

Counterpart of ``tools/profile_bench.py``: the same measured program as
``python -m splatam_torch.bench`` (``scene.setup``), one warm-up run, then
one run under the profiler; prints the device's busy share of the wall time
and the costliest device ops. ``profile_block`` profiles any callable (the
smoke run uses it for every path).

Usage: python -m splatam_torch.bench.profile [mode] [--iters 10] [--top 40]
  [--n N] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch


def log(*a):
    print(*a, flush=True)


def profile_block(block, iters, top=12):
    """Where one call of ``block`` (``iters`` iterations) spends the
    device's time: the share of the wall time the device was busy, and the
    costliest device ops. Returns the rows (name, device ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, sets): the host ops that
    # launched them report the same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if not rows:
        log("[profile] the profiler saw no device time")
        return rows
    kern_ms = sum(r[1] for r in rows if r[0].startswith(("raster_", "split_")))
    log(f"[profile] {iters} iterations: wall {wall_ms:.2f} ms under the "
        f"profiler, device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(r[2] for r in rows)} device ops; the compositing kernels "
        f"{kern_ms / iters:.4f} ms/iter ({kern_ms / busy_ms:.1%} of the "
        f"device time)")
    for key, dev_ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"[profile]   {dev_ms / iters:8.4f} ms/iter  {dev_ms / busy_ms:6.1%}  "
            f"x{count / iters:g}/iter  {key[:90]}")
    return rows


def main(argv=None):
    from splatam_torch.bench.scene import setup

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default=None)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--device", default=None, help="cuda (the default)")
    args = p.parse_args(argv)
    prog = setup(args.mode, iters=args.iters, rebin_every=args.iters,
                 n=args.n, device=args.device)
    if prog.cam.device.type != "cuda":
        raise RuntimeError("the profile reads device time: it needs CUDA")
    prog.run()  # warm-up
    return profile_block(prog.run, args.iters, args.top)


if __name__ == "__main__":
    main()
