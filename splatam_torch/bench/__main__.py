"""Rasterizer fwd+bwd throughput benchmark (one JSON line to stdout).

Counterpart of ``bench.py::main``. Measures the full differentiable render
step, fused 6-channel (RGB + depth + silhouette) forward + backward through
all gaussian parameters, at SplaTAM's Replica working resolution
(1200x680), in megapixels per second: one warm-up run, then one timed run of
``iters`` chained iterations on the host clock, bracketed by
``torch.cuda.synchronize()``. The loop is eager, so the host's time to issue
it is part of what is measured, as it is part of what a user pays.

vs_baseline compares against the reference CUDA rasterizer on A100
(BASELINE.md: no published numbers in-repo; ~100 Mpix/s fwd+bwd is the
working estimate from the reference's reported tracking-iteration times:
2 fwd + 2 bwd of a 0.8 Mpix frame per ~15 ms iteration on datacenter GPUs).

Usage: python -m splatam_torch.bench [mode] [--device cuda|cpu] [--n N]
  [--w W] [--h H]
``mode``: ``+``-separated tokens (``scene.parse_mode``): layout
(split|aligned), chunk (c128|c512; default 256), saturation trim (notrim);
bench.py's reduction, scan and alignment tokens are accepted and ignored.
It runs on the card unless ``--device cpu`` is given (a small ``--n`` there),
and names the device it ran on on standard error.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from splatam_torch.bench.scene import setup
from splatam_torch.bench.timing import device_name

BASELINE_MPIX_S = 100.0  # A100 CUDA fwd+bwd estimate (see module docstring)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default=None,
                   help="+-separated mode tokens, e.g. aligned+c128")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--n", type=int, default=200_000, help="gaussians")
    p.add_argument("--w", type=int, default=1200)
    p.add_argument("--h", type=int, default=680)
    return p.parse_args(argv)


def measure(prog) -> dict:
    """One warm-up run and one timed run of ``prog``. Returns the throughput
    (Mpix/s), ms per iteration and the last loss; raises on a non-finite
    loss."""
    dev = prog.cam.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prog.run()  # warm-up
    sync()
    t0 = time.perf_counter()
    loss = prog.run()
    sync()
    dt = time.perf_counter() - t0
    loss = float(loss)
    if loss != loss or abs(loss) == float("inf"):
        raise RuntimeError(f"the benchmark's loss is not finite: {loss}")
    return dict(mpix_s=prog.w * prog.h * prog.iters / dt / 1e6,
                ms_per_iter=dt * 1e3 / prog.iters, loss=loss)


def main(argv=None) -> dict:
    """Set up, measure and print the JSON line. Returns the measurement
    with the program under ``"program"``."""
    args = parse_args(argv)
    prog = setup(args.mode, n=args.n, w=args.w, h=args.h, device=args.device)
    res = measure(prog)
    print(json.dumps({
        "metric": "rasterizer_fwd_bwd_throughput",
        "value": round(res["mpix_s"], 3),
        "unit": "Mpix/s",
        "vs_baseline": round(res["mpix_s"] / BASELINE_MPIX_S, 4),
    }), flush=True)
    print(f"[bench] {device_name(prog.cam.device)}: layout {prog.cfg.layout}, "
          f"chunk {prog.cfg.chunk}, {prog.num_kept} instances "
          f"({prog.num_kept_untrimmed} before the trim), "
          f"{res['ms_per_iter']} ms per iteration", file=sys.stderr, flush=True)
    res["program"] = prog
    return res


if __name__ == "__main__":
    main()
