"""P2: elementwise op rates on the card, f32 and bf16.

Counterpart of ``tools/vpu_probe.py`` at its chunk, 128: a grid of
``steps`` blocks, each applying ``reps`` dependent elementwise ops to its
(256, 128) block of a (256, steps * 128) array; the time at reps 0 is the
block's fixed cost, and the difference per rep the cost of one op over a
(256, 128) block.
It asks what the tool asked on the TPU: what do exp, log and log1p cost
against a multiply-add, and do packed bf16 pairs run faster than f32?
Kernel ``csrc/probe_ops.cu`` (``raster.KERNELS["P2"]``); ``ops_plain``
beside it.

Usage: python -m splatam_torch.bench.vpu_probe [--steps 2000]
  [--iters 20] [--reps 0,16] [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from splatam_torch.bench.timing import device_name, time_ms
from splatam_torch.device import resolve_device
from splatam_torch.render import raster

NPIX = 256
CHUNK = 128
OPS = ("mul_add", "where", "exp", "log", "log1p", "roll")
# the tool's cases: bf16 transcendentals did not lower on the TPU, so bf16
# runs the arithmetic ops only
CASES = (("float32", OPS), ("bfloat16", ("mul_add", "where", "roll")))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ops_plain(x: torch.Tensor, op: str, reps: int) -> torch.Tensor:
    """Plain P2: ``reps`` ops on every (256, 128) block of ``x``, in its
    dtype, rounding after every op (constants in that dtype too)."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    for _ in range(reps):
        if op == "mul_add":
            x = x * x + c(0.25)
        elif op == "where":
            x = torch.where(x > c(0.5), x * x, x + c(0.25))
        elif op == "exp":
            x = torch.exp(x) * c(0.5)
        elif op == "log":
            x = torch.log(x * x + c(0.5))
        elif op == "log1p":
            x = torch.log1p(x * c(0.25))
        elif op == "roll":  # jnp.roll(x, 1, axis=1) within each block
            r = torch.roll(x.reshape(NPIX, -1, CHUNK), 1, dims=2)
            x = x * r.reshape(x.shape) * c(0.5) + c(0.7)
        else:
            raise ValueError(f"unknown op {op!r}")
    return x


def ops_cuda(x: torch.Tensor, op: str, reps: int) -> torch.Tensor:
    """Launch P2 on ``x`` (256, steps * 128), f32 or bf16."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    steps = x.shape[1] // CHUNK
    raster._check(x, "x", x.dtype, (NPIX, steps * CHUNK))
    bf16 = x.dtype == torch.bfloat16
    if op not in (CASES[1][1] if bf16 else OPS):
        raise ValueError(f"op {op!r} is not probed in {x.dtype}")
    out = torch.empty_like(x)
    raster.OPS_KERNEL.launch(x.device, x.data_ptr(), OPS.index(op), int(bf16),
                             reps, steps, CHUNK, out.data_ptr())
    return out


def ops(x, op, reps):
    """P2 on a CUDA tensor, its plain version on a CPU one."""
    return (ops_cuda if x.is_cuda else ops_plain)(x, op, reps)


def run(steps=2000, iters=20, reps=(0, 16), device=None):
    """Time every (dtype, op) at each of ``reps`` (the first is the base).
    Prints the tool's table, with ns per op between each pair of
    successive reps; returns {(dtype, op, reps): ms per launch}."""
    dev = resolve_device(device)
    ms = {}
    for dname, ops_ in CASES:
        x = torch.full((NPIX, steps * CHUNK), 0.6, dtype=DTYPES[dname],
                       device=dev)
        for op in ops_:
            for r in reps:
                ms[(dname, op, r)] = time_ms(lambda: ops(x, op, r),
                                             iters, dev)
        del x
    cols = "  ".join(f"ns/op {a}->{b}" for a, b in zip(reps, reps[1:]))
    print(f"[vpu] {device_name(dev)}: steps {steps}, chunk {CHUNK}, "
          f"{iters} launches per case; one op = one (256, {CHUNK}) block",
          flush=True)
    print(f"[vpu] {'dtype':9s} {'op':8s} {'base ns/block':>14s}  {cols}",
          flush=True)
    for dname, ops_ in CASES:
        for op in ops_:
            t = [ms[(dname, op, r)] * 1e6 / steps for r in reps]
            per = "  ".join(f"{(t[i + 1] - t[i]) / (b - a):11.2f}"
                            for i, (a, b) in enumerate(zip(reps, reps[1:])))
            print(f"[vpu] {dname:9s} {op:8s} {t[0]:14.1f}  {per}", flush=True)
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", default="0,16",
                    help="comma-separated reps, the first the base")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    reps = tuple(int(r) for r in args.reps.split(","))
    return run(args.steps, args.iters, reps, args.device)


if __name__ == "__main__":
    main()
