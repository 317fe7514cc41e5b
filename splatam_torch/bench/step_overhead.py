"""P4: the fixed cost of a step on the card.

Counterpart of ``tools/step_overhead.py`` at its chunk, 128: ``steps``
steps, each reading its (16, 128) window of a stream through an index
table (the TPU's scalar-prefetched ``blk``) and adding a (256, 128)
product into one (256, 128) sum, under five bodies (``BODIES``): nothing,
the window's row 0 broadcast, and tensor-core products with the
lower-triangular 0/1 matrix (bf16 operands, as the TPU's
``Precision.DEFAULT`` rounds them; f32 sums). The tool's ``mxu512`` (one
wide matmul against ``mxu2ind``'s two) has no counterpart: on the tensor
cores both are the same instructions. The TPU ran the steps as a
sequential grid with a scratch sum; the kernel runs them as a loop in one
persistent block per SM (``persistent_ctas``, each block's contiguous
steps ``cta_steps``), with the windows staged ahead into shared memory, the
sum in registers, and the blocks' partial sums added in a fixed order by a
second kernel. The time per step of ``empty`` is the per-step fixed cost
(the window staged and released); the other bodies add the products.
Kernel ``csrc/probe_step.cu`` (``raster.KERNELS["P4"]``; one launch
counts the persistent kernel and its sum); ``step_plain`` beside it.

Usage: python -m splatam_torch.bench.step_overhead [--steps 8000]
  [--iters 20] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from splatam_torch.bench.timing import device_name, time_ms
from splatam_torch.device import resolve_device
from splatam_torch.render import raster

NPIX = 256
ROWS = 16
CHUNK = 128
BODIES = ("empty", "passthru", "mxu", "mxu2dep", "mxu2ind")


def step_plain(stream: torch.Tensor, blk: torch.Tensor,
               body: str) -> torch.Tensor:
    """Plain P4: the (256, 128) sum over blocks of each block's product.
    Every row of a product is the same (the window's rows are broadcast),
    so this forms one row per block."""
    win = stream.reshape(ROWS, -1, CHUNK)[:, blk.long()]  # (16, steps, 128)
    tril = torch.tril(torch.ones(CHUNK, CHUNK, device=stream.device))

    def dot(v):  # Precision.DEFAULT: bf16 operands, f32 sums
        return v.bfloat16().float() @ tril

    if body == "empty":
        prod = torch.zeros_like(win[0])
    elif body == "passthru":
        prod = win[0]
    elif body == "mxu":
        prod = dot(win[0])
    elif body == "mxu2dep":
        prod = dot(dot(win[0]) * 1e-3)
    elif body == "mxu2ind":
        prod = dot(win[0]) + dot(win[1])
    else:
        raise ValueError(f"unknown body {body!r}")
    return prod.sum(0).expand(NPIX, CHUNK).contiguous()


MAX_CTA_STEPS = 4096  # a block's slice of the index table in shared memory


def persistent_ctas(steps: int, sms: int) -> int:
    """The persistent kernel's blocks: one per SM, none without a step, and
    enough that none walks more than ``MAX_CTA_STEPS``."""
    return max(1, min(steps, sms), -(-steps // MAX_CTA_STEPS))


def cta_steps(c: int, steps: int, ctas: int) -> range:
    """The contiguous steps block ``c`` of ``ctas`` walks: the kernel's
    ``[c * steps / ctas, (c + 1) * steps / ctas)`` in integer division."""
    return range(c * steps // ctas, (c + 1) * steps // ctas)


def step_cuda(stream: torch.Tensor, blk: torch.Tensor,
              body: str) -> torch.Tensor:
    """Launch P4 over ``blk`` (steps,) int32 windows of ``stream``
    (16, steps * 128) f32. Returns the (256, 128) sum."""
    steps = blk.shape[0]
    raster._check(stream, "stream", torch.float32, (ROWS, steps * CHUNK))
    raster._check(blk, "blk", torch.int32, (steps,))
    if stream.data_ptr() % 16:
        raise ValueError("stream must be 16-byte aligned (bulk copies)")
    sms = torch.cuda.get_device_properties(stream.device).multi_processor_count
    ctas = persistent_ctas(steps, sms)
    partial = torch.empty((ctas, NPIX, CHUNK), dtype=torch.float32,
                          device=stream.device)
    out = torch.empty((NPIX, CHUNK), dtype=torch.float32, device=stream.device)
    raster.STEP_KERNEL.launch(stream.device, stream.data_ptr(), blk.data_ptr(),
                              BODIES.index(body), steps, ctas,
                              partial.data_ptr(), out.data_ptr())
    return out


def step(stream, blk, body):
    """P4 on CUDA tensors, its plain version on CPU ones."""
    return (step_cuda if stream.is_cuda else step_plain)(stream, blk, body)


def inputs(steps, device, seed=0):
    """The stream (normal, from ``seed``) and a permuted index table."""
    rng = np.random.default_rng(seed)
    stream = torch.tensor(rng.normal(size=(ROWS, steps * CHUNK)).astype(np.float32),
                          device=device)
    blk = torch.tensor(rng.permutation(steps).astype(np.int32), device=device)
    return stream, blk


def run(steps=8000, iters=20, device=None):
    """Time every body; prints per-pass ms and per-step µs. Returns
    {body: ms per launch}."""
    dev = resolve_device(device)
    stream, blk = inputs(steps, dev)
    ms = {b: time_ms(lambda b=b: step(stream, blk, b), iters, dev)
          for b in BODIES}
    print(f"[step] {device_name(dev)}: steps {steps}, chunk {CHUNK}, "
          f"{iters} launches per body", flush=True)
    for b in BODIES:
        print(f"[step] {b:<9} per-pass {ms[b]:8.4f} ms  per-step "
              f"{ms[b] * 1e3 / steps:7.4f} us", flush=True)
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, args.iters, args.device)


if __name__ == "__main__":
    main()
