"""Timing and device description shared by the benchmark and the probes."""
from __future__ import annotations

import time

import torch


def time_ms(fn, iters: int, device: torch.device, warmup: int = 1) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after ``warmup`` calls: CUDA
    events around the run on a CUDA device, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def device_name(device: torch.device) -> str:
    """What a measurement ran on: the card's name, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
