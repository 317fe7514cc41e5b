"""Phase timers and device traces.

Counterpart of ``splatam_tpu/utils/profiling.py``: the reference's
wall-clock accumulators (tracking/mapping x iteration/frame averages,
`scripts/splatam.py:615-622,959-979`), with ``torch.profiler`` traces in
place of ``jax.profiler``'s. CUDA work is asynchronous: a phase waits for
the devices of the tensors it is given before it stops its clock.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


def _synchronize(block_on) -> None:
    """Wait for every CUDA device that holds a tensor in ``block_on`` (a
    tensor, or a nest of lists, tuples and dicts of them)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(block_on)
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimers:
    """Per-phase wall-clock samples, printed as the reference's averages."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.samples[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> float:
        vals = self.samples.get(name, [])
        return 1000.0 * sum(vals) / len(vals) if vals else float("nan")

    def report(self) -> Dict[str, float]:
        """The mean of every phase recorded, in ms, printed by name."""
        out = {name: self.mean_ms(name) for name in self.samples}
        for name, ms in sorted(out.items()):
            print(f"Average {name} time: {ms:.2f} ms")
        return out


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the CPU and, where present, CUDA activity of the block with
    ``torch.profiler``, written to ``log_dir`` for TensorBoard's profiler
    plugin (or ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
