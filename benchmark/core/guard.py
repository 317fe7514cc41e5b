"""What every run checks about where it runs.

The card and its count (a run that finds no CUDA device, or fewer than the
cell asks for, fails and never falls back to the CPU), the card's name and
power limit on an early line of standard error, the build and kernel
caches inside the checkout, and, once the window has closed, that nothing
of JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import subprocess
import sys

from benchmark.core.manifest import ROOT

# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "splatam_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    (The program builds its kernels into ``build/kernels`` there itself.)"""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def require_cards(n: int):
    """The CUDA device, after checking that ``n`` cards are there."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark runs on the card only")
    count = torch.cuda.device_count()
    if count < n:
        raise SystemExit(f"the cell asks for {n} cards and {count} are there")
    log(f"[device] {torch.cuda.get_device_name(0)}; {count} device(s); "
        f"nvidia-smi: {nvidia_smi()}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    return torch.device("cuda", 0)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})
