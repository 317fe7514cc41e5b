"""Tracking's milliseconds per iteration over the window's frames (slam/tracking; the program's SlamState.timing)."""
from benchmark.core import readers


def read(ctx):
    return readers.mean_ms(ctx.get("tracking_iter"))
