"""The rasterization kernels' least time over their device time in the traced training iterations (%)."""
from benchmark.core import readers


def read(ctx):
    return readers.roofline_pct(ctx, "train", "raster")
