"""The rasterization kernels' least time over their device time in the traced SLAM frames (%)."""
from benchmark.core import readers


def read(ctx):
    return readers.roofline_pct(ctx, "slam", "raster")
