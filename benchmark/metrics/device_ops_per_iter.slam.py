"""Device operations (kernels, copies, sets) per SLAM iteration in the traced frames."""
from benchmark.core import readers


def read(ctx):
    return readers.ops_per_iter(ctx, "slam")
