"""Device operations (kernels, copies, sets) per training iteration in the traced iterations."""
from benchmark.core import readers


def read(ctx):
    return readers.ops_per_iter(ctx, "train")
