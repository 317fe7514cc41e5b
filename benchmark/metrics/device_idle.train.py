"""Share of the traced training iterations in which no device operation ran (%)."""
from benchmark.core import readers


def read(ctx):
    return readers.idle_pct(ctx, "train")
