"""The traced training iterations' counted operations over their time and the card's f32 peak (%)."""
from benchmark.core import readers


def read(ctx):
    return readers.mfu_pct(ctx, "train")
