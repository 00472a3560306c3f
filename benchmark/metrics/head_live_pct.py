"""The share of the head sample slots evaluated whose compositing weight is
over ``raymarch_weight_thres``: 100 * the port's counter ``heads.live`` over
``heads.slots`` in the window (the render's top-k heads, or every head of
the training step). The reader of every cell's ``head_live_pct.<kind>``."""
from benchmark.core import program


def read(ctx):
    return program.share(ctx, "heads.live", "heads.slots")
