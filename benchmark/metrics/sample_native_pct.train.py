"""The share of the elements that the bundle samplers permuted which were
permuted natively, on numpy's own PCG64 stream: 100 * the port's counter
``sample.native`` over ``sample.shuffled`` in the window
(``contrastive_lift_tpu_torch/data/shuffle.py``). Under 100 where the
library did not build or failed its check on loading; a program without
the counters reports nothing."""
from benchmark.core import program


def read(ctx):
    return program.share(ctx, "sample.native", "sample.shuffled")
