"""The share of the samples the density kernel evaluated that the selection
kept and that lie in the box: 100 * the port's counter ``k1.live`` over
``k1.slots`` in the window."""
from benchmark.core import program


def read(ctx):
    return program.share(ctx, "k1.live", "k1.slots")
