"""The share of the assignment's rows that hold a label present in the
bundle: 100 * the port's counter ``assign.rows`` over ``assign.slots`` in
the window (the rows solved, ``max_labels_per_image`` an image). The rest
are padding rows that the solve carries at 1e6."""
from benchmark.core import program


def read(ctx):
    return program.share(ctx, "assign.rows", "assign.slots")
