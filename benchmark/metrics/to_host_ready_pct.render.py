"""The share of the chunks' map copies to the host that had already
completed when the frame loop came to drain them: 100 * the port's counter
``to_host.ready`` over ``to_host.copies`` in the window. Low where the host
waits on the copies; a program without the counters reports nothing."""
from benchmark.core import program


def read(ctx):
    return program.share(ctx, "to_host.ready", "to_host.copies")
