"""The share of the traced window in which the device is idle while the host
is inside the port's ``train.assign`` spans (the assignment solved on the
host in the middle of the step): the device's idle gaps
(``core/program.py::idle_gaps``) that those spans cover, over the window."""
from benchmark.core import program


def read(ctx):
    got, t = program.spans(ctx), ctx["trace"]
    if not got or t.window_s <= 0:
        return None
    host = [(a, b) for n, a, b in got if n == "train.assign"]
    if not host:
        return None
    ns = program.overlap_ns(program.idle_gaps(t), host)
    return 100.0 * ns / 1e9 / t.window_s
