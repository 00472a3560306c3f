"""Host milliseconds a step inside the port's ``train.assign`` spans (the
linear-assignment loss's cost copied to the host, solved there and its
match copied back, ``losses/losses.py::linear_assignment_loss``)."""
from benchmark.core import program


def read(ctx):
    ms = program.host_ms(ctx, "train.assign")
    return ms / ctx["steps"] if ms is not None and ctx["steps"] else None
