"""Host milliseconds a step inside the port's ``train.sample`` spans (the
three samplers of ``data/base.py``)."""
from benchmark.core import program


def read(ctx):
    ms = program.host_ms(ctx, "train.sample")
    return ms / ctx["steps"] if ms is not None and ctx["steps"] else None
