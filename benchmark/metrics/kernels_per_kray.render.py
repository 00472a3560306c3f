"""Kernel launches in the traced window per 1,000 rays rendered: the host's
dispatch load."""


def read(ctx):
    n = len(ctx["trace"].kernels())
    return n / (ctx["rays"] / 1e3) if n and ctx["rays"] else None
