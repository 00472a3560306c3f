"""Kernel launches in the traced window per training step."""


def read(ctx):
    n = len(ctx["trace"].kernels())
    return n / ctx["steps"] if n and ctx["steps"] else None
