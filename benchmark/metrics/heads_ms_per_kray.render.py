"""Device milliseconds of matmul kernels (the head MLPs) per 1,000 rays."""


def read(ctx):
    ms = ctx["trace"].device_s("matmul") * 1e3
    return ms / (ctx["rays"] / 1e3) if ms > 0 and ctx["rays"] else None
