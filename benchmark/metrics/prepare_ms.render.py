"""Host milliseconds of ``inference/render.py::prepare_render`` a call (the
grids, grouping and budget calibration), synchronised at its end."""


def read(ctx):
    ms = ctx["prepare_ms"]
    return sum(ms) / len(ms) if ms else None
