"""Device milliseconds of the optimizer a step: the device side of the
program's ``adam_update`` ranges (``train/state.py::AdamChain.update``)."""


def read(ctx):
    ns = ctx["trace"].ranges.get("adam_update", [])
    return sum(ns) / 1e6 / ctx["steps"] if ns and ctx["steps"] else None
