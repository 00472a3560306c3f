"""The share of the traced window in which no kernel, copy or set ran on
the device (the union of their intervals). The reader of every cell's
``device_idle_pct.<kind>``."""


def read(ctx):
    t = ctx["trace"]
    if t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
