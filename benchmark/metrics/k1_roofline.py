"""The density kernel's share of its roofline: the bytes each launch's
inputs need over 3.35 TB/s, over its device time in the trace, summed over
the launches whose positions were kept."""


def read(ctx):
    k1 = ctx["k1"]
    if not k1:
        return None
    return 100.0 * k1["need_s"] / k1["device_s"]
