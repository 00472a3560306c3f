"""The render's model FLOPs (benchmark/count/flops.py: density at every
in-box sample, heads at the reference's above-threshold samples) over the
traced window times the peak of the heads' dtype."""


def read(ctx):
    t = ctx["trace"]
    if not ctx["rays"] or t.window_s <= 0:
        return None
    flops = ctx["flops_per_ray"] * ctx["rays"]
    return 100.0 * flops / (t.window_s * ctx["peak_flops"])
