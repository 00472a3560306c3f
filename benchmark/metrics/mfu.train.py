"""The step's model FLOPs (benchmark/count/flops.py::train_step_flops) times
the steps, over the traced window times the peak of the heads' dtype."""


def read(ctx):
    t = ctx["trace"]
    if not ctx["steps"] or t.window_s <= 0 or ctx["flops_per_step"] <= 0:
        return None
    return (100.0 * ctx["flops_per_step"] * ctx["steps"]
            / (t.window_s * ctx["peak_flops"]))
