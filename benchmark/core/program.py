"""The program's own spans and counters in a traced run.

While a torch profiler collects, the port records each span's host
interval on the profiler's clock and adds to its counters
(``contrastive_lift_tpu_torch/utils/observability.py``: ``take_spans``,
``take_counters``). The traced window is the only profiler of a run, so
what the port holds once the window has closed is the window's. The first
reader to ask takes it from the port and keeps it in the reader context,
for the readers after it. A program without these functions gives None,
and its readers report nothing.
"""
from __future__ import annotations

from benchmark.core import trace as tr

OUTSIDE = "outside the program's spans"


def _taken(ctx: dict, key: str, what: str):
    if key not in ctx:
        try:
            from contrastive_lift_tpu_torch.utils import observability
        except ImportError:
            observability = None
        take = getattr(observability, what, None)
        ctx[key] = take() if take is not None else None
    return ctx[key]


def spans(ctx: dict):
    """[(name, start ns, end ns)] of the port's spans in the window (host
    intervals on the profiler's clock), or None."""
    return _taken(ctx, "program_spans", "take_spans")


def counters(ctx: dict):
    """{name: total} of the port's counters in the window, or None."""
    return _taken(ctx, "program_counters", "take_counters")


def share(ctx: dict, part: str, whole: str):
    """100 * counter ``part`` / counter ``whole``, or None."""
    c = counters(ctx)
    if not c or not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]


def host_ms(ctx: dict, name: str):
    """The host milliseconds inside the spans ``name``, or None."""
    got = spans(ctx)
    if not got:
        return None
    ns = [b - a for n, a, b in got if n == name]
    return sum(ns) / 1e6 if ns else None


def idle_gaps(trace: tr.Trace):
    """The device's idle gaps: between the union's covered stretches, as
    ``core/trace.py::breakdown`` takes them."""
    _, gaps = tr._union_ns((s, s + d) for _, _, s, d in trace.ops)
    return gaps


def overlap_ns(gaps, intervals) -> int:
    """The nanoseconds of ``gaps`` that lie inside ``intervals`` (each list
    sorted and without overlaps of its own)."""
    total, j = 0, 0
    intervals = sorted(intervals)
    for g0, g1 in gaps:
        while j < len(intervals) and intervals[j][1] <= g0:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < g1:
            total += max(0, min(g1, intervals[k][1]) - max(g0, intervals[k][0]))
            k += 1
    return total


def innermost(got) -> list:
    """[(start, end, name)]: the stretches in which a port span is open,
    each with the innermost one (the latest begun of those open), in order;
    ``got`` as ``spans`` gives it."""
    got = sorted(got, key=lambda x: (x[1], -x[2]))
    points = sorted({t for _, a, b in got for t in (a, b)})
    out, stack, i = [], [], 0
    for t0, t1 in zip(points, points[1:]):
        while i < len(got) and got[i][1] <= t0:
            stack.append((got[i][2], got[i][0]))
            i += 1
        while stack and stack[-1][0] <= t0:
            stack.pop()
        if stack:
            if out and out[-1][2] == stack[-1][1] and out[-1][1] == t0:
                out[-1] = (out[-1][0], t1, out[-1][2])
            else:
                out.append((t0, t1, stack[-1][1]))
    return out


def idle_by_span(trace: tr.Trace, got) -> list:
    """[[span, seconds]]: the device's idle time, each stretch of it given
    to the innermost port span open during it (``OUTSIDE`` where none is),
    most first. A gap that runs on past the span it began in is split."""
    idle = {}
    for name, a, b in idle_parts(trace, got):
        idle[name] = idle.get(name, 0) + (b - a)
    return [[k, ns / 1e9] for k, ns in sorted(idle.items(),
                                               key=lambda kv: -kv[1])]


def idle_parts(trace: tr.Trace, got):
    """(name, start, end) of the parts of each of the device's idle gaps:
    inside each stretch of ``innermost``, and ``OUTSIDE`` between them."""
    stretches = innermost(got)
    j = 0
    for g0, g1 in idle_gaps(trace):
        while j < len(stretches) and stretches[j][1] <= g0:
            j += 1
        t, k = g0, j
        while k < len(stretches) and stretches[k][0] < g1:
            a, b, name = stretches[k]
            if a > t:
                yield OUTSIDE, t, a
            yield name, max(a, t), min(b, g1)
            t = max(t, min(b, g1))
            k += 1
        if t < g1:
            yield OUTSIDE, t, g1
