"""The traced window: torch.profiler over the calls, read in memory.

Nothing is written to disk: the events are read from the profiler's kineto
results once it stops. Device operations are the kernels, copies and sets
on the device; ``busy_s`` is the length of
the union of their intervals, so overlapping operations on several streams
count once and the profiler's ranges on the device (``gpu_user_annotation``)
not at all. The reading works on PyTorch builds whose kineto events lack
``activity_type``: device events are told apart by name.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

SPAN_PREFIX = "bench."
WINDOW = "bench.window"
# the program's own profiler ranges; their device side is a range, not an
# operation (told apart by name where kineto events lack their kind)
PROGRAM_RANGES = ("adam_update",)


def kernel_kind(name: str) -> str:
    """A device operation's class by its name (chip_smoke.py's classes,
    copied, with copies apart)."""
    low = name.lower()
    if "sample_density_brick" in name or "brick_interp" in name:
        return "density_kernel"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    if "sort" in low or "topk" in low or "radix" in low:
        return "sort_topk"
    return "other_elementwise"


@dataclass
class Trace:
    """What the metric readers get from one traced window."""
    window_s: float
    busy_s: float
    ops: List[Tuple[str, str, int, int]]        # (name, activity, start, dur) ns
    spans: List[Tuple[str, int, int]]           # host ranges of the benchmark
    cpu_ops: List[Tuple[str, int, int]] = field(default_factory=list)
    ranges: dict = field(default_factory=dict)   # device ranges: name -> [ns]

    def kernels(self):
        return [o for o in self.ops if o[1] == "kernel"]

    def device_s(self, kind: str) -> float:
        return sum(o[3] for o in self.ops if kernel_kind(o[0]) == kind) / 1e9


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _duration_ns(e) -> int:
    if hasattr(e, "duration_ns"):
        return e.duration_ns()
    return int(e.duration_us() * 1000)


def _is_annotation(e) -> bool:
    """A profiler range (record_function) rather than an operation; kineto
    gives its kind where this PyTorch has ``activity_type``."""
    if hasattr(e, "activity_type"):
        return "user_annotation" in e.activity_type()
    return bool(e.is_user_annotation()) if hasattr(
        e, "is_user_annotation") else False


def _device_activity(name: str) -> str:
    low = name.lower()
    if "memcpy" in low:
        return "gpu_memcpy"
    if "memset" in low:
        return "gpu_memset"
    return "kernel"


def _union_ns(intervals) -> Tuple[int, List[Tuple[int, int]]]:
    """(total covered ns, the gaps between covered stretches)."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


class Window:
    """Context manager: profile the calls inside it, then build a
    ``Trace``. The window runs from ``__enter__`` to ``__exit__``, after a
    device synchronise on both sides."""

    def __init__(self, torch):
        self.torch = torch
        self.trace = None
        self.cuda = torch.cuda.is_available()

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        # the window's bounds on the profiler's own clock
        self.span = self.torch.profiler.record_function(WINDOW)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = self.prof.profiler.kineto_results.events()
        ops, spans, cpu_ops, ranges = [], [], [], {}
        t0 = t1 = thread = None
        for e in events:
            name, start, dur = e.name(), _start_ns(e), _duration_ns(e)
            on_device = e.device_type() == self.torch.autograd.DeviceType.CUDA
            if name.startswith(SPAN_PREFIX):
                # a benchmark range: its host side (the device side repeats it)
                if on_device:
                    continue
                if name == WINDOW:
                    t0, t1, thread = start, start + dur, e.start_thread_id()
                else:
                    spans.append((name, start, dur, e.start_thread_id()))
            elif on_device and name in PROGRAM_RANGES:
                ranges.setdefault(name, []).append((start, dur))
            elif on_device:
                if not _is_annotation(e):
                    ops.append((name, _device_activity(name), start, dur))
            elif not _is_annotation(e):
                cpu_ops.append((name, start, dur, e.start_thread_id()))
        if t0 is None:
            raise RuntimeError("the profiler recorded no window range")
        # host ranges nest on one thread: keep the window's
        spans = [x[:3] for x in spans if x[3] == thread]
        cpu_ops = [x[:3] for x in cpu_ops if x[3] == thread]
        ops = [o for o in ops if o[2] + o[3] > t0 and o[2] < t1]
        busy, _ = _union_ns((max(s, t0), min(s + d, t1))
                            for _, _, s, d in ops)
        ranges = {k: [d for s_, d in v if t0 <= s_ < t1]
                  for k, v in ranges.items()}
        self.trace = Trace((t1 - t0) / 1e9, busy / 1e9, ops, spans, cpu_ops,
                           ranges)
        return False


def _innermost_at(items, times):
    """For each of ``times`` (ascending), the name of the innermost range of
    ``items`` [(name, start, dur)] (nested, one thread) open at that time,
    or None: one sweep with a stack of open ranges."""
    items = sorted(items, key=lambda it: (it[1], -it[2]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(items) and items[i][1] <= t:
            name, s, d = items[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((name, s + d))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    device's idle time summed by what the host was doing at each gap's
    start: the innermost benchmark span and the innermost host op of the
    thread that ran the window."""
    by_name = {}
    for name, _, _, dur in trace.ops:
        by_name[name] = by_name.get(name, 0) + dur
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, gaps = _union_ns((s, s + d) for _, _, s, d in trace.ops)
    starts = [g0 for g0, _ in gaps]
    spans = _innermost_at(trace.spans, starts)
    ops = _innermost_at(trace.cpu_ops, starts)
    idle = {}
    for (g0, g1), span, op in zip(gaps, spans, ops):
        key = f"{span or 'outside the calls'} / {op or 'python'}"
        idle[key] = idle.get(key, 0) + (g1 - g0)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in device_ops],
            "idle_gaps": [[n[:120], ns / 1e9] for n, ns in idle_gaps]}
