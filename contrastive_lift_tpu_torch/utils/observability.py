"""Observability: profiling, spans and counters, NaN scrubbing, signals,
counts.

Port of ``contrastive_lift_tpu/utils/observability.py`` in torch and numpy,
with the port's own tracing: ``span(name)`` marks a stretch of the program
as a ``torch.profiler.record_function`` range and ``count(name, value)``
adds to a named counter, both only while a torch profiler is collecting
(otherwise a span is one shared null context and a count does nothing);
``take_spans`` and ``take_counters`` hand over and clear what was
recorded. ``profile_trace`` writes a ``torch.profiler`` trace (Chrome trace
JSON, one file per trace, the spans in it) and the counters under a log
directory; ``scrub_nan_grads`` zeroes NaN and infinite gradients in a tree
of tensors; ``finite_check`` reports on the host the first leaf with a
non-finite value; SIGUSR1 dumps every thread's stack and SIGUSR2 exits;
``parameter_counts`` counts parameters per branch.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import signal
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .tree import path_str, tree_leaves_with_path, tree_map


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------

# The profiler's flag: one call, about 0.2 us, where an ungated
# record_function costs about 12 us (CPU build)
_profiling = torch._C._autograd._profiler_enabled
_NULL_SPAN = contextlib.nullcontext()


class _Recorder:
    """The spans and counts recorded while a profiler collected: each
    span's (name, start, end) on the host, in nanoseconds of the unix clock
    that the profiler's events use (``time.time_ns``), and each counter's
    host part and its partial sums on the device. Spans and counts may come
    from autograd's threads as well as the caller's."""

    FOLD = 256   # partial sums a counter keeps before folding them into one

    def __init__(self):
        self.lock = threading.Lock()
        self.spans = []
        self.host = defaultdict(int)
        self.device = defaultdict(list)

    def add_span(self, name: str, t0: int, t1: int) -> None:
        with self.lock:
            self.spans.append((name, t0, t1))

    def add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            part = value.detach().sum()
            with self.lock:
                parts = self.device[name]
                parts.append(part)
                if len(parts) >= self.FOLD:
                    self.device[name] = [torch.stack(parts).sum()]
        else:
            with self.lock:
                self.host[name] += int(value)

    def take_spans(self) -> list:
        with self.lock:
            spans, self.spans = self.spans, []
        return spans

    def take_counters(self) -> Dict[str, int]:
        with self.lock:
            host, device = self.host, self.device
            self.host, self.device = defaultdict(int), defaultdict(list)
        out = dict(host)
        if device:
            names = list(device)
            dev = device[names[0]][0].device
            sums = torch.stack([torch.stack(device[n]).sum().to(dev)
                                for n in names]).tolist()   # the one sync
            for n, v in zip(names, sums):
                out[n] = out.get(n, 0) + int(v)
        return out


_RECORDER = _Recorder()


class _Span:
    """A ``record_function`` range whose host interval is also recorded."""
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.range.__exit__(*exc)
        _RECORDER.add_span(self.name, self.t0, t1)
        return False


def span(name: str):
    """A context manager marking the program's stretch ``name``: while a
    torch profiler collects, a ``record_function`` range (its host side and,
    on a card, its device side on the profiler's timeline) whose host
    interval ``take_spans`` also returns; otherwise one shared null
    context, which costs the flag check alone."""
    return _Span(name) if _profiling() else _NULL_SPAN


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a torch profiler
    collects, and do nothing otherwise: an int on the host, a tensor as
    its sum on its device (its reduction's kernels, two for a bool mask on
    a card; no synchronise)."""
    if _profiling():
        _RECORDER.add(name, value)


def take_spans() -> list:
    """[(name, start ns, end ns)] of the spans closed since the last take,
    host intervals on the profiler's clock; clears them."""
    return _RECORDER.take_spans()


def take_counters() -> Dict[str, int]:
    """{name: total} of the counts since the last take (one synchronise
    where a counter is on a device); clears them."""
    return _RECORDER.take_counters()


@contextlib.contextmanager
def profile_trace(log_dir, enabled: bool = True):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a card is
    present) and write it as ``log_dir/trace_<time>.json``, a Chrome trace
    (open it in Perfetto or chrome://tracing) that holds the program's
    spans, and the counters of the block as ``log_dir/counters_<time>.json``;
    a no-op when not ``enabled``."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    take_spans(), take_counters()   # what an earlier profiler left
    with torch.profiler.profile(activities=activities) as prof:
        yield
    stamp = time.time_ns()
    prof.export_chrome_trace(str(out / f"trace_{stamp}.json"))
    take_spans()                    # they are in the trace
    with open(out / f"counters_{stamp}.json", "w") as f:
        json.dump(take_counters(), f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# Numerical safety
# ---------------------------------------------------------------------------

def scrub_nan_grads(grads):
    """The tree ``grads`` with NaN and infinite entries replaced by zeros."""
    return tree_map(lambda g: torch.nan_to_num(g, nan=0.0, posinf=0.0,
                                               neginf=0.0), grads)


def finite_check(tree, name: str = "tree") -> bool:
    """True iff every leaf of ``tree`` (tensors or arrays) is finite; else
    prints the path of the first non-finite leaf to stderr and returns
    False. Runs on the host: it copies each leaf there."""
    for path, leaf in tree_leaves_with_path(tree):
        arr = (leaf.detach().float().cpu().numpy()
               if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
        if not np.isfinite(arr).all():
            print(f"[finite_check] non-finite values in {name}/"
                  f"{path_str(path)}", file=sys.stderr)
            return False
    return True


# ---------------------------------------------------------------------------
# Signals and model reporting
# ---------------------------------------------------------------------------

def install_signal_handlers():
    """SIGUSR1 -> dump all stacks to stderr; SIGUSR2 -> exit(1)."""
    def dump_stacks(_sig, _frame):
        faulthandler.dump_traceback(file=sys.stderr)

    def quit_now(_sig, _frame):
        print("received SIGUSR2 — exiting", file=sys.stderr)
        sys.exit(1)

    signal.signal(signal.SIGUSR1, dump_stacks)
    signal.signal(signal.SIGUSR2, quit_now)


def parameter_counts(params: dict) -> Dict[str, int]:
    """Per-branch parameter counts, and their ``total``."""
    counts = {name: int(sum(np.prod(tuple(leaf.shape)) for _, leaf
                            in tree_leaves_with_path(branch)))
              for name, branch in params.items()}
    counts["total"] = sum(counts.values())
    return counts


def print_model_summary(params: dict) -> None:
    counts = parameter_counts(params)
    width = max(len(k) for k in counts)
    for name, count in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<{width}}  {count:>12,}")
