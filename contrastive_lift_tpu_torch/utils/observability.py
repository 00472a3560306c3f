"""Observability: profiling, phase timers, NaN scrubbing, signals, counts.

Port of ``contrastive_lift_tpu/utils/observability.py`` in torch and numpy:
``profile_trace`` writes a ``torch.profiler`` trace (Chrome trace JSON, one
file per trace) under a log directory; ``PhaseTimer`` accumulates
wall-clock seconds per named phase; ``scrub_nan_grads`` zeroes NaN and
infinite gradients in a tree of tensors; ``finite_check`` reports on the
host the first leaf with a non-finite value; SIGUSR1 dumps every thread's
stack and SIGUSR2 exits; ``parameter_counts`` counts parameters per branch.
"""
from __future__ import annotations

import contextlib
import faulthandler
import signal
import sys
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

@contextlib.contextmanager
def profile_trace(log_dir, enabled: bool = True):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a card is
    present) and write it as ``log_dir/trace_<time>.json``, a Chrome trace
    (open it in Perfetto or chrome://tracing); a no-op when not
    ``enabled``."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


class PhaseTimer:
    """Accumulating wall-clock timers per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        """{phase: {"total_s", "count", "mean_ms"}}."""
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_ms": 1000 * self.totals[name]
                       / max(self.counts[name], 1)}
                for name in self.totals}


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
