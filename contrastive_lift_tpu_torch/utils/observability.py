"""Observability: signal handlers and parameter counts.

The part of ``contrastive_lift_tpu/utils/observability.py`` that the
``Trainer`` reaches, in torch and numpy (the JAX module imports JAX). Not
ported (slice 3): ``profile_trace``, ``PhaseTimer``, ``scrub_nan_grads``,
``finite_check``.
"""
from __future__ import annotations

import faulthandler
import signal
import sys
from typing import Dict

import numpy as np

from .tree import tree_leaves_with_path


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
