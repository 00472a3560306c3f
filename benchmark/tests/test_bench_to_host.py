"""The reader of the frame loop's copy counters, ``to_host_ready_pct.render``.

On the synthetic window of ``test_bench_program.py``: 100 x ready / copies
where the port counts its chunk copies, and nothing where it counts none or
has no counters at all. On the CPU at a small size, a traced render reads
100%: each chunk's maps are copied at once there.
"""
import time

import pytest
import torch

from benchmark import run
from benchmark.tests.test_bench_program import RENDER_SMALL, contexts, window

NAME = "to_host_ready_pct.render"


@pytest.mark.parametrize("ready, copies", [(3, 4), (0, 5), (24, 24)])
def test_to_host_ready_pct_reads_ready_over_copies(ready, copies):
    ctx = {**contexts(window(True))["render"],
           "program_counters": {"to_host.ready": ready,
                                "to_host.copies": copies,
                                "k1.live": 3, "k1.slots": 12}}
    assert run.read_metric(NAME, ctx) == 100.0 * ready / copies


@pytest.mark.parametrize("counters", [None, {}, {"k1.live": 3, "k1.slots": 12},
                                      {"to_host.ready": 0,
                                       "to_host.copies": 0}])
def test_to_host_ready_pct_without_the_counters_reads_nothing(counters):
    """A program that counts no copies (the parent of the change that
    brought the counters, or a window without a render) gives None."""
    ctx = {**contexts(window(True))["render"], "program_counters": counters}
    assert run.read_metric(NAME, ctx) is None


def test_to_host_ready_pct_on_a_program_without_counters(monkeypatch):
    """A program without take_spans and take_counters: None, no raise."""
    from contrastive_lift_tpu_torch.utils import observability
    monkeypatch.delattr(observability, "take_spans")
    monkeypatch.delattr(observability, "take_counters")
    assert run.read_metric(NAME, contexts(window(False))["render"]) is None


def test_traced_render_reads_every_copy_ready(monkeypatch):
    from benchmark import spans
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    res = spans.traced("cl.render_fixed", 2 ** 31 + 37, 0.2,
                       torch.device("cpu"), time.perf_counter(),
                       **RENDER_SMALL)
    assert res["correct"], res
    assert res["metrics"][NAME]["value"] == 100.0
    assert res["spans"]["render.to_host"]["count"] >= 1
