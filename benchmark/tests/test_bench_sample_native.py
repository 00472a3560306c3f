"""The reader of the samplers' counters, ``sample_native_pct.train``.

On the synthetic window of ``test_bench_program.py``: 100 x native /
shuffled where the port counts its permutations, and nothing where it
counts none or has no counters at all. On the CPU at a small size, a
traced training run reads 100%, and 0% where the library is not loaded.
"""
import time

import pytest
import torch

from benchmark import run
from benchmark.tests.test_bench_program import TRAIN_SMALL, contexts, window

NAME = "sample_native_pct.train"


@pytest.mark.parametrize("native, shuffled", [(0, 40), (30, 40), (40, 40)])
def test_reads_native_over_shuffled(native, shuffled):
    ctx = {**contexts(window(True))["train"],
           "program_counters": {"sample.native": native,
                                "sample.shuffled": shuffled,
                                "heads.live": 1, "heads.slots": 64}}
    assert run.read_metric(NAME, ctx) == 100.0 * native / shuffled


@pytest.mark.parametrize("counters", [None, {},
                                      {"heads.live": 1, "heads.slots": 64},
                                      {"sample.native": 0,
                                       "sample.shuffled": 0}])
def test_without_the_counters_reads_nothing(counters):
    """A program that counts no permutations (the parent of the change that
    brought the counters, or a window without a draw) gives None."""
    ctx = {**contexts(window(True))["train"], "program_counters": counters}
    assert run.read_metric(NAME, ctx) is None


def test_on_a_program_without_counters(monkeypatch):
    """A program without take_spans and take_counters: None, no raise."""
    from contrastive_lift_tpu_torch.utils import observability
    monkeypatch.delattr(observability, "take_spans")
    monkeypatch.delattr(observability, "take_counters")
    assert run.read_metric(NAME, contexts(window(False))["train"]) is None


@pytest.mark.parametrize("loaded", [True, False])
def test_traced_draw_reads_the_native_share(monkeypatch, loaded):
    """A traced ``cl.train_fixed`` run on the CPU: every permutation native
    where the library loads, none where it does not."""
    from contrastive_lift_tpu_torch.data import shuffle
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if loaded:
        if not shuffle.native_available():
            pytest.skip("the native shuffle does not build here")
    else:
        monkeypatch.setattr(shuffle, "_lib", None)
        monkeypatch.setattr(shuffle, "_tried", True)
    res = run.run_cell("cl.train_fixed", 2 ** 31 + 43, 0.2, True,
                       torch.device("cpu"), time.perf_counter(),
                       **TRAIN_SMALL)
    assert res["correct"], res["checks"]
    assert res["metrics"][NAME]["value"] == (100.0 if loaded else 0.0)
