"""The program's spans and counters in the traced window.

On synthetic event lists, with and without the port's spans (host ranges
and their device side): ``core/trace.py`` reads the same trace either way,
so the earlier per-layer metrics and both breakdown lists are unchanged;
each reader of the program's spans and counters gives its hand-computed
value, and nothing where the program has no such functions. On the CPU at
a small size, a traced run of a render and of the train cell reads the
port's own spans and counters.
"""
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.core import program
from benchmark.core import trace as tr

US = 1000   # ns

EARLIER = ("prepare_ms.render", "kernels_per_kray.render",
           "heads_ms_per_kray.render", "k1_roofline", "mfu.render",
           "device_idle_pct.render", "adam_ms.train", "kernels_per_step.train",
           "mfu.train", "device_idle_pct.train")


class Event:
    """What ``Window`` reads of a kineto event."""

    def __init__(self, name, start, dur, kind, thread=1):
        self._name, self._start, self._dur = name, start * US, dur * US
        self._kind, self._thread = kind, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        dev = self._kind in ("kernel", "gpu_memcpy", "gpu_user_annotation")
        return (torch.autograd.DeviceType.CUDA if dev
                else torch.autograd.DeviceType.CPU)

    def start_thread_id(self):
        return self._thread

    def activity_type(self):
        return self._kind


def events(with_program: bool):
    """A 1 ms window: a call with K1, a head GEMM, a copy of the maps to
    the host and two late kernels; Adam's range; the launches and host ops
    on the window's thread and one on another thread. With the program,
    the port's spans over it, host side and device side."""
    evs = [Event("bench.window", 0, 1000, "user_annotation"),
           Event("bench.render_frames", 10, 985, "user_annotation"),
           Event("sample_density_brick_kernel", 100, 100, "kernel"),
           Event("cutlass_80_simt_sgemm", 250, 150, "kernel"),
           Event("Memcpy DtoH (Device -> Pageable)", 600, 100, "gpu_memcpy"),
           Event("vectorized_elementwise_kernel", 900, 50, "kernel"),
           Event("vectorized_elementwise_kernel", 980, 10, "kernel"),
           Event("adam_update", 900, 60, "gpu_user_annotation"),
           Event("cudaLaunchKernel", 90, 5, "cuda_runtime"),
           Event("aten::mm", 240, 20, "cpu_op"),
           Event("cudaMemcpyAsync", 500, 300, "cuda_runtime"),
           Event("aten::add", 400, 50, "cpu_op", thread=2)]
    if with_program:
        for name, a, b in PROGRAM:
            evs.append(Event(name, a, b - a, "user_annotation"))
            evs.append(Event(name, a + 5, b - a, "gpu_user_annotation"))
    return evs


# the port's spans, as take_spans gives them (us)
PROGRAM = [("render.chunk", 50, 450), ("render.density", 60, 210),
           ("render.heads", 240, 380), ("render.to_host", 500, 800)]


def window(with_program: bool) -> tr.Trace:
    w = tr.Window(torch)
    w.cuda = False
    evs = events(with_program)
    w.prof = SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: evs)),
        __exit__=lambda *a: None)
    w.span = SimpleNamespace(__exit__=lambda *a: None)
    w.__exit__(None, None, None)
    return w.trace


def contexts(trace: tr.Trace) -> dict:
    """A render and a train reader context on ``trace``."""
    return {"render": {"trace": trace, "rays": 2048, "calls": 1,
                       "prepare_ms": [3.0],
                       "k1": {"need_s": 2e-5, "device_s": 1e-4},
                       "flops_per_ray": 1e6, "peak_flops": 67e12},
            "train": {"trace": trace, "steps": 2, "flops_per_step": 1e9,
                      "peak_flops": 67e12}}


@pytest.mark.parametrize("name", EARLIER)
def test_earlier_metrics_read_the_same_with_program_spans(name):
    kind = "train" if name.endswith(".train") else "render"
    plain, traced = (contexts(window(w))[kind] for w in (False, True))
    assert run.read_metric(name, traced) == run.read_metric(name, plain)
    assert run.read_metric(name, plain) is not None


def test_breakdown_reads_the_same_with_program_spans():
    plain, traced = window(False), window(True)
    assert tr.breakdown(traced) == tr.breakdown(plain)
    assert traced.spans == plain.spans and traced.ops == plain.ops
    assert traced.cpu_ops == plain.cpu_ops
    assert traced.ranges == plain.ranges == {"adam_update": [60 * US]}


def test_program_readers_give_their_hand_computed_values():
    """Gaps (us): 200-250, 400-600, 700-900, 950-980 in a 1,000 us
    window. ``render.to_host`` (500-800) covers 100 + 100 of them: 20%.
    By the innermost span open during each stretch of them: 200 under
    ``render.to_host``, 180 outside (450-500, 800-900, 950-980), 80 under
    ``render.chunk`` (210-240, 400-450), 10 under ``render.density``
    (200-210), 10 under ``render.heads`` (240-250)."""
    ctx = contexts(window(True))
    spans = [(n, a * US, b * US) for n, a, b in PROGRAM]
    render = {**ctx["render"], "program_spans": spans,
              "program_counters": {"k1.live": 3, "k1.slots": 12,
                                   "heads.live": 5, "heads.slots": 8}}
    assert run.read_metric("to_host_idle_pct.render", render) == \
        pytest.approx(20.0)
    assert run.read_metric("k1_live_pct.render", render) == 25.0
    assert run.read_metric("head_live_pct.render", render) == 62.5
    got = program.idle_by_span(render["trace"], spans)
    assert [n for n, _ in got] == ["render.to_host", program.OUTSIDE,
                                   "render.chunk", "render.density",
                                   "render.heads"]
    assert [s for _, s in got] == pytest.approx([200e-6, 180e-6, 80e-6,
                                                 10e-6, 10e-6])
    train = {**ctx["train"],
             "program_spans": [("train.sample", 0, 1500 * US),
                               ("train.main", 1500 * US, 1900 * US),
                               ("train.sample", 2000 * US, 2500 * US)],
             "program_counters": {"heads.live": 1, "heads.slots": 64}}
    assert run.read_metric("sample_ms.train", train) == 1.0
    assert run.read_metric("head_live_pct.train", train) == 1.5625


def test_program_without_spans_or_counters_reads_nothing(monkeypatch):
    """A program without take_spans and take_counters (the parent of the
    change that brought them): every new reader gives None and raises
    nothing."""
    from contrastive_lift_tpu_torch.utils import observability
    monkeypatch.delattr(observability, "take_spans")
    monkeypatch.delattr(observability, "take_counters")
    ctx = contexts(window(False))
    for name in ("to_host_idle_pct.render", "k1_live_pct.render",
                 "head_live_pct.render"):
        assert run.read_metric(name, ctx["render"]) is None
    for name in ("head_live_pct.train", "sample_ms.train"):
        assert run.read_metric(name, ctx["train"]) is None


def test_first_reader_takes_from_the_program_once():
    from contrastive_lift_tpu_torch.utils import observability as obs
    obs.take_spans(), obs.take_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span("render.to_host"):
            obs.count("heads.slots", 4)
            obs.count("heads.live", torch.tensor([True, False, True]))
    ctx = {}
    assert program.share(ctx, "heads.live", "heads.slots") == 50.0
    assert [n for n, _, _ in program.spans(ctx)] == ["render.to_host"]
    assert program.counters(ctx) == {"heads.live": 2, "heads.slots": 4}
    assert obs.take_counters() == {} and obs.take_spans() == []


RENDER_SMALL = {"grid_dim": (32, 32, 32),
                "mix_overrides": {"height": 12, "width": 16, "chunk": 256}}
TRAIN_SMALL = {"grid_dim": (24, 24, 24),
               "mix_overrides": {"train": {"frames": 4, "hw": [32, 32],
                                           "classes": 21, "confidence": 0.9}},
               "config_overrides": {"batch_size": 512,
                                    "batch_size_segments": 8,
                                    "max_rays_segments": 256,
                                    "max_rays_instances": 256}}


@pytest.mark.parametrize("cell", ["cl.render_fixed", "cl.train_fixed"])
def test_traced_run_reads_the_program(cell, monkeypatch):
    """A traced run on the CPU at a small size (the render's wrapper of
    ``prepare_render`` synchronises a card: not here): the program's
    counters and spans are read, and ``spans.py`` breaks the window down by
    them."""
    from benchmark import spans
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    small = RENDER_SMALL if "render" in cell else TRAIN_SMALL
    res = spans.traced(cell, 2 ** 31 + 31, 0.2, torch.device("cpu"),
                       time.perf_counter(), **small)
    assert res["correct"], res
    m = res["metrics"]
    if "render" in cell:
        assert 0 < m["k1_live_pct.render"]["value"] < 100
        assert 0 < m["head_live_pct.render"]["value"] <= 100
        assert res["spans"]["render.chunk"]["count"] >= 1
        assert res["spans"]["render.to_host"]["count"] >= 1
    else:
        assert 0 < m["head_live_pct.train"]["value"] <= 100
        assert m["sample_ms.train"]["value"] > 0
        assert res["spans"]["train.sample"]["count"] == 3 * res["attempted"]
        phases = {n for n, _ in res["breakdown"]["idle_by_step_phase"]}
        assert phases <= {*res["spans"], program.OUTSIDE}
        assert not any(n.startswith("render.") for n in phases)
    assert "idle_by_program_span" in res["breakdown"]
    assert not run.forbidden_modules()
