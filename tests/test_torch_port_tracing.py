"""The port's spans and counters (``utils/observability.py``) on the CPU.

Without a profiler a span is one shared null context and a count moves
nothing. Under ``torch.profiler`` a small ``render_frames`` and one
training step give every span of the frame loop, the renderer chunk, the
samplers and the step, nested as the code nests them, in the profiler's
events and in ``take_spans``; the render's maps are the same with and
without the profiler; the counters equal a direct count of the samples
the density kernel and the heads evaluated. The field is a slab of density
across the box of a grid-16 model, the rays cross it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from contrastive_lift_tpu_torch.config import load_config
from contrastive_lift_tpu_torch.data.base import (FrameData,
                                                  InstanceBundleSampler,
                                                  RayPoolSampler,
                                                  SegmentBundleSampler)
from contrastive_lift_tpu_torch.factory import build_model
from contrastive_lift_tpu_torch.inference import render as IR
from contrastive_lift_tpu_torch.losses.losses import get_semantic_weights
from contrastive_lift_tpu_torch.renderer import render as R
from contrastive_lift_tpu_torch.train import step as S
from contrastive_lift_tpu_torch.train.state import init_train_state
from contrastive_lift_tpu_torch.utils import observability as obs

torch.set_num_threads(2)
# the slab fills the small grid's last kept sub-segment on some rays
pytestmark = pytest.mark.filterwarnings(
    "ignore:empty-space-skipping budget margin exhausted")

GRID = 16
CLASSES = 3
RENDER_SPANS = ("render.select", "render.density", "render.head_select",
                "render.heads", "render.composite")
TRAIN_SPANS = ("train.to_device", "train.main", "train.segment",
               "train.main_backward", "train.main_update", "train.instance",
               "train.instance_backward", "train.ema", "train.instance_update")
TRAIN_CONFIG = {"instance_loss_mode": "slow_fast", "use_DINO_style": True,
                "max_instances": 3, "batch_size": 64,
                "max_rays_instances": 32, "max_rays_segments": 16,
                "batch_size_segments": 4, "chunk_segment": 32,
                "max_labels_per_image": 8, "weight_class_0": 1.0,
                "min_grid_dim": GRID, "seed": 0}


def _model(overrides=None):
    """(cfg, mcfg, params, rcfg, state_r) of a grid-16 model whose density
    is a slab: the first term's plane 1 everywhere, its z line 30 on the
    middle third, every other factor 0."""
    cfg = load_config(overrides=overrides or {})
    mcfg, params, rcfg, state_r = build_model(
        cfg, CLASSES, grid_dim=(GRID,) * 3, seed=0, device="cpu")
    dens = params["density"]
    for t in (*dens["planes"], *dens["lines"]):
        t.zero_()
    dens["planes"][0][0] = 1.0
    dens["lines"][0][0, GRID // 3:2 * GRID // 3] = 30.0
    return cfg, mcfg, params, rcfg, state_r


def _rays(n, seed):
    """[n, 8] rays from below the box, up through the slab at a tilt."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                        np.full((n, 1), -1.5)], 1)
    d = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d, np.zeros((n, 1)), np.full((n, 1), 4.0)],
                          1).astype(np.float32)


def _frames(n_frames=2, n_rays=150):
    empty = np.zeros((0,), np.float32)
    return [FrameData(f"{i:02d}", _rays(n_rays, i), empty, empty, empty,
                      empty, empty, empty) for i in range(n_frames)]


def _render_setup():
    _, mcfg, params, rcfg, state_r = _model()
    return params, mcfg, dataclasses.replace(rcfg, head_topk=4), state_r


def _profiled(fn):
    """fn() under torch.profiler: (its result, the profiler's event names,
    the spans and counters it recorded)."""
    obs.take_spans(), obs.take_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return out, names, obs.take_spans(), obs.take_counters()


def _inside(spans, inner, outer):
    """Each span ``inner`` lies inside some span ``outer``."""
    outs = [(a, b) for n, a, b in spans if n == outer]
    ins = [(a, b) for n, a, b in spans if n == inner]
    return bool(ins) and all(any(a0 <= a and b <= b0 for a0, b0 in outs)
                             for a, b in ins)


def test_span_without_profiler_is_the_shared_null_context(monkeypatch):
    """No profiler: every span is the same null context, no
    record_function is made, and a count moves no counter."""
    def refuse(*a, **kw):
        raise AssertionError("record_function made without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    obs.take_spans(), obs.take_counters()
    assert not torch._C._autograd._profiler_enabled()
    assert obs.span("render.chunk") is obs.span("train.main")
    with obs.span("render.chunk"):
        obs.count("k1.live", torch.ones(5, dtype=torch.bool))
        obs.count("k1.slots", 5)
    assert obs.take_counters() == {} and obs.take_spans() == []


def test_counters_add_on_host_and_device():
    """Under a profiler: ints add on the host, tensors as their sums (also
    past the fold of partial sums); a take clears them."""
    def counts():
        for _ in range(obs._Recorder.FOLD + 3):
            obs.count("live", torch.tensor([True, False, True]))
        obs.count("slots", 7)
        obs.count("slots", 2)

    _, _, _, got = _profiled(counts)
    assert got == {"live": 2 * (obs._Recorder.FOLD + 3), "slots": 9}
    assert obs.take_counters() == {}


def test_render_maps_equal_with_and_without_profiler():
    """render_frames gives the same maps with and without a profiler."""
    params, mcfg, rcfg, state_r = _render_setup()
    frames = _frames()
    plain = IR.render_frames(params, mcfg, rcfg, state_r, frames, chunk=64,
                             device="cpu")
    traced, _, _, _ = _profiled(lambda: IR.render_frames(
        params, mcfg, rcfg, state_r, frames, chunk=64, device="cpu"))
    for a, b in zip(plain, traced):
        for k in IR.MAP_KEYS:
            np.testing.assert_array_equal(a[k], b[k], k)


def test_render_spans_nest():
    """Under a profiler a render_frames call gives the frame loop's spans
    and each chunk's stages inside ``render.chunk``, in the profiler's
    events and in take_spans, nested as the table of the code says."""
    params, mcfg, rcfg, state_r = _render_setup()
    _, names, spans, _ = _profiled(lambda: IR.render_frames(
        params, mcfg, rcfg, state_r, _frames(), chunk=64, device="cpu"))
    want = ("render.frames", "render.prepare", "render.grids",
            "render.calibrate", "render.rays_in", "render.chunk",
            "render.to_host") + RENDER_SPANS
    assert set(want) <= names
    assert set(want) == {n for n, _, _ in spans}
    for name in want[1:]:
        assert _inside(spans, name, "render.frames"), name
    assert _inside(spans, "render.grids", "render.prepare")
    assert _inside(spans, "render.calibrate", "render.prepare")
    # a chunk's stages, and the calibration's probe through the same
    # selection and density
    outer = [(a, b) for n, a, b in spans
             if n in ("render.chunk", "render.calibrate")]
    for name in RENDER_SPANS:
        assert all(any(a0 <= a and b <= b0 for a0, b0 in outer)
                   for n, a, b in spans if n == name), name
    assert _inside(spans, "render.heads", "render.chunk")
    # 2 frames of 150 rays at chunk 64: 3 chunks each
    assert sum(n == "render.chunk" for n, _, _ in spans) == 6
    # each chunk's copy into its frame's arrays (on the CPU, at once)
    assert sum(n == "render.to_host" for n, _, _ in spans) == 6


def test_render_counters_equal_a_direct_count():
    """On one chunk at fixed budgets: k1.slots and k1.live are the
    selected samples' slots and those valid and in the box, heads.slots and
    heads.live the top-k head slots and those over the weight threshold."""
    params, mcfg, rcfg, state_r = _render_setup()
    rcfg, fused = IR.prepare_render(params, mcfg, rcfg, state_r, [],
                                    auto_budget=False)
    rays = torch.from_numpy(_rays(200, 5))
    dens = R._two_level_density(mcfg, rcfg, state_r, rays, fused)
    in_box, weight = dens[2], dens[6]
    w_k, _, _ = R._head_select(rcfg, weight, rcfg.head_topk)
    want = {"k1.slots": in_box.numel(), "k1.live": int(in_box.sum()),
            "heads.slots": w_k.numel(),
            "heads.live": int((w_k > rcfg.raymarch_weight_thres).sum())}
    _, _, _, got = _profiled(lambda: R.render_rays(
        params, mcfg, rcfg, state_r, rays, fused=fused))
    assert got == want
    assert 0 < want["k1.live"] < want["k1.slots"]
    assert 0 < want["heads.live"] < want["heads.slots"]


def _train_setup():
    cfg, mcfg, params, rcfg, state_r = _model(TRAIN_CONFIG)
    rng = np.random.default_rng(3)
    frames = []
    for i in range(2):
        n = 256
        inst = rng.integers(1, 4, n).astype(np.int32)
        sem = rng.integers(0, CLASSES, n).astype(np.int32)
        frames.append(FrameData(
            f"{i:02d}", _rays(n, 10 + i), rng.uniform(0, 1, (n, 3))
            .astype(np.float32), sem, inst,
            np.eye(CLASSES, dtype=np.float32)[sem],
            np.ones(n, np.float32), np.ones(n, bool), segments=inst))
    samplers = (RayPoolSampler(frames, CLASSES),
                InstanceBundleSampler(frames, cfg.max_rays_instances,
                                      cfg.max_labels_per_image),
                SegmentBundleSampler(frames, cfg.max_rays_segments))
    gates = S.gates_for_epoch(cfg, 10)
    class_w = get_semantic_weights(cfg.reweight_fg, [], CLASSES,
                                   cfg.weight_class_0, device="cpu")
    step = S.make_train_step(cfg, mcfg, rcfg, gates, class_w, params,
                             aux_head_topk=8)
    return cfg, state_r, samplers, init_train_state(cfg, params), step


def test_train_step_spans_nest():
    """Under a profiler the samplers and one step give every span of the
    step, Adam's ``adam_update`` inside each update, the renderer's chunks
    inside the forward phases, and the heads' counters."""
    cfg, state_r, (main, inst, seg), state, step = _train_setup()

    def one():
        rng = np.random.default_rng(0)
        batches = (main.sample(rng, cfg.batch_size),
                   inst.sample(rng, cfg.batch_size_contrastive),
                   seg.sample(rng, cfg.batch_size_segments))
        return step(state, state_r, *batches, torch.Generator().manual_seed(0),
                    1.0, 1e-3)

    (_, metrics), names, spans, counters = _profiled(one)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    want = ("train.sample", "adam_update", "render.chunk") + TRAIN_SPANS
    assert set(want) <= names
    assert set(want) <= {n for n, _, _ in spans}
    assert sum(n == "train.sample" for n, _, _ in spans) == 3
    outer = [(a, b) for n, a, b in spans
             if n in ("train.main_update", "train.instance_update")]
    assert all(any(a0 <= a and b <= b0 for a0, b0 in outer)
               for n, a, b in spans if n == "adam_update")
    forward = [(a, b) for n, a, b in spans
               if n in ("train.main", "train.segment", "train.instance",
                        "train.main_backward")]
    assert all(any(a0 <= a and b <= b0 for a0, b0 in forward)
               for n, a, b in spans if n == "render.chunk")
    assert 0 < counters["heads.live"] < counters["heads.slots"]


@pytest.mark.parametrize("mode", ["one_pass", "two_phase"])
def test_head_counters_follow_the_head_pass(mode):
    """heads.slots counts the slots each head pass evaluates: every ray's
    top-k in one pass; in two phases pass A's kA a ray and pass B's k - kA
    for the survivors."""
    params, mcfg, rcfg, state_r = _render_setup()
    rcfg, fused = IR.prepare_render(params, mcfg, rcfg, state_r, [],
                                    auto_budget=False)
    if mode == "two_phase":
        rcfg = dataclasses.replace(rcfg, head_term_first=2,
                                   head_term_fraction=0.25)
    n = 128
    rays = torch.from_numpy(_rays(n, 6))
    _, _, _, got = _profiled(lambda: R.render_rays(
        params, mcfg, rcfg, state_r, rays, fused=fused))
    k = rcfg.head_topk
    want = n * k if mode == "one_pass" else n * 2 + (n // 4) * (k - 2)
    assert got["heads.slots"] == want
    assert 0 < got["heads.live"] <= want
