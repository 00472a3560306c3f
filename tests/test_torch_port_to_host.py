"""The frame loop's maps to the host (``inference/render.py::_MapsToHost``).

``render_frames`` writes each chunk's maps into arrays of the frame's own
length as the chunks render: on the CPU at once, on a card through pinned
staging slots and a side stream, drained by a worker thread. Its maps are
held to the loop it replaced, kept here as ``previous_path`` (each frame's
padded chunks rendered, each map copied with ``.cpu().numpy()``, the chunks
concatenated and the padding cut): equal bit for bit, in dtype and shape,
each array owning its memory and left alone by a later call. The counters
``to_host.copies`` and ``to_host.ready`` are recorded under a profiler
alone. The field is the tracing tests' slab (``test_torch_port_tracing``).
This file imports no JAX, so its ``cuda`` tests run on a GPU host:

    python -m pytest --noconftest tests/test_torch_port_to_host.py -q -m cuda
"""
import sys

import numpy as np
import pytest
import torch

from contrastive_lift_tpu_torch.inference import render as IR
from contrastive_lift_tpu_torch.renderer import render as R
from contrastive_lift_tpu_torch.utils import observability as obs
from contrastive_lift_tpu_torch.utils.tree import tree_map
from test_torch_port_tracing import _frames, _profiled, _render_setup

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings(
    "ignore:empty-space-skipping budget margin exhausted")

CHUNK = 64   # divides none of the frames below


def previous_path(params, mcfg, rcfg, state_r, frames, chunk, device):
    """The frame loop as it was: a frame's chunks rendered, then each map
    ``.cpu().numpy()``; the frames' maps concatenated, the padding cut."""
    dev = torch.device(device)
    outs = []
    with torch.no_grad():
        rcfg, fused = IR.prepare_render(params, mcfg, rcfg, state_r, frames)
        for f in frames:
            rays = torch.from_numpy(IR._pad_to_chunks(f.rays, chunk)).to(dev)
            chunks = [R.render_rays(params, mcfg, rcfg, state_r,
                                    rays[lo:lo + chunk], fused=fused)
                      for lo in range(0, len(rays), chunk)]
            outs.append([{k: o[k].cpu().numpy() for k in IR.MAP_KEYS}
                         for o in chunks])
    return [{k: np.concatenate([o[k] for o in frame])[:len(f.rays)]
             for k in IR.MAP_KEYS} for f, frame in zip(frames, outs)]


def _setup(device="cpu"):
    params, mcfg, rcfg, state_r = _render_setup()
    if device != "cpu":
        params = tree_map(lambda t: t.to(device), params)
        state_r = R.RenderState(*(t.to(device) for t in state_r))
    return params, mcfg, rcfg, state_r


def _assert_same_maps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(IR.MAP_KEYS)
        for k in IR.MAP_KEYS:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.array_equal(g[k], w[k]), k
            assert g[k].flags.owndata and g[k].flags.c_contiguous, k


def _chunks(frames, chunk=CHUNK):
    return sum(-(-len(f.rays) // chunk) for f in frames)


def test_maps_equal_the_previous_path():
    """Three frames of 150, 97 and 200 rays at chunk 64: every map equals
    the previous loop's bit for bit, in dtype and shape, with the padding
    cut, each in an array that owns its memory."""
    args = _setup()
    frames = [_frames(1, n)[0] for n in (150, 97, 200)]
    got = IR.render_frames(*args, frames, chunk=CHUNK, device="cpu")
    want = previous_path(*args, frames, CHUNK, "cpu")
    _assert_same_maps(got, want)
    assert [g["rgb"].shape[0] for g in got] == [150, 97, 200]
    assert got[0]["instances"].dtype == np.float32


def test_second_call_leaves_the_first_calls_maps():
    args = _setup()
    first = IR.render_frames(*args, _frames(2, 150), chunk=CHUNK,
                             device="cpu")
    kept = [{k: v.copy() for k, v in m.items()} for m in first]
    second = IR.render_frames(*args, _frames(3, 100), chunk=CHUNK,
                              device="cpu")
    for a, b in zip(first, kept):
        for k in IR.MAP_KEYS:
            assert np.array_equal(a[k], b[k]), k
    for m in second:
        for k in IR.MAP_KEYS:
            assert not any(np.shares_memory(m[k], a[k]) for a in first), k


def test_counters_under_a_profiler_alone_on_the_cpu():
    """On the CPU every chunk's maps are in place when the host comes to
    them: ``to_host.ready`` = ``to_host.copies`` = the chunks, each in its
    ``render.to_host`` span; no profiler, no counter."""
    args = _setup()
    frames = _frames(2, 150)
    obs.take_counters()
    IR.render_frames(*args, frames, chunk=CHUNK, device="cpu")
    assert obs.take_counters() == {}
    _, _, spans, got = _profiled(lambda: IR.render_frames(
        *args, frames, chunk=CHUNK, device="cpu"))
    assert got["to_host.copies"] == got["to_host.ready"] == _chunks(frames)
    assert sum(n == "render.to_host" for n, _, _ in spans) == _chunks(frames)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned staging and the side "
                    "stream exist only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_pinned_path_equals_the_previous_path_on_card(cuda_device):
    """On the card the maps through the pinned slots equal the previous
    loop's synchronous ``.cpu()`` copies of the same chunks, bit for bit,
    also with the interpreter switching threads as often as it can (the
    launching thread and the drain's worker share the slots)."""
    args = _setup(cuda_device)
    frames = [_frames(1, n)[0] for n in (150, 97, 200, 1000, 2000)]
    want = previous_path(*args, frames, CHUNK, cuda_device)
    _assert_same_maps(IR.render_frames(*args, frames, chunk=CHUNK,
                                       device=cuda_device), want)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = IR.render_frames(*args, frames, chunk=CHUNK, device=cuda_device)
    finally:
        sys.setswitchinterval(interval)
    _assert_same_maps(got, want)


@pytest.mark.cuda
def test_pinned_staging_does_not_grow_with_frames(cuda_device):
    """The pinned bytes torch's host allocator holds (in use and cached)
    after 16 frames are what it held after 2: the staging ring and the
    rays' uploads are reused."""
    args = _setup(cuda_device)

    def held(n_frames):
        IR.render_frames(*args, _frames(n_frames, 640), chunk=CHUNK,
                         device=cuda_device)
        torch.cuda.synchronize()
        return torch.cuda.host_memory_stats()["allocated_bytes.current"]

    held(2)
    two = held(2)
    assert two > 0
    assert held(16) == two


@pytest.mark.cuda
def test_card_counters_under_a_profiler_alone(cuda_device):
    args = _setup(cuda_device)
    frames = _frames(3, 300)
    obs.take_counters()
    IR.render_frames(*args, frames, chunk=CHUNK, device=cuda_device)
    assert obs.take_counters() == {}
    _, _, _, got = _profiled(lambda: IR.render_frames(
        *args, frames, chunk=CHUNK, device=cuda_device))
    assert got["to_host.copies"] == _chunks(frames)
    assert 0 <= got.get("to_host.ready", 0) <= got["to_host.copies"]
