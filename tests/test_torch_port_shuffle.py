"""The bundle samplers' permutations, drawn natively on numpy's PCG64 stream
(``data/shuffle.py``, ``csrc/shuffle.cpp``).

The native path gives what ``rng.permutation(n)[:keep]`` gives, and leaves
the generator in the state numpy leaves it in, with and without a half of
a 32-bit draw pending; the samplers' batches are the same on either path;
another bit generator, a size past the library's, a library that fails its
check on loading, each takes numpy's path; the counters count both.
"""
import subprocess

import numpy as np
import pytest
import torch

from contrastive_lift_tpu_torch.data import shuffle
from contrastive_lift_tpu_torch.data.base import (FrameData,
                                                  InstanceBundleSampler,
                                                  SegmentBundleSampler)
from contrastive_lift_tpu_torch.utils import observability as obs

SIZES = (0, 1, 2, 3, 4, 5, 7, 8, 9, 255, 256, 257, 1023, 1024, 1025, 4095,
         4097, 65535, 65537, 262144)


@pytest.fixture
def lib():
    """The library as built, before its check on loading."""
    try:
        return shuffle._open()
    except (OSError, subprocess.CalledProcessError) as exc:
        pytest.skip(f"the native shuffle does not build here ({exc})")


def test_library_passes_its_check_on_loading(lib):
    assert shuffle._agrees(lib)
    assert shuffle.native_available()


def _pending(rng: np.random.Generator) -> np.random.Generator:
    """``rng`` after one 32-bit draw: the other half of its step pending."""
    rng.integers(0, 7)
    assert rng.bit_generator.state["has_uint32"] == 1
    return rng


def _same_after(a: np.random.Generator, b: np.random.Generator) -> None:
    assert a.bit_generator.state == b.bit_generator.state
    # and numpy draws on from either alike, 32-bit halves and whole steps
    assert np.array_equal(a.integers(0, 5, 7), b.integers(0, 5, 7))
    assert np.array_equal(a.integers(0, 1 << 40, 3),
                          b.integers(0, 1 << 40, 3))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 63 + 11])
@pytest.mark.parametrize("pending", [False, True])
@pytest.mark.parametrize("keep", [1024, 1, 300, 300000])
def test_native_equals_numpy_permutation(lib, seed, pending, keep):
    """Every size in one call, in a seeded order: each first ``keep``
    indices, and the generator's state after them, are numpy's."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    if pending:
        a, b = _pending(a), _pending(b)
    sizes = [int(n) for n in np.random.default_rng(seed).permutation(SIZES)]
    want = [a.permutation(n)[:keep] for n in sizes]
    got = shuffle._native_heads(lib, b, sizes, keep)
    assert len(got) == len(want)
    for n, x, y in zip(sizes, want, got):
        assert np.array_equal(x, y), n
    _same_after(a, b)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 65537])
def test_native_single_size_each_parity(lib, n):
    """One size a call, from each parity of the 32-bit draws used before."""
    for pending in (False, True):
        a, b = np.random.default_rng(n + 5), np.random.default_rng(n + 5)
        if pending:
            a, b = _pending(a), _pending(b)
        for _ in range(3):
            assert np.array_equal(a.permutation(n)[:1024],
                                  shuffle._native_heads(lib, b, [n], 1024)[0])
            _same_after(a, b)


def test_native_refuses_a_size_past_its_limit(lib):
    rng = np.random.default_rng(3)
    before = rng.bit_generator.state
    with pytest.raises(ValueError):
        shuffle._native_heads(lib, rng, [5, shuffle.LIMIT], 4)
    assert rng.bit_generator.state == before


def _frames(seed: int, n_frames: int = 3, hw: int = 48):
    """Frames whose segments run from 1 pixel to most of the image."""
    rng = np.random.default_rng(seed)
    out = []
    n = hw * hw
    for i in range(n_frames):
        inst = np.zeros(n, np.int32)
        inst[: n // 2] = 1                    # one large segment
        inst[n // 2: n // 2 + 300] = 2
        inst[n // 2 + 300: n // 2 + 305] = 3  # one of 5 pixels
        inst[n // 2 + 305:] = rng.integers(4, 9, n - n // 2 - 305)
        rng.shuffle(inst)
        out.append(FrameData(
            f"{i:02d}", rng.normal(size=(n, 8)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            rng.integers(0, 5, n).astype(np.int32), inst,
            np.full((n, 5), 0.2, np.float32),
            rng.uniform(0.5, 1, n).astype(np.float32),
            rng.uniform(0, 1, n) > 0.05, segments=inst))
    return out


def _draws(sampler, size: int, seed: int, steps: int = 3):
    rng = np.random.default_rng(seed)
    got = [sampler.sample(rng, size) for _ in range(steps)]
    return got, rng.bit_generator.state


@pytest.mark.parametrize("kind,size,max_rays", [
    ("instance", 1, 1024), ("instance", 3, 256), ("instance", 2, 8192),
    ("segment", 32, 1024), ("segment", 5, 64)])
def test_sampler_batches_equal_on_either_path(lib, monkeypatch, kind, size,
                                              max_rays):
    assert shuffle.native_available()
    frames = _frames(11)
    sampler = (InstanceBundleSampler(frames, max_rays, 4)
               if kind == "instance" else SegmentBundleSampler(frames,
                                                               max_rays))
    native, native_state = _draws(sampler, size, 2 ** 31 + 3)
    monkeypatch.setattr(shuffle, "_lib", None)   # numpy's path
    monkeypatch.setattr(shuffle, "_tried", True)
    plain, plain_state = _draws(sampler, size, 2 ** 31 + 3)
    assert native_state == plain_state
    for x, y in zip(native, plain):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]), k


def _counted(fn):
    obs.take_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, obs.take_counters()


def test_counters_count_native_elements(lib):
    rng = np.random.default_rng(4)
    _, got = _counted(lambda: shuffle.heads(rng, [10, 0, 300], 16))
    assert got == {"sample.shuffled": 310, "sample.native": 310}


@pytest.mark.parametrize("case", ["mt19937", "past_limit"])
def test_numpy_path_where_native_cannot_draw(lib, monkeypatch, case):
    """Another bit generator than PCG64, or a size at the library's limit
    (lowered here to 300), draws with numpy: the same indices, nothing
    counted as native."""
    if case == "mt19937":
        make = lambda: np.random.Generator(np.random.MT19937(5))  # noqa: E731
    else:
        monkeypatch.setattr(shuffle, "LIMIT", 300)
        make = lambda: np.random.default_rng(5)  # noqa: E731
    a, b = make(), make()
    sizes = [40, 300, 7]
    got, counts = _counted(lambda: shuffle.heads(b, sizes, 32))
    want = [a.permutation(n)[:32] for n in sizes]
    assert all(np.array_equal(x, y) for x, y in zip(want, got))
    assert np.array_equal(a.integers(0, 1 << 40, 5), b.integers(0, 1 << 40, 5))
    assert counts == {"sample.shuffled": 347}


class _Off:
    """A library whose results are one index off numpy's."""

    def __init__(self, lib):
        self.lib = lib

    def pcg64_permutation_heads(self, st, sizes, count, keep, out):
        code = self.lib.pcg64_permutation_heads(st, sizes, count, keep, out)
        out[:, 0] += 1
        return code


def test_failed_check_on_loading_disables_the_native_path(lib, monkeypatch):
    monkeypatch.setattr(shuffle, "_open", lambda: _Off(lib))
    monkeypatch.setattr(shuffle, "_lib", None)
    monkeypatch.setattr(shuffle, "_tried", False)
    assert not shuffle.native_available()
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    got, counts = _counted(lambda: shuffle.heads(b, [50, 2000], 1024))
    assert all(np.array_equal(a.permutation(n)[:1024], x)
               for n, x in zip([50, 2000], got))
    assert counts == {"sample.shuffled": 2050}
    # the library as built passes the same check
    assert shuffle._agrees(lib)
