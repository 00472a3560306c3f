"""The train cell's check: the reference replays the program's steps, and a
run with the timed path broken underneath comes out not correct.

On the CPU at a small size (grid 24, 4 frames of 32x32, a quarter of the
batches), past the harness's look for a card: a sound run is correct; a
step that returns its state unchanged, half of the main batch left out
(the mean over the rest), the rendered rgb altered where ``render_rays``
produces it, a sampler that pairs rays with the wrong labels and one that
builds a segment bundle from two segments are not.
"""
import time

import numpy as np
import pytest
import torch

from benchmark import run

SMALL = {"grid_dim": (24, 24, 24),
         "mix_overrides": {"train": {"frames": 4, "hw": [32, 32],
                                     "classes": 21, "confidence": 0.9}},
         "config_overrides": {"batch_size": 512, "batch_size_segments": 8,
                              "max_rays_segments": 256,
                              "max_rays_instances": 256}}


def unchanged(make_train_step):
    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def frozen(state, *rest):
            _, metrics = step(state, *rest)
            return state, metrics
        return frozen
    return make


def half_batch(make_train_step):
    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def half(state, state_r, main, inst, seg, draws, *rest):
            n = main["rays"].shape[0] // 2
            draws = draws._replace(main=draws.main._replace(
                jitter=draws.main.jitter[:n]))
            return step(state, state_r, {k: v[:n] for k, v in main.items()},
                        inst, seg, draws, *rest)
        return half
    return make


def labels_rolled(sample):
    """The main batch's labels moved one row over: rays paired with the
    wrong labels."""
    def rolled(self, rng, n):
        b = sample(self, rng, n)
        for k in ("rgbs", "semantics", "probabilities"):
            b[k] = np.roll(b[k], 1, axis=0)
        return b
    return rolled


def segments_mixed(sample):
    """The first two segment slots swap the second half of their rays: a
    segment bundle built from two segments."""
    def mixed(self, rng, n):
        b = sample(self, rng, n)
        r, q = self.max_rays, self.max_rays // 4
        a, c = b["rays"][q:2 * q].copy(), b["rays"][r + q:r + 2 * q].copy()
        b["rays"][q:2 * q], b["rays"][r + q:r + 2 * q] = c, a
        return b
    return mixed


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "answer_altered", "labels_rolled",
                                   "segments_mixed"])
def test_train_fault_comes_out_not_correct(fault, monkeypatch):
    from contrastive_lift_tpu_torch.data import base as B
    from contrastive_lift_tpu_torch.renderer import render as R
    from contrastive_lift_tpu_torch.train import step as S
    if fault == "labels_rolled":
        monkeypatch.setattr(B.RayPoolSampler, "sample",
                            labels_rolled(B.RayPoolSampler.sample))
    elif fault == "segments_mixed":
        monkeypatch.setattr(B.SegmentBundleSampler, "sample",
                            segments_mixed(B.SegmentBundleSampler.sample))
    elif fault == "unchanged":
        monkeypatch.setattr(S, "make_train_step", unchanged(S.make_train_step))
    elif fault == "half_batch":
        monkeypatch.setattr(S, "make_train_step", half_batch(S.make_train_step))
    elif fault == "answer_altered":
        render_rays = R.render_rays

        def altered(*a, **kw):
            out = render_rays(*a, **kw)
            out["rgb"] = out["rgb"] + 0.01
            return out
        monkeypatch.setattr(R, "render_rays", altered)
    res = run.run_cell("cl.train_fixed", 2 ** 31 + 21, 0.1, False,
                       torch.device("cpu"), time.perf_counter(), **SMALL)
    assert res["correct"] is (fault is None), res["checks"]
    assert not run.forbidden_modules()
