"""The port's production ``render_frames`` and pipeline against the JAX
package, on the CPU at grid 14: the calibrated config, the guardrail
warnings and the maps of ``render_frames`` with its defaults, the kernel's
inputs that ``fidelity.production_chunk`` gives, and ``run_production``
against the JAX render plus the PQ gate's clustering and scoring.

The fields are those of ``test_torch_port_production.py``; the JAX render is
jitted, so maps compare at fp32 summation-order tolerance (3e-2 with bf16
heads).
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from contrastive_lift_tpu.inference import render as jrender
from contrastive_lift_tpu.renderer import render as jR
from contrastive_lift_tpu_torch.inference import fidelity as tfid
from contrastive_lift_tpu_torch.inference import render as trender
from contrastive_lift_tpu_torch.ops import fused_grid as tfg
from contrastive_lift_tpu_torch.renderer import render as tR
from test_torch_port_production import (BF16_BAR, F32_BAR, _both_rays, _load,
                                        _sparse_checkpoint)
from test_torch_port_render import (MAP_KEYS, VARIANTS, JFrame, TFrame,
                                    _checkpoint, _rays, gate)

torch.set_num_threads(2)


# render_frames cases: (checkpoint variant, render config changes,
# render_frames keywords, bar), on the sparse field unless "all_occupied"
RENDER_CASES = {
    "defaults": ({}, {}, {}, F32_BAR),
    "all_occupied": ({}, {}, {}, F32_BAR),
    "bf16_heads": ({}, dict(head_topk_semins=8, head_dtype="bfloat16"), {},
                   BF16_BAR),
    "no_tail_complete": ({}, {}, dict(tail_complete=False), F32_BAR),
    "head_term_forced": ({}, dict(head_term_first=4, head_term_fraction=0.5),
                         dict(head_term=False), F32_BAR),
    "semins_prefix": ({}, dict(head_topk_semins=5), {}, F32_BAR),
    "grid_heads": (VARIANTS["grid_heads"], {}, {}, F32_BAR),
    "no_softmax_k3": (VARIANTS["white_bg"], dict(head_topk=3), {}, F32_BAR),
}


def _calibrated(monkeypatch):
    """Record what the JAX package's calibrate_budgets returns."""
    seen = []
    real = jR.calibrate_budgets

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(jR, "calibrate_budgets", spy)
    return seen


def _messages(caught, module):
    return [str(w.message) for w in caught if w.filename == module.__file__]


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_production_render_frames_matches_jax(tmp_path, monkeypatch, case):
    """render_frames with the JAX defaults (grids with occupancy, L2-only
    selection, calibrated budgets with termination, top-k heads with tail
    completion): the same calibrated config and guardrail warnings as the
    JAX package, and maps within fp32 tolerance (3e-2 with bf16 heads).
    Frame sizes that are not multiples of the chunk exercise the padding."""
    variant, changes, kw, bar = RENDER_CASES[case]
    make = _checkpoint if case == "all_occupied" else _sparse_checkpoint
    ckpt = make(tmp_path / "field.npz", variant)
    (jp, jm, jr, js), (tp, tm, tr, ts) = _load(ckpt, variant)
    jr = dataclasses.replace(jr, **changes)
    tr = dataclasses.replace(tr, **changes)
    rays = [_both_rays(300, 1), _rays(200, 2)]
    seen = _calibrated(monkeypatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jrender.render_frames(
            jp, jm, jr, js,
            [JFrame(str(i), r, *([None] * 6)) for i, r in enumerate(rays)],
            chunk=128, **kw)
        got = trender.render_frames_report(
            tp, tm, tr, ts,
            [TFrame(str(i), r, *([None] * 6)) for i, r in enumerate(rays)],
            chunk=128, device="cpu", **kw)
    assert dataclasses.asdict(got.rcfg) == dataclasses.asdict(seen[0])
    assert got.rcfg.term_first > 0 and not got.rcfg.use_l1
    if "head_term_first" in changes:
        assert got.rcfg.head_term_first == changes["head_term_first"]
    assert _messages(caught, trender) == _messages(caught, jrender)
    for w, g in zip(want, got.maps):
        # the heads see above-threshold samples on some of the rays
        assert np.mean(np.abs(w["instances"]).sum(-1) > 0) > 0.1
        for key in MAP_KEYS:
            np.testing.assert_allclose(g[key], w[key], **bar,
                                       err_msg=f"{case}: {key}")


def test_production_chunk_is_what_render_rays_passes_the_kernel(tmp_path,
                                                                monkeypatch):
    """fidelity.production_chunk, which chip_smoke.py times the kernel on,
    gives exactly the coordinates, shift and atlas grid of pass A of the
    production render's first chunk (the launch after the calibration
    probe's)."""
    ts = tfid.e2e_scene((16, 24), 2, 18.0)
    ckpt = _sparse_checkpoint(tmp_path / "field.npz", {}, bbox=ts.scene_bounds)
    seen = []
    real = tR.sample_density_brick

    def spy(fused, xyz, shift):
        seen.append((fused.brick_atlas, xyz.clone(), shift))
        return real(fused, xyz, shift)

    monkeypatch.setattr(tR, "sample_density_brick", spy)
    n_rays = 256
    rep = tfid.run_production(ckpt, ts, device="cpu", chunk=n_rays)
    # the probe's launch, then pass A and pass B of every chunk
    n_chunks = sum(-(-len(f.rays) // n_rays) for f in ts.val_frames)
    assert len(seen) == 1 + 2 * n_chunks
    kA, sub = rep["rcfg"].term_first, rep["rcfg"].sub_stride
    assert 0 < kA < rep["rcfg"].max_subsegments
    dense, shift, xyz = tfid.production_chunk(ckpt, ts, device="cpu",
                                              n_rays=n_rays)
    atlas, xyz_kernel, shift_kernel = seen[1]
    assert xyz.shape == (n_rays * kA * sub, 3)
    assert torch.equal(xyz, xyz_kernel)
    assert shift == shift_kernel
    assert torch.equal(tfg.build_brick_atlas(dense), atlas)


def test_run_production_matches_jax_pipeline(tmp_path):
    """run_production (production render -> cluster -> PQ) against the JAX
    render_frames at the gate's production point plus the gate's
    cluster_maps / pq_for, on a tiny scene: maps within the bf16-head bar,
    PQ^scene and masked PQ within the gate's 0.5 pt."""
    js = gate.e2e_scene((16, 24), 2, 18.0)
    ts = tfid.e2e_scene((16, 24), 2, 18.0)
    ckpt = _sparse_checkpoint(tmp_path / "field.npz", {}, bbox=js.scene_bounds)
    cfg = gate.e2e_config((16, 24))
    jp, jm, jr, jst, _ = jrender.load_model_for_inference(
        ckpt, cfg, js.num_semantic_classes, step_ratio=0.25, head_topk=8)
    jr = dataclasses.replace(jr, head_topk_semins=8, head_dtype="bfloat16")
    frames = jrender.render_frames(jp, jm, jr, jst, js.val_frames, chunk=256)
    oh = gate.cluster_maps(frames, js, 0.15, cfg.max_instances)
    pq, _, _, pq_m = gate.pq_for(frames, oh, js, cfg.max_instances)
    got = tfid.run_production(ckpt, ts, device="cpu", chunk=256)
    assert got["rcfg"].head_dtype == "bfloat16"
    assert (got["rcfg"].head_topk, got["rcfg"].head_topk_semins) == (8, 8)
    for w, g in zip(frames, got["maps"]):
        for key in MAP_KEYS:
            np.testing.assert_allclose(g[key], w[key], **BF16_BAR)
    assert abs(got["pq_scene"] - pq) <= 0.005
    assert abs(got["pq_masked"] - pq_m) <= 0.005
