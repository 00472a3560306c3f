"""The port's modules against their JAX twins, one module at a time.

Same inputs (numpy, fixed seeds) through both packages; each comparison
states its tolerance. Everything runs on the CPU (``device="cpu"``).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastive_lift_tpu import factory as jfactory
from contrastive_lift_tpu.io import checkpoint as jckpt
from contrastive_lift_tpu.metrics.panoptic_quality import panoptic_quality as j_pq
from contrastive_lift_tpu.models import tensorf as jtf
from contrastive_lift_tpu.ops import compositing as jcomp
from contrastive_lift_tpu.ops import fused_grid as jfg
from contrastive_lift_tpu.ops.meanshift import MeanShiftTPU
from contrastive_lift_tpu.renderer import render as jR
from contrastive_lift_tpu_torch import factory as tfactory
from contrastive_lift_tpu_torch.config import Config as TConfig
from contrastive_lift_tpu_torch.io.checkpoint import load_checkpoint
from contrastive_lift_tpu_torch.io.convert import params_from_numpy
from contrastive_lift_tpu_torch.metrics.panoptic_quality import panoptic_quality as t_pq
from contrastive_lift_tpu_torch.models import tensorf as ttf
from contrastive_lift_tpu_torch.ops import compositing as tcomp
from contrastive_lift_tpu_torch.ops import fused_grid as tfg
from contrastive_lift_tpu_torch.ops.meanshift import MeanShift
from contrastive_lift_tpu_torch.renderer import render as tR
from contrastive_lift_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
R5B = ROOT / "artifacts" / "e2e_r5b_tpu" / "checkpoints" / "final.npz"


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _model(grid=14, **cfg_kw):
    from contrastive_lift_tpu.config import Config
    cfg = Config(max_instances=3, instance_loss_mode="slow_fast", seed=0,
                 **cfg_kw)
    bbox = np.array(((-1.2, -0.9, -1.0), (0.8, 1.1, 1.0)), np.float32)
    mcfg, params, rcfg, _ = jfactory.build_model(cfg, 4, bbox, (grid,) * 3,
                                                 step_ratio=0.25)
    return mcfg, jax.tree.map(np.asarray, params)


def test_checkpoint_load_is_identical_to_jax():
    """r5b loads to the same tree, leaf for leaf, bit for bit, with the same
    optimizer leaves; params_from_numpy keeps structure and values."""
    jp, jmeta = jckpt.load_checkpoint(R5B)
    tp, tmeta = load_checkpoint(R5B)
    j_opt, t_opt = jmeta.pop("opt_leaves"), tmeta.pop("opt_leaves")
    assert len(t_opt) == len(j_opt) == tmeta["n_opt_leaves"]
    for a, b in zip(t_opt, j_opt):
        np.testing.assert_array_equal(a, b)
    assert tmeta == jmeta
    assert tmeta["grid_dim"] == [131, 131, 121]
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    assert type(tp["density"]["planes"]) is tuple
    tt = dict(_leaves(params_from_numpy(tp, "cpu")))
    for key, want in jl.items():
        np.testing.assert_array_equal(tl[key], want)
        assert tt[key].dtype == torch.float32
        np.testing.assert_array_equal(tt[key].numpy(), want)


@pytest.mark.parametrize("cfg_kw", [
    dict(use_mlp_for_semantics=True, use_mlp_for_instances=True),
    dict(use_mlp_for_semantics=False, use_mlp_for_instances=False,
         semantic_weight_mode="argmax", precision="bf16", pe_sem=2)])
def test_configs_equal_field_by_field(cfg_kw):
    from contrastive_lift_tpu.config import Config
    jcfg = Config(max_instances=3, instance_loss_mode="slow_fast", **cfg_kw)
    tcfg = TConfig(max_instances=3, instance_loss_mode="slow_fast", **cfg_kw)
    assert dataclasses.asdict(jcfg.resolve_epochs()) == dataclasses.asdict(
        tcfg.resolve_epochs())
    bbox = np.array([[-0.55] * 3, [0.55, 0.55, 0.468]], np.float32)
    jm = jfactory.make_model_config(jcfg, 2)
    tm = tfactory.make_model_config(tcfg, 2)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    jr = jfactory.make_render_config(jcfg, bbox, (131, 131, 121), jm, 0.25)
    tr = tfactory.make_render_config(tcfg, bbox, (131, 131, 121), tm, 0.25)
    assert dataclasses.asdict(jr) == dataclasses.asdict(tr)


@pytest.mark.parametrize("grid_dim,step_ratio", [((131, 131, 121), 0.25),
                                                 ((14, 14, 14), 0.5)])
def test_sample_count_and_render_state(grid_dim, step_ratio):
    bbox = np.array([[-0.55] * 3, [0.55, 0.55, 0.468039]], np.float32)
    n = tR.compute_n_samples(bbox, grid_dim, step_ratio)
    assert n == jR.compute_n_samples(bbox, grid_dim, step_ratio)
    if grid_dim == (131, 131, 121):
        assert n == 879
    js = jR.make_render_state(bbox, grid_dim, step_ratio)
    ts = tR.make_render_state(bbox, grid_dim, step_ratio, device="cpu")
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_compositing_matches_jax():
    rng = np.random.default_rng(0)
    sigma = rng.gamma(0.5, 2.0, (64, 50)).astype(np.float32)
    dist = rng.uniform(0.01, 0.2, (64, 50)).astype(np.float32)
    z = np.cumsum(dist, axis=1).astype(np.float32)
    values = rng.uniform(size=(64, 50, 5)).astype(np.float32)
    for a, b in zip(jcomp.raw_to_alpha(jnp.asarray(sigma), jnp.asarray(dist)),
                    tcomp.raw_to_alpha(_t(sigma), _t(dist))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    w = np.asarray(jcomp.raw_to_alpha(jnp.asarray(sigma), jnp.asarray(dist))[1])
    np.testing.assert_allclose(
        float(tcomp.distortion_loss(_t(w), _t(z), _t(dist))),
        float(jcomp.distortion_loss(jnp.asarray(w), jnp.asarray(z),
                                    jnp.asarray(dist))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tcomp.composite(_t(w), _t(values)).numpy(),
        np.asarray(jcomp.composite(jnp.asarray(w), jnp.asarray(values))),
        atol=1e-6, rtol=0)


def test_dense_grids_match_jax():
    """Densified grids: fp32 einsums, so equal to summation-order rounding."""
    _, params = _model(use_mlp_for_semantics=False)
    tparams = params_from_numpy(params, "cpu")
    np.testing.assert_allclose(
        tfg.build_dense_density(tparams).numpy(),
        np.asarray(jfg.build_dense_density(params)), atol=1e-5, rtol=1e-5)
    for name in ("appearance", "semantic"):
        np.testing.assert_allclose(
            tfg.build_dense_feature(tparams, name).numpy(),
            np.asarray(jfg.build_dense_feature(params, name)),
            atol=1e-5, rtol=1e-5)


def test_feature_sampling_matches_jax():
    """8-read dense-grid features == the JAX corner-table sampler (the layout
    its dense render uses)."""
    _, params = _model()
    grid = jfg.build_dense_feature(params, "appearance")
    jfused = jfg.FusedGrids(None, (14, 14, 14), {}, {
        "appearance": jfg._cell_corner_feature(grid, (14, 14, 14))})
    tfused = tfg.FusedGrids((14, 14, 14), None, {"appearance": _t(grid)})
    xyz = np.random.default_rng(1).uniform(-1.02, 1.02, (1000, 3)).astype(np.float32)
    want = jfg.sample_feature_fused(jfused, "appearance", jnp.asarray(xyz),
                                    out_dim=27)
    got = tfg.sample_feature_fused(tfused, "appearance", _t(xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_heads_match_jax():
    mcfg, params = _model()
    tparams = params_from_numpy(params, "cpu")
    tm = ttf.TensoRFConfig(**dataclasses.asdict(mcfg))
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    view = rng.normal(size=(256, 3)).astype(np.float32)
    feats = rng.normal(size=(256, 27)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.positional_encoding(_t(feats), 2).numpy(),
        np.asarray(jtf.positional_encoding(jnp.asarray(feats), 2)),
        atol=1e-6, rtol=0)
    pairs = [
        (jtf.render_appearance(params, mcfg, jnp.asarray(view), None,
                               feats=jnp.asarray(feats)),
         ttf.render_appearance(tparams, tm, _t(view), None, feats=_t(feats))),
        (jtf.render_semantics(params, mcfg, jnp.asarray(xyz)),
         ttf.render_semantics(tparams, tm, _t(xyz))),
        (jtf.render_instances(params, mcfg, jnp.asarray(xyz)),
         ttf.render_instances(tparams, tm, _t(xyz)))]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.1, 0.1, 0.1], [0.8, 0.2, 0.5], [0.3, 0.9, 0.8],
                        [0.7, 0.7, 0.1]], np.float32)
    pts = np.concatenate([c + 0.03 * rng.standard_normal((300, 3))
                          for c in centers]).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def test_meanshift_matches_jax():
    pts = _blobs()
    want = MeanShiftTPU(bandwidth=0.15).fit(pts)
    got = MeanShift(bandwidth=0.15, device="cpu").fit(pts)
    assert len(got.cluster_centers_) == len(want.cluster_centers_) == 4
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_,
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    probe = np.random.default_rng(1).uniform(0, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(got.predict(probe), want.predict(probe))


def test_panoptic_quality_matches_jax():
    rng = np.random.default_rng(3)
    target = np.stack([rng.integers(0, 3, 4000), rng.integers(0, 4, 4000)], -1)
    preds = target.copy()
    flip = rng.uniform(size=4000) < 0.2
    preds[flip] = np.stack([rng.integers(0, 4, flip.sum()),
                            rng.integers(0, 5, flip.sum())], -1)
    for allow in (True, False):
        kw = dict(allow_unknown_preds_category=allow)
        if allow:
            assert t_pq(preds, target, {1, 2}, {0}, **kw) == j_pq(
                preds, target, {1, 2}, {0}, **kw)
        else:
            with pytest.raises(ValueError):
                t_pq(preds, target, {1, 2}, {0}, **kw)


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeanShift(bandwidth=0.1)
    assert resolve_device("cpu") == torch.device("cpu")
