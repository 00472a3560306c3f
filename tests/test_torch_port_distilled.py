"""The port's distilled-feature heads, conditional TensoRF and observability
against the JAX package, on the CPU.

The fields are ``test_torch_port_production.py``'s grid-14 sparse field
(empty but for an opaque slab) with the distilled head feeding the
semantic head, the instance heads or both, drawn by the port's init and
saved with the JAX package, its ``feature`` factors scaled so that the
distilled head varies over the field. The same numpy inputs go through both packages. Bars: fp32 maps,
the distilled map and gradients at 1e-5 (gradients 1e-4 relative), bf16
heads and baked tables at 3e-2, edits at 1e-4, calibrated budgets equal,
training losses at rtol 2e-3. The training cases use
``tests/test_variant_paths.py``'s distilled set-up (its scene, unit-norm
random feature targets, stop-gradient features) at grid 24, with JAX's
draws.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastive_lift_tpu.config import Config as JConfig
from contrastive_lift_tpu.data import base as jbase
from contrastive_lift_tpu.data.synthetic import make_synthetic_scene
from contrastive_lift_tpu.factory import class_weights_for as jclass_weights
from contrastive_lift_tpu.io.checkpoint import save_checkpoint
from contrastive_lift_tpu.models import conditional as jcond
from contrastive_lift_tpu.models import tensorf as jtf
from contrastive_lift_tpu.ops import fused_grid as jfg
from contrastive_lift_tpu.renderer import editing as jedit
from contrastive_lift_tpu.renderer import render as jR
from contrastive_lift_tpu.renderer.bake import bake_head_tables as j_bake
from contrastive_lift_tpu.train import state as jstate
from contrastive_lift_tpu.train import step as jstep
from contrastive_lift_tpu.utils import observability as jobs
from contrastive_lift_tpu_torch.config import Config as TConfig
from contrastive_lift_tpu_torch.data import base as tbase
from contrastive_lift_tpu_torch.factory import build_model as tbuild_model
from contrastive_lift_tpu_torch.factory import class_weights_for as tclass_weights
from contrastive_lift_tpu_torch.io.convert import params_from_numpy
from contrastive_lift_tpu_torch.models import conditional as tcond
from contrastive_lift_tpu_torch.models import tensorf as ttf
from contrastive_lift_tpu_torch.ops import fused_grid as tfg
from contrastive_lift_tpu_torch.renderer import bake as tbake
from contrastive_lift_tpu_torch.renderer import editing as tedit
from contrastive_lift_tpu_torch.renderer import render as tR
from contrastive_lift_tpu_torch.train import loop as tloop
from contrastive_lift_tpu_torch.train import state as tstate
from contrastive_lift_tpu_torch.train import step as tstep
from contrastive_lift_tpu_torch.utils import observability as tobs
from contrastive_lift_tpu_torch.utils.tree import (path_str,
                                                   tree_leaves_with_path,
                                                   tree_map)
from test_torch_port_production import BF16_BAR, _both_rays, _load
from test_torch_port_render import BBOX, MAP_KEYS, _cfg, _dense, _rays
from test_torch_port_train import _slab_params

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

HEADS = {"semantic": dict(use_distilled_features_semantic=True),
         "instance": dict(use_distilled_features_instance=True),
         "both": dict(use_distilled_features_semantic=True,
                      use_distilled_features_instance=True)}
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4
LOSS_RTOL = 2e-3
EDIT_ATOL = 1e-4
FEATURE_SCALE = 6.0
BOX = {"extent": [0.9, 0.7, 0.4], "position": [-0.15, 0.1, 0.05],
       "orientation": np.eye(3, dtype=np.float32)}
THETA = np.deg2rad(30.0)
ROTATION = np.array([[np.cos(THETA), -np.sin(THETA), 0.0],
                     [np.sin(THETA), np.cos(THETA), 0.0],
                     [0.0, 0.0, 1.0]], np.float32)
TRANSLATION = np.array([0.3, -0.1, 0.0], np.float32)


def _np(x):
    return np.asarray(x.detach().float().cpu() if isinstance(x, torch.Tensor)
                      else x)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    ref = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / ref) if ref else float(
        np.linalg.norm(got))


def _distilled_checkpoint(path, kw):
    """``_sparse_checkpoint``'s field with the distilled head on (``kw``),
    drawn by the port's init (JAX's eager init compiles op by op), its
    feature factors scaled by FEATURE_SCALE."""
    _, tp, _, _ = tbuild_model(_cfg(TConfig, **kw), 2, BBOX, (14, 14, 14),
                               step_ratio=0.25, device="cpu")
    params = tree_map(lambda t: t.numpy(), tp)
    planes = [p * 2 for p in params["density"]["planes"]]
    lines = list(params["density"]["lines"])
    y, x = np.meshgrid(np.arange(14), np.arange(14), indexing="ij")
    planes[0][0] = ((y - 6.5) ** 2 + (x - 6.0) ** 2 < 30).astype(np.float32)
    lines[0][0] = np.where((np.arange(14) >= 6) & (np.arange(14) <= 8),
                           30.0, 0.0)
    planes[0][1], lines[0][1] = 1.0, -8.0
    params["density"] = {"planes": tuple(planes), "lines": tuple(lines)}
    params["feature"] = {k: tuple(a * FEATURE_SCALE for a in v)
                         for k, v in params["feature"].items()}
    save_checkpoint(path, params, grid_dim=(14, 14, 14), bbox_aabb=BBOX,
                    epoch=0, global_step=0)
    return path


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    """Per head set: the checkpoint and both packages' models, with the
    L2-only grouped render config that render_frames derives."""
    out = {}
    tmp = tmp_path_factory.mktemp("distilled")
    for name, kw in HEADS.items():
        ckpt = _distilled_checkpoint(tmp / f"{name}.npz", kw)
        (jp, jm, jr, js), (tp, tm, tr, ts) = _load(ckpt, kw)
        assert tm.use_distilled and jm.use_distilled
        jr = jR.occ_grouping_for(dataclasses.replace(jr, use_l1=False), js)
        tr = tR.occ_grouping_for(dataclasses.replace(tr, use_l1=False), ts)
        out[name] = dict(ckpt=ckpt, j=(jp, jm, jr, js), t=(tp, tm, tr, ts))
    return out


# ---------------------------------------------------------------------------
# 1. the heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", list(HEADS))
def test_render_distilled_and_backbone_feats(fields, heads):
    """render_distilled from the factors and from given features, and the
    semantic MLP's backbone features (on the model whose semantic head takes
    no distilled input), at 1e-5; the head's input order puts the distilled
    features last."""
    jp, jm, _, _ = fields[heads]["j"]
    tp, tm, _, _ = fields[heads]["t"]
    xyz = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    want = jtf.render_distilled(jp, jm, jnp.asarray(xyz))
    got = ttf.render_distilled(tp, tm, torch.from_numpy(xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert got.shape == (300, 64) and float(got.std()) > 1e-2
    feats = np.random.default_rng(1).normal(size=(300, 96)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.render_distilled(tp, tm, None, feats=torch.from_numpy(feats)).numpy(),
        np.asarray(jtf.render_distilled(jp, jm, None, feats=jnp.asarray(feats))),
        **F32)
    d = got[:, :5]
    np.testing.assert_array_equal(
        ttf._head_input(tm, 2, torch.from_numpy(xyz), d)[:, -5:].numpy(),
        d.numpy())
    if not tm.use_distilled_features_semantic:
        np.testing.assert_allclose(
            ttf.semantic_backbone_feats(tp, tm, torch.from_numpy(xyz)).numpy(),
            np.asarray(jtf.semantic_backbone_feats(jp, jm, jnp.asarray(xyz))),
            **F32)


# ---------------------------------------------------------------------------
# 2. render_rays: dense fp32 with gradients, production, dedup
# ---------------------------------------------------------------------------

GRAD_PATHS = ("feature", "feature_basis", "feature_mlp", "semantic_mlp",
              "instance_mlp")


def _probes(out, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=tuple(out[k].shape)).astype(np.float32)
            for k in ("rgb", "semantics", "instances", "distilled")}


@pytest.mark.parametrize("stop_grad", [False, True])
@pytest.mark.parametrize("heads", list(HEADS))
def test_dense_render_and_gradients(fields, heads, stop_grad):
    """The dense fp32 render (every sample, VM factors sampled directly):
    maps and the unit-norm distilled map at 1e-5, and the gradients of a
    probe loss on all four maps with respect to the feature branch and the
    heads within 1e-4 relative of JAX's. With ``feature_stop_grad`` the
    feature branch's gradient is that of the distilled map alone; without
    it the heads' gradient reaches the feature branch too."""
    jp, jm, jr, js = fields[heads]["j"]
    tp, tm, tr, ts = fields[heads]["t"]
    jr = _dense(dataclasses.replace(jr, feature_stop_grad=stop_grad,
                                    use_l1=True))
    tr = _dense(dataclasses.replace(tr, feature_stop_grad=stop_grad,
                                    use_l1=True))
    rays = _both_rays(48, 1)
    got = tR.render_rays(tp, tm, tr, ts, torch.from_numpy(rays))
    probes = _probes(got, 2)

    def jloss(p, keys):
        out = jR.render_rays(p, jm, jr, js, jnp.asarray(rays), None, False)
        return sum(jnp.sum(out[k] * probes[k]) for k in keys), out

    def tloss(p, keys):
        out = tR.render_rays(p, tm, tr, ts, torch.from_numpy(rays))
        return sum(torch.sum(out[k] * torch.from_numpy(probes[k]))
                   for k in keys)

    keys = tuple(probes)
    gj, want = jax.grad(jloss, has_aux=True)(jp, keys)
    for key in MAP_KEYS + ("distilled", "opacity"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **F32, err_msg=key)
    norms = np.linalg.norm(got["distilled"].numpy(), axis=-1)
    hit = got["opacity"].numpy() > 1e-3
    assert 0 < hit.sum() < len(rays)
    np.testing.assert_allclose(norms[hit], 1.0, atol=1e-5)
    gj = dict(tree_leaves_with_path(gj))
    paths = [p for p, _ in tree_leaves_with_path(tp) if p[0] in GRAD_PATHS]
    p = tstep._with_grad(tp, paths)
    gt = tstep._grads(tloss(p, keys), p, paths)
    for path in paths:
        assert _rel(gt[path], gj[path]) <= GRAD_RTOL, (path_str(path),
                                                       _rel(gt[path], gj[path]))
    # the feature branch's gradient from the distilled map alone
    p = tstep._with_grad(tp, paths)
    alone = tstep._grads(tloss(p, ("distilled",)), p, paths)
    feat = [q for q in paths if q[0] == "feature"]
    apart = max(_rel(gt[q], alone[q]) for q in feat)
    # float32 round-off alone moves it by about 1e-7
    if stop_grad:
        assert apart <= 1e-6
    else:
        assert apart > 1e-5


_JAX_PRODUCTION = {}
_JAX_BUDGETS = {}


def _production(fields, heads, mode):
    """Both packages' compact bf16 grids and calibrated budgets (equal),
    and JAX's render of ``mode`` ("two_phase": top-8 bf16 heads in two
    phases, or "dedup": 6 unique cells of the 8), cached per case."""
    jp, jm, jr, js = fields[heads]["j"]
    tp, tm, tr, ts = fields[heads]["t"]
    jr = dataclasses.replace(jr, head_dtype="bfloat16")
    tr = dataclasses.replace(tr, head_dtype="bfloat16")
    jf = jfg.build_render_grids(jp, jm, jr, js, compact=True,
                                feature_dtype=jnp.bfloat16)
    tf = tfg.build_render_grids(tp, tm, tr, ts, compact=True,
                                feature_dtype="bfloat16")
    assert tf.features["feature"].shape == (14 ** 3, 96)
    assert tf.features["feature"].dtype == torch.bfloat16
    probe = _both_rays(256, 6)
    kw = dict(termination=True, head_term=True)
    if heads not in _JAX_BUDGETS:
        _JAX_BUDGETS[heads] = jR.calibrate_budgets(
            jm, jr, js, jnp.asarray(probe), jf, **kw)
    jc = _JAX_BUDGETS[heads]
    tc = tR.calibrate_budgets(tm, tr, ts, probe, tf, **kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    change = (dict(head_term_first=4, head_term_fraction=0.25)
              if mode == "two_phase" else dict(head_dedup_cells=6))
    change.update(head_topk=8, head_tail_complete=True)
    jc = dataclasses.replace(jc, **change)
    tc = dataclasses.replace(tc, **change)
    rays = _both_rays(256, 8)
    key = (heads, mode)
    if key not in _JAX_PRODUCTION:
        _JAX_PRODUCTION[key] = jR.render_rays(jp, jm, jc, js,
                                              jnp.asarray(rays), None, False,
                                              fused=jf)
    return (tp, tm, tc, ts, tf), rays, _JAX_PRODUCTION[key]


@pytest.mark.parametrize("stop_grad", [False, True])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("mode", ["two_phase", "dedup"])
def test_production_render_matches_jax(fields, mode, heads, stop_grad):
    """The production render with top-8 bf16 heads from the compact bf16
    grids (the distilled head reads the dense ``feature`` grid): in two
    phases, and with 6-cell dedup (one pass). Maps and the distilled map
    within 3e-2, the guardrails at fp32, unit rows where a ray hits."""
    (tp, tm, tc, ts, tf), rays, want = _production(fields, heads, mode)
    tc = dataclasses.replace(tc, feature_stop_grad=stop_grad)
    got = tR.render_rays(tp, tm, tc, ts, torch.from_numpy(rays), fused=tf)
    for key in MAP_KEYS + ("distilled",):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **BF16_BAR, err_msg=key)
    for key in ("budget_tail", "head_tail", "dedup_tail"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=2e-5, rtol=1e-4, err_msg=key)
    hit = got["opacity"].numpy() > 1e-3
    assert 0 < hit.sum() < len(rays)
    np.testing.assert_allclose(
        np.linalg.norm(got["distilled"].numpy(), axis=-1)[hit], 1.0,
        atol=1e-5)


def test_baked_heads_match_jax(fields):
    """bake_head_tables with the distilled head on both heads: the node
    values (the distilled head in bf16 at the node's grid features) within
    3e-2 of JAX's table and of the port's own heads at the nodes; the baked
    render's maps and distilled map within 3e-2 of JAX's baked render."""
    jp, jm, jr, js = fields["both"]["j"]
    tp, tm, tr, ts = fields["both"]["t"]
    jf = jfg.build_render_grids(jp, jm, jr, js, compact=True,
                                feature_dtype=jnp.float32)
    tf = tfg.build_render_grids(tp, tm, tr, ts, compact=True,
                                feature_dtype="float32")
    jb = j_bake(jp, jm, jf)
    tb = tbake.bake_head_tables(tp, tm, tf)
    F = tbake.baked_width(tm)
    occ = tf.slot_map.numpy().reshape(tf.coarse_dim) > 0
    bx, by, bz = np.argwhere(occ)[0]
    nodes_i = (np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                        -1).reshape(-1, 3) + np.array([bx, by, bz]) * 4 + 1)
    nodes = torch.from_numpy((nodes_i / 13 * 2.0 - 1.0).astype(np.float32))
    got = tfg.sample_feature_fused(tb, "baked", nodes)
    want = jfg.sample_feature_fused(jb, "baked", jnp.asarray(nodes.numpy()),
                                    out_dim=F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_BAR)
    flat = nodes_i[:, 0] * 14 * 14 + nodes_i[:, 1] * 14 + nodes_i[:, 2]
    dist = torch.tanh(ttf.mlp_apply(
        tp["feature_mlp"], tfg.build_dense_feature(tp, "feature")[flat],
        torch.bfloat16))
    C = tm.num_semantic_classes
    sem = ttf.mlp_apply(tp["semantic_mlp"],
                        ttf._head_input(tm, tm.pe_sem, nodes, dist),
                        torch.bfloat16)
    ins = ttf.render_instances(tp, tm, nodes, dist,
                               compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got[:, :C].numpy(), sem.numpy(), **BF16_BAR)
    np.testing.assert_allclose(got[:, C:].numpy(), ins.numpy(), **BF16_BAR)
    rays = _both_rays(256, 8)
    kw = dict(max_subsegments=8, term_first=0, head_topk=8, head_term_first=4,
              head_tail_complete=True)
    want = jR.render_rays(jp, jm, dataclasses.replace(jr, **kw), js,
                          jnp.asarray(rays), None, False, fused=jb)
    out = tR.render_rays(tp, tm, dataclasses.replace(tr, **kw), ts,
                         torch.from_numpy(rays), fused=tb)
    for key in MAP_KEYS + ("distilled",):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   **BF16_BAR, err_msg=key)


@pytest.mark.parametrize("kind", ["delete", "extract", "duplicate",
                                  "manipulate"])
def test_render_edited_matches_jax(fields, kind):
    """render_edited with the distilled head feeding both heads: maps within
    1e-4 of JAX's (semantics on rays whose edited opacity reaches 1e-4)."""
    jp, jm, jr, js = fields["both"]["j"]
    tp, tm, tr, ts = fields["both"]["t"]
    rays = _rays(96, 7)
    move = (dict(translation=TRANSLATION, rotation=ROTATION)
            if kind in ("duplicate", "manipulate") else {})
    want = jedit.render_edited(jp, jm, jr, js, jnp.asarray(rays), kind, BOX,
                               **move)
    got = tedit.render_edited(tp, tm, tr, ts, rays, kind, BOX, device="cpu",
                              **move)
    weight = tedit.edited_weights(tp, tm, tr, ts, torch.from_numpy(rays),
                                  kind, BOX, **move)[2]
    lit = (weight.sum(-1) >= 1e-4).numpy()
    assert 0 < lit.sum()
    for key in MAP_KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        if key == "semantics":
            g, w = g[lit], w[lit]
        np.testing.assert_allclose(g, w, atol=EDIT_ATOL, rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# 3. training: the step, its gate, the Trainer
# ---------------------------------------------------------------------------

STEP_KW = dict(batch_size=128, chunk=128, min_grid_dim=24, max_grid_dim=24,
               max_instances=3, max_rays_instances=64,
               max_labels_per_image=8, batch_size_segments=2,
               max_rays_segments=32, seed=0, late_semantic_optimization=0,
               instance_optimization_epoch=0, segment_optimization_epoch=0,
               instance_loss_mode="slow_fast", use_DINO_style=True,
               use_distilled_features_semantic=True,
               use_distilled_features_instance=True, feature_stop_grad=True)
STEP_METRICS = ("loss_main", "loss_rgb", "loss_feat", "loss_semantics",
                "loss_dist_reg", "loss_segment", "loss_clustering")


def _with_targets(scene):
    """``tests/test_variant_paths.py``'s unit-norm 64-d targets."""
    rng = np.random.default_rng(0)
    for f in scene.train_frames + scene.val_frames:
        feats = rng.normal(size=(f.rays.shape[0], 64)).astype(np.float32)
        f.feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    return scene


@pytest.fixture(scope="module")
def world():
    """test_variant_paths.py's scene with targets, both models at grid 24
    from the JAX parameters of test_torch_port_train.py's slab field (so
    that samples clear the head threshold and the distilled map has a
    gradient), its feature factors scaled by FEATURE_SCALE, the class
    weights and one step's batches."""
    scene = _with_targets(make_synthetic_scene(
        num_spheres=3, num_train=4, num_val=1, image_dim=(20, 24), seed=11))
    jcfg = JConfig(**STEP_KW).resolve_epochs()
    tcfg = TConfig(**STEP_KW).resolve_epochs()
    jm, params, jr, js = _slab_params(jcfg, scene)
    params["feature"] = {k: tuple(a * FEATURE_SCALE for a in v)
                         for k, v in params["feature"].items()}
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    tm, _, tr, ts = tbuild_model(tcfg, scene.num_semantic_classes,
                                 scene.scene_bounds, (24,) * 3, device="cpu")
    frames = scene.train_frames
    jmain = jbase.RayPoolSampler(frames, scene.num_semantic_classes,
                                 load_feats=True)
    tmain = tbase.RayPoolSampler(frames, scene.num_semantic_classes,
                                 load_feats=True)
    rng = np.random.default_rng(1)
    batches = (tmain.sample(rng, jcfg.batch_size),
               tbase.InstanceBundleSampler(frames, jcfg.max_rays_instances,
                                           jcfg.max_labels_per_image).sample(
                   rng, jcfg.batch_size_contrastive),
               tbase.SegmentBundleSampler(frames, jcfg.max_rays_segments)
               .sample(rng, jcfg.batch_size_segments))
    want = jmain.sample(np.random.default_rng(1), jcfg.batch_size)
    for key, value in want.items():
        np.testing.assert_array_equal(batches[0][key], value, err_msg=key)
    assert batches[0]["feats"].shape == (jcfg.batch_size, 64)
    return dict(scene=scene, jcfg=jcfg, tcfg=tcfg, jm=jm, jp=jp, jr=jr,
                js=js, tm=tm, tp=tp, tr=tr, ts=ts, batches=batches,
                jw=jclass_weights(jcfg, scene.segmentation),
                tw=tclass_weights(tcfg, scene.segmentation, device="cpu"))


def _jax_draws(key, n_main, n_chunk, inst_shape):
    """The uniform draws make_train_step makes from ``key``, as the port's
    StepDraws (test_torch_port_train.py)."""
    rng_main, rng_seg, rng_inst = jax.random.split(key, 3)
    rng_pts, rng_bg = jax.random.split(rng_main)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    inst = np.stack([np.asarray(jax.random.uniform(k, (inst_shape[1],)))
                     for k in jax.random.split(rng_inst, inst_shape[0])])
    return tstep.StepDraws(
        tR.RayDraws(t(jax.random.uniform(rng_pts, (n_main, 1))[:, 0]),
                    t(jax.random.uniform(rng_bg, ()))),
        t(jax.random.uniform(rng_seg, (n_chunk,))), t(inst))


def test_train_step_matches_jax(world):
    """One whole make_train_step step with every phase and the feature gate
    open, JAX's draws injected: every metric within rtol 2e-3 (loss_feat
    non-zero), and the main chain's gradients of the feature branch within
    1e-4 relative of the JAX step's (its main and segment losses' gradient,
    recomputed with the JAX package's phase losses)."""
    w = world
    gates = jstep.TrainGates(True, True, True, True)
    tgates = tstep.TrainGates(True, True, True, True)
    bm, bi, bs = w["batches"]
    key = jax.random.PRNGKey(5)
    draws = _jax_draws(key, len(bm["rays"]),
                       min(w["jcfg"].chunk_segment, len(bs["rays"])),
                       bi["rays"].shape[:2])
    jfn = jstep.make_train_step(w["jcfg"], w["jm"], w["jr"], gates, w["jw"],
                                w["jp"], donate=False)
    tfn = tstep.make_train_step(w["tcfg"], w["tm"], w["tr"], tgates, w["tw"],
                                w["tp"], keep_grads=True)
    jst = jstate.init_train_state(w["jcfg"], w["jp"])
    tst = tstate.init_train_state(w["tcfg"], w["tp"])
    _, jm = jfn(jst, w["js"], bm, bi, bs, key, 1.0, 0.001)
    _, tm = tfn(tst, w["ts"], bm, bi, bs, draws, 1.0, 0.001)
    assert set(tm) == set(jm)
    assert float(jm["loss_feat"]) > 0.05
    for name in STEP_METRICS:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=name)
    rng_main, rng_seg, _ = jax.random.split(key, 3)
    jcfg = w["jcfg"]

    def loss_fn(p):
        loss, _ = jstep.main_phase_loss(p, jcfg, w["jm"], w["jr"], w["js"],
                                        gates, bm, rng_main, 0.001, w["jw"])
        seg, _, _ = jstep.segment_phase_loss(p, jcfg, w["jm"], w["jr"],
                                             w["js"], bs, rng_seg, w["jw"])
        return loss + jcfg.lambda_semantics * jcfg.lambda_segment * seg

    gj = dict(tree_leaves_with_path(jax.jit(jax.grad(loss_fn))(w["jp"])))
    feature = [p for p in gj if p[0].startswith("feature")]
    assert len(feature) == 13
    for path in feature:
        got = tfn.grads["main"][path]
        assert float(torch.linalg.norm(got)) > 0, path_str(path)
        assert _rel(got, gj[path]) <= GRAD_RTOL, (path_str(path),
                                                  _rel(got, gj[path]))


def test_feature_gate_closed(world):
    """With features_on False (past feature_optimization_end_epoch) the main
    phase reports loss_feat 0 and the loss equals JAX's; with stop-gradient
    features nothing then reaches the feature branch: its TV is off too."""
    w = world
    tcfg = dataclasses.replace(w["tcfg"], feature_optimization_end_epoch=2)
    jcfg = dataclasses.replace(w["jcfg"], feature_optimization_end_epoch=2)
    tgates = tstep.gates_for_epoch(tcfg, 3)
    gates = jstep.gates_for_epoch(jcfg, 3)
    assert not tgates.features_on and not gates.features_on
    bm = w["batches"][0]
    key = jax.random.PRNGKey(6)
    draws = _jax_draws(key, len(bm["rays"]), 1, (1, 1))
    rng_main = jax.random.split(key, 3)[0]
    lj, mj = jax.jit(lambda p: jstep.main_phase_loss(
        p, jcfg, w["jm"], w["jr"], w["js"], gates, bm, rng_main, 0.001,
        w["jw"]))(w["jp"])
    main_tx, _, _ = tstate.make_optimizers(tcfg, w["tp"])
    paths = main_tx.trained_paths()
    p = tstep._with_grad(w["tp"], paths)
    lt, mt = tstep.main_phase_loss(
        p, tcfg, w["tm"], w["tr"], w["ts"], tgates,
        {k: torch.from_numpy(np.asarray(v)) for k, v in bm.items()},
        draws.main, 0.001, w["tw"])
    assert float(mt["loss_feat"]) == float(mj["loss_feat"]) == 0.0
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    grads = tstep._grads(lt, p, paths)
    for path in paths:
        if path[0] == "feature":
            assert not grads[path].any(), path_str(path)
    assert any(grads[q].any() for q in paths if q[0] == "density")


def test_sharded_main_phase_shares(world):
    """The main phase on two halves of the batch with the global counts (a
    rank of a sharded step; parallel/mesh.py shards ``feats`` with the other
    batch keys): the halves' loss_feat add up to the whole batch's, and
    their losses plus the TV term, which a sharded step adds once, to its
    loss."""
    from contrastive_lift_tpu_torch.parallel.mesh import Mesh, shard_main_batch
    w = world
    tgates = tstep.TrainGates(True, True, True, True)
    bm = {k: torch.from_numpy(np.asarray(v)) for k, v in
          w["batches"][0].items()}
    n = len(bm["rays"])
    gen = torch.Generator().manual_seed(4)
    draws = tR.RayDraws(torch.rand(n, generator=gen),
                        torch.rand((), generator=gen))

    def loss(batch, rd, counts=None):
        with torch.no_grad():
            return tstep.main_phase_loss(w["tp"], w["tcfg"], w["tm"], w["tr"],
                                         w["ts"], tgates, batch, rd, 0.001,
                                         w["tw"], counts=counts)

    whole, mw = loss(bm, draws)
    counts = {"rays": n, "mask": torch.sum(bm["mask"])}
    total, feat, tv = 0.0, 0.0, None
    for rank in range(2):
        mesh = Mesh(rank, 2, torch.device("cpu"), "gloo", None, None)
        half = shard_main_batch(mesh, bm)
        assert half["feats"].shape == (n // 2, 64)
        rows = slice(rank * n // 2, (rank + 1) * n // 2)
        lt, mt = loss(half, tR.RayDraws(draws.jitter[rows], draws.coin),
                      counts)
        total, feat, tv = total + float(lt), feat + float(mt["loss_feat"]), \
            float(mt["tv"])
    assert float(mw["loss_feat"]) > 0
    np.testing.assert_allclose(feat, float(mw["loss_feat"]), rtol=1e-5)
    np.testing.assert_allclose(total + tv, float(whole), rtol=1e-5)


def test_trainer_fits_with_feature_targets(world, tmp_path):
    """Two epochs of the port's Trainer on the scene with targets: its main
    sampler yields ``feats`` (load_feats follows the model), every logged
    metric is finite and loss_feat is reported non-zero while the gate is
    open."""
    import json
    cfg = TConfig(**dict(STEP_KW, max_epoch=2, min_grid_dim=16,
                         max_grid_dim=16, batch_size=64, chunk=256,
                         max_rays_instances=32, max_rays_segments=16,
                         subsample_frames=2, sanity_steps=1,
                         bbox_aabb_reset_epochs=[], grid_upscale_epochs=[],
                         logger="none")).resolve_epochs()
    tr = tloop.Trainer(cfg, world["scene"], tmp_path / "run", log_every=1,
                       device="cpu")
    assert "feats" in tr.main_sampler.sample(np.random.default_rng(0), 8)
    tr.fit()
    recs = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    feats = [r["loss_feat"] for r in recs if "loss_feat" in r]
    assert feats and all(np.isfinite(v) and v > 0 for v in feats)
    for r in recs:
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)), r


# ---------------------------------------------------------------------------
# 4. conditional TensoRF and observability
# ---------------------------------------------------------------------------

def test_conditional_matches_jax():
    """The port's conditional parameters (init_conditional) have the tree
    and shapes of JAX's (``jax.eval_shape``: JAX's eager init compiles op by
    op) and go through both packages: density and appearance at 1e-5; the
    latent conditioning is live."""
    base_j = jtf.TensoRFConfig(num_semantic_classes=3, dim_feature_instance=6,
                               slow_fast_mode=True)
    base_t = ttf.TensoRFConfig(num_semantic_classes=3, dim_feature_instance=6,
                               slow_fast_mode=True)
    jc = jcond.ConditionalConfig(base=base_j, latent_dim=8)
    tc = tcond.ConditionalConfig(base=base_t, latent_dim=8)
    tp = tcond.init_conditional(torch.Generator().manual_seed(0), tc,
                                (10, 10, 10), device="cpu")
    shapes = jax.eval_shape(
        lambda k: jcond.init_conditional(k, jc, (10, 10, 10)),
        jax.random.PRNGKey(0))
    jl, tl = tree_leaves_with_path(shapes), tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
    assert "b" not in tp["density_mlp"]["layers"][-1]
    assert not tp["appearance_mlp"]["layers"][-1]["b"].any()
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tp))
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    lat = rng.normal(size=(64, 8)).astype(np.float32)
    dirs = lat[:, :3] / np.linalg.norm(lat[:, :3], axis=-1, keepdims=True)
    want = jcond.compute_density_conditional(jp, jc, jnp.asarray(xyz),
                                             jnp.asarray(lat))
    got = tcond.compute_density_conditional(tp, tc, torch.from_numpy(xyz),
                                            torch.from_numpy(lat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    moved = tcond.compute_density_conditional(tp, tc, torch.from_numpy(xyz),
                                              torch.from_numpy(lat + 1.0))
    assert not np.allclose(moved.numpy(), got.numpy())
    np.testing.assert_allclose(
        tcond.render_appearance_conditional(
            tp, tc, torch.from_numpy(dirs), torch.from_numpy(xyz),
            torch.from_numpy(lat)).numpy(),
        np.asarray(jcond.render_appearance_conditional(
            jp, jc, jnp.asarray(dirs), jnp.asarray(xyz), jnp.asarray(lat))),
        **F32)


def test_conditional_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = tcond.ConditionalConfig(base=ttf.TensoRFConfig(3, 6))
    with pytest.raises(RuntimeError, match="cuda"):
        tcond.init_conditional(torch.Generator(), tc, (6, 6, 6))


def test_scrub_nan_grads_and_finite_check(capsys):
    """scrub_nan_grads and finite_check as the JAX package's, on the same
    trees; finite_check names the first non-finite leaf."""
    tree = {"a": np.array([1.0, np.nan, np.inf], np.float32),
            "b": {"c": np.array([-np.inf, 2.0], np.float32)}}
    want = jobs.scrub_nan_grads(jax.tree.map(jnp.asarray, tree))
    got = tobs.scrub_nan_grads(params_from_numpy(tree, "cpu"))
    for (path, g), (_, w) in zip(tree_leaves_with_path(got),
                                 tree_leaves_with_path(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), path)
    assert tobs.finite_check(got, "grads") and jobs.finite_check(want)
    assert not tobs.finite_check(params_from_numpy(tree, "cpu"), "grads")
    assert "grads/a" in capsys.readouterr().err
    assert not tobs.finite_check({"ok": np.zeros(2), "x": [np.array([np.nan])]})
    assert "tree/x/0" in capsys.readouterr().err


def test_profile_trace(tmp_path):
    """profile_trace writes one Chrome trace under its log directory, with
    the program's spans in it, and the block's counters beside it; nothing
    when disabled."""
    with tobs.profile_trace(tmp_path / "off", enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with tobs.profile_trace(tmp_path / "on"):
        with tobs.span("render.chunk"):
            with tobs.span("render.heads"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            tobs.count("heads.live", torch.ones(3, dtype=torch.bool))
            tobs.count("heads.slots", 4)
    traces = list((tmp_path / "on").glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"render.chunk", "render.heads"} <= names
    counters = list((tmp_path / "on").glob("counters_*.json"))
    assert len(counters) == 1
    assert json.loads(counters[0].read_text()) == {"heads.live": 3,
                                                   "heads.slots": 4}
    assert tobs.take_spans() == [] and tobs.take_counters() == {}
