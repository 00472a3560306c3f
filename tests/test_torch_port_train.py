"""The port's training step against the JAX package, on the CPU at grid 24.

Both packages start from the same parameters: a JAX ``init_tensorf`` field
whose density is empty but for an opaque slab (so that rays cross empty and
opaque space, the occupancy skips, and a few samples per ray clear the head
threshold), on the synthetic sphere scene of ``tests/test_train_step.py``.
Random draws are JAX's, made from the keys ``make_train_step`` splits, and
passed to the port. Bars: losses within rtol 2e-3 and a gradient cosine
above 0.999 per leaf (``tests/test_training_parity.py``); selections,
calibrated budgets and sampler batches equal; bf16 heads within 3e-2.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastive_lift_tpu.config import Config as JConfig
from contrastive_lift_tpu.data import base as jbase
from contrastive_lift_tpu.data.synthetic import make_synthetic_scene
from contrastive_lift_tpu.factory import build_model as jbuild_model
from contrastive_lift_tpu.factory import class_weights_for as jclass_weights
from contrastive_lift_tpu.io import checkpoint as jckpt
from contrastive_lift_tpu.losses import losses as jL
from contrastive_lift_tpu.models import tensorf as jtf
from contrastive_lift_tpu.ops import fused_grid as jfg
from contrastive_lift_tpu.ops import grid_sample as jgs
from contrastive_lift_tpu.renderer import render as jR
from contrastive_lift_tpu.train import loop as jloop
from contrastive_lift_tpu.train import schedule as jschedule
from contrastive_lift_tpu.train import state as jstate
from contrastive_lift_tpu.train import step as jstep
from contrastive_lift_tpu_torch.config import Config as TConfig
from contrastive_lift_tpu_torch.data import base as tbase
from contrastive_lift_tpu_torch.factory import build_model as tbuild_model
from contrastive_lift_tpu_torch.factory import class_weights_for as tclass_weights
from contrastive_lift_tpu_torch.inference import render as trender
from contrastive_lift_tpu_torch.io import checkpoint as tckpt
from contrastive_lift_tpu_torch.io.convert import params_from_numpy
from contrastive_lift_tpu_torch.losses import losses as tL
from contrastive_lift_tpu_torch.models import tensorf as ttf
from contrastive_lift_tpu_torch.ops import fused_grid as tfg
from contrastive_lift_tpu_torch.ops import grid_sample as tgs
from contrastive_lift_tpu_torch.renderer import render as tR
from contrastive_lift_tpu_torch.train import loop as tloop
from contrastive_lift_tpu_torch.train import schedule as tschedule
from contrastive_lift_tpu_torch.train import state as tstate
from contrastive_lift_tpu_torch.train import step as tstep
from contrastive_lift_tpu_torch.utils.tree import tree_leaves_with_path

torch.set_num_threads(2)
GRID = (24, 24, 24)
EPOCH = 8  # every gate open
LOSS_RTOL = 2e-3
MIN_COS = 0.999
BF16_ATOL = 3e-2
CFG_KW = dict(batch_size=256, chunk=256, min_grid_dim=24, max_grid_dim=32,
              max_instances=3, instance_loss_mode="slow_fast",
              use_DINO_style=True, max_rays_instances=128,
              max_labels_per_image=16, batch_size_segments=4,
              max_rays_segments=64, chunk_segment=128, lambda_dist_reg=0.001,
              seed=0, lr=2e-3, weight_class_0=1.0,
              late_semantic_optimization=0,
              instance_optimization_epoch=3, segment_optimization_epoch=6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cos(a, b):
    a, b = _np(a).ravel().astype(np.float64), _np(b).ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float(a @ b / (na * nb))


def _cfgs(**kw):
    full = dict(CFG_KW, **kw)
    return JConfig(**full).resolve_epochs(), TConfig(**full).resolve_epochs()


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(num_spheres=4, num_train=6, num_val=2,
                                image_dim=(24, 32), seed=0)


def _slab_params(cfg, scene):
    """JAX params (numpy leaves) of a grid-24 field that is empty but for an
    opaque slab 3 voxels deep across a disk of radius 4 voxels."""
    mcfg, params, rcfg, state_r = jbuild_model(
        cfg, scene.num_semantic_classes, scene.scene_bounds, GRID)
    params = jax.tree.map(np.array, params)
    planes = [p * 2 for p in params["density"]["planes"]]
    lines = list(params["density"]["lines"])
    y, x = np.meshgrid(np.arange(24), np.arange(24), indexing="ij")
    planes[0][0] = ((y - 11.5) ** 2 + (x - 11.0) ** 2 < 16).astype(np.float32)
    lines[0][0] = np.where((np.arange(24) >= 11) & (np.arange(24) <= 13),
                           30.0, 0.0)
    planes[0][1], lines[0][1] = 1.0, -8.0
    params["density"] = {"planes": tuple(planes), "lines": tuple(lines)}
    return mcfg, params, rcfg, state_r


@pytest.fixture(scope="module")
def world(scene):
    """JAX and port models of the slab field, the class weights, the three
    samplers of each package and their first batches (seed 1)."""
    jcfg, tcfg = _cfgs()
    jm, jp, jr, js = _slab_params(jcfg, scene)
    tm, _, tr, ts = tbuild_model(tcfg, scene.num_semantic_classes,
                                 scene.scene_bounds, GRID, device="cpu")
    frames = scene.train_frames
    samplers = [
        (jbase.RayPoolSampler(frames, scene.num_semantic_classes),
         tbase.RayPoolSampler(frames, scene.num_semantic_classes)),
        (jbase.InstanceBundleSampler(frames, jcfg.max_rays_instances,
                                     jcfg.max_labels_per_image),
         tbase.InstanceBundleSampler(frames, tcfg.max_rays_instances,
                                     tcfg.max_labels_per_image)),
        (jbase.SegmentBundleSampler(frames, jcfg.max_rays_segments),
         tbase.SegmentBundleSampler(frames, tcfg.max_rays_segments))]
    rng = np.random.default_rng(1)
    batches = (samplers[0][1].sample(rng, jcfg.batch_size),
               samplers[1][1].sample(rng, 1),
               samplers[2][1].sample(rng, jcfg.batch_size_segments))
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jr=jr, tr=tr, js=js, ts=ts,
        jp=jax.tree.map(jnp.asarray, jp), tp=params_from_numpy(jp, "cpu"),
        jw=jclass_weights(jcfg, scene.segmentation),
        tw=tclass_weights(tcfg, scene.segmentation, device="cpu"),
        samplers=samplers, batches=batches)


def _jax_draws(key, n_main, n_chunk, inst_shape):
    """The uniform draws make_train_step makes from ``key``, and the same
    draws as the port's StepDraws."""
    rng_main, rng_seg, rng_inst = jax.random.split(key, 3)
    rng_pts, rng_bg = jax.random.split(rng_main)
    main = np.asarray(jax.random.uniform(rng_pts, (n_main, 1)))[:, 0]
    coin = np.asarray(jax.random.uniform(rng_bg, ()))
    seg = np.asarray(jax.random.uniform(rng_seg, (n_chunk,)))
    keys = jax.random.split(rng_inst, inst_shape[0])
    inst = np.stack([np.asarray(jax.random.uniform(k, (inst_shape[1],)))
                     for k in keys])
    return tstep.StepDraws(tR.RayDraws(_t(main), _t(coin)), _t(seg), _t(inst))


def _batch_t(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# 1. grid sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["plane_sample", "line_sample", "vm_density",
                                "vm_feature"])
def test_grid_sample_values_and_gradients(fn):
    rng = np.random.default_rng(0)
    planes = [rng.normal(size=(4, 9, 7)).astype(np.float32),
              rng.normal(size=(4, 8, 7)).astype(np.float32),
              rng.normal(size=(4, 8, 9)).astype(np.float32)]
    lines = [rng.normal(size=(4, 8)).astype(np.float32),
             rng.normal(size=(4, 9)).astype(np.float32),
             rng.normal(size=(4, 7)).astype(np.float32)]
    xyz = rng.uniform(-1.15, 1.15, (500, 3)).astype(np.float32)
    if fn == "plane_sample":
        args = ([planes[0]], [xyz[:, :2]])
        jf, tfn = (lambda a, x: jgs.plane_sample(a[0], x[0]),
                   lambda a, x: tgs.plane_sample(a[0], x[0]))
    elif fn == "line_sample":
        args = ([lines[0]], [xyz[:, 2]])
        jf, tfn = (lambda a, x: jgs.line_sample(a[0], x[0]),
                   lambda a, x: tgs.line_sample(a[0], x[0]))
    else:
        args = (planes + lines, [xyz])
        jfun, tfun = getattr(jgs, fn), getattr(tgs, fn)
        jf = lambda a, x: jfun(a[:3], a[3:], x[0])  # noqa: E731
        tfn = lambda a, x: tfun(a[:3], a[3:], x[0])  # noqa: E731
    out_j = jf([jnp.asarray(a) for a in args[0]],
               [jnp.asarray(x) for x in args[1]])
    probe = rng.normal(size=out_j.shape).astype(np.float32)
    grads_j = jax.grad(lambda a, x: jnp.sum(jf(a, x) * probe), argnums=(0, 1))(
        [jnp.asarray(a) for a in args[0]], [jnp.asarray(x) for x in args[1]])
    ta = [_t(a).requires_grad_() for a in args[0]]
    tx = [_t(x).requires_grad_() for x in args[1]]
    out_t = tfn(ta, tx)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), atol=2e-5,
                               rtol=1e-5)
    torch.sum(out_t * _t(probe)).backward()
    for g_j, t in zip(list(grads_j[0]) + list(grads_j[1]), ta + tx):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g_j), atol=2e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# 2. field, initialization, density-only grids
# ---------------------------------------------------------------------------

def test_compute_density_and_branch_feature(world):
    xyz = np.random.default_rng(2).uniform(-1, 1, (400, 3)).astype(np.float32)
    probe = np.random.default_rng(3).normal(size=(400, 27)).astype(np.float32)

    def jloss(p):
        return (jnp.sum(jtf.compute_density(p, world.jm, jnp.asarray(xyz)))
                + jnp.sum(jtf._branch_feature(p, "appearance",
                                              jnp.asarray(xyz)) * probe))

    tp = {k: world.tp[k] for k in ("density", "appearance", "appearance_basis")}
    leaves = [t.requires_grad_() for _, t in tree_leaves_with_path(tp)]
    np.testing.assert_allclose(
        _np(ttf.compute_density(tp, world.tm, _t(xyz))),
        np.asarray(jtf.compute_density(world.jp, world.jm, jnp.asarray(xyz))),
        rtol=1e-5, atol=1e-5)
    loss_t = (torch.sum(ttf.compute_density(tp, world.tm, _t(xyz)))
              + torch.sum(ttf._branch_feature(tp, "appearance", _t(xyz))
                          * _t(probe)))
    np.testing.assert_allclose(float(loss_t.detach()), float(jloss(world.jp)),
                               rtol=1e-5)
    loss_t.backward()
    grads_j = dict(tree_leaves_with_path(jax.grad(jloss)(world.jp)))
    for (path, _), leaf in zip(tree_leaves_with_path(tp), leaves):
        assert _cos(leaf.grad, grads_j[path]) > 0.99999, path
    for t in leaves:
        t.requires_grad_(False)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_mlp_for_semantics=False, use_mlp_for_instances=False,
         use_proj=True)])
def test_init_statistics(kw, scene):
    """Shapes and dtypes equal; zero leaves exactly zero; per-leaf mean and
    std within sampling error of JAX's on leaves of 1,000 values or more,
    the same range on smaller ones."""
    jcfg, tcfg = _cfgs(**kw)
    _, jp, _, _ = jbuild_model(jcfg, 3, scene.scene_bounds, (20, 18, 16))
    _, tp, _, _ = tbuild_model(tcfg, 3, scene.scene_bounds, (20, 18, 16),
                               device="cpu")
    jl, tl = tree_leaves_with_path(jp), tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        a, b = np.asarray(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if not a.any():
            assert not b.any(), path
            continue
        n = a.size
        if n < 1000:
            assert np.abs(b).max() <= 3 * np.abs(a).max(), path
            continue
        assert abs(b.std() / a.std() - 1) < 0.1, path
        assert abs(b.mean() - a.mean()) < 6 * a.std() / np.sqrt(n) + 1e-6, path


@pytest.mark.parametrize("occupancy", [False, True])
def test_build_density_only_and_sampling(world, occupancy):
    """The cell-corner rows, the coarse occupancy and the fused density
    sample equal JAX's; the sample's gradient reaches the factors."""
    jf = jfg.build_density_only(world.jp, with_occupancy=occupancy)
    tf_ = tfg.build_density_only(world.tp, with_occupancy=occupancy)
    np.testing.assert_allclose(_np(tf_.density_cells),
                               np.asarray(jf.density_cells), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(tfg._cell_corner_grid(
        _t(np.asarray(jfg.build_dense_density(world.jp))))),
        np.asarray(jf.density_cells))
    if occupancy:
        assert tf_.coarse_dim == tuple(jf.coarse_dim)
        np.testing.assert_allclose(_np(tf_.coarse_occ),
                                   np.asarray(jf.coarse_occ)[:, 0], atol=2e-5)
    xyz = np.random.default_rng(4).uniform(-1.05, 1.05, (700, 3)).astype(
        np.float32)

    def jloss(p):
        f = jfg.build_density_only(p)
        return jnp.sum(jnp.sin(jfg.sample_density_fused(f, jnp.asarray(xyz),
                                                        -10.0)))

    dens = {"density": {k: tuple(t.clone().requires_grad_() for t in v)
                        for k, v in world.tp["density"].items()}}
    loss = torch.sum(torch.sin(tfg.sample_density_fused(
        tfg.build_density_only(dens), _t(xyz), -10.0)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss(world.jp)),
                               rtol=1e-4)
    loss.backward()
    gj = jax.grad(jloss)(world.jp)["density"]
    for k in ("planes", "lines"):
        for a, b in zip(gj[k], dens["density"][k]):
            assert _cos(b.grad, a) > 0.99999


# ---------------------------------------------------------------------------
# 3. losses
# ---------------------------------------------------------------------------

def _loss_cases():
    rng = np.random.default_rng(5)
    n, c = 96, 4
    logits = rng.normal(size=(n, c)).astype(np.float32)
    probs = rng.dirichlet(np.ones(c), n).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    confs = rng.uniform(0.2, 1, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.15
    groups = rng.integers(0, 6, n).astype(np.int32)
    weights = np.array([0.5, 1, 2, 1], np.float32)
    feats = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    slow = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    inst_logits = rng.normal(size=(n, 8)).astype(np.float32)
    inst_labels = rng.integers(0, 5, n).astype(np.int32)
    cases = {
        "mse": (lambda L, x: L.mse_loss(x, probs), logits[:, :4]),
        "l1": (lambda L, x: L.l1_loss(x, probs), logits[:, :4]),
        "tv_2d": (lambda L, x: L.tv_loss_2d(x.reshape(2, 8, 24)), logits),
        "tv_1d": (lambda L, x: L.tv_loss_1d(x.reshape(4, 96)), logits),
        "segment_grouping": (
            lambda L, x: L.segment_grouping_loss(
                x, groups, confs, 6, weights, "argmax_conf", valid=valid),
            logits),
        "segment_grouping_noconf": (
            lambda L, x: L.segment_grouping_loss(
                x, groups, confs, 6, weights, "argmax_noconf"), logits),
        "contrastive": (lambda L, x: L.contrastive_loss(
            x, inst_labels, 100.0, valid=valid), feats),
        "slow_fast": (lambda L, x: L.slow_fast_loss(
            x, slow, inst_labels, confs, 8, valid=valid), feats),
        "linear_assignment": (lambda L, x: L.linear_assignment_loss(
            x, inst_labels, confs, 6, valid=valid), inst_logits),
    }
    for mode in ("TTAConf", "NoTTAConf", "none", "symmetric"):
        cases[f"semantic_{mode}"] = (
            lambda L, x, m=mode: L.semantic_loss(
                x, labels, probs, confs, m, weights,
                use_symmetric=(m == "symmetric")), logits)
    return cases


LOSS_CASES = _loss_cases()


def _as(pkg, v):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v) if pkg is jL else torch.from_numpy(v)
    return v


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_values_and_gradients(name):
    fn, x = LOSS_CASES[name]

    # the cases hold numpy arrays; each package converts them itself
    def run_jax(xx):
        return fn(_Pkg(jL), xx)

    value_j, grad_j = jax.value_and_grad(run_jax)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    value_t = fn(_Pkg(tL), xt)
    np.testing.assert_allclose(float(value_t), float(value_j), rtol=LOSS_RTOL,
                               atol=1e-6)
    value_t.backward()
    assert _cos(xt.grad, grad_j) > MIN_COS


class _Pkg:
    """A losses module whose functions take numpy arguments."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        f = getattr(self.mod, name)
        return lambda *a, **k: f(*(_as(self.mod, v) for v in a),
                                 **{kk: _as(self.mod, v) for kk, v in k.items()})


def test_tv_and_class_weights(world, scene):
    want = jL.total_tv_loss(world.jp, world.jcfg, EPOCH)
    np.testing.assert_allclose(float(tL.total_tv_loss(world.tp, world.tcfg,
                                                      EPOCH)),
                               float(want), rtol=1e-5)
    np.testing.assert_array_equal(_np(world.tw), np.asarray(world.jw))
    np.testing.assert_array_equal(
        _np(tL.get_semantic_weights(True, [1, 3], 5, 0.5, device="cpu")),
        np.asarray(jL.get_semantic_weights(True, [1, 3], 5, 0.5)))


def test_hungarian_matches_jax():
    cost = np.random.default_rng(6).normal(size=(5, 8)).astype(np.float32)
    got = tL.hungarian(cost)
    want = np.asarray(jL._hungarian_jax(jnp.asarray(cost)))
    np.testing.assert_allclose(cost[np.arange(5), got].sum(),
                               cost[np.arange(5), want].sum(), rtol=1e-6)


# ---------------------------------------------------------------------------
# 4. renderer: selections, aux passes, the training render
# ---------------------------------------------------------------------------

def _rays(scene, n, seed):
    r = np.concatenate([f.rays for f in scene.train_frames]).astype(np.float32)
    return r[np.random.default_rng(seed).integers(0, len(r), n)]


@pytest.mark.parametrize("jittered", [False, True])
def test_select_segments_and_aux_topk(world, scene, jittered):
    """Train-time skipping selects the same segments and the same top-k
    samples as JAX."""
    rcfg_j = jstep._aux_rcfg(world.jcfg, world.jr, 16)
    rcfg_t = tstep._aux_rcfg(world.tcfg, world.tr, 16)
    assert dataclasses.asdict(rcfg_j) == dataclasses.asdict(rcfg_t)
    rays = _rays(scene, 200, 7)
    u = np.random.default_rng(8).uniform(size=200).astype(np.float32)
    jf = jfg.build_density_only(world.jp, with_occupancy=True)
    tf_ = tfg.build_density_only(world.tp, with_occupancy=True)
    o, d, tmin = jR._ray_tmin(world.js, jnp.asarray(rays))
    to, td, ttmin = tR._ray_tmin(world.ts, _t(rays))
    if jittered:
        tmin = tmin + jnp.asarray(u) * world.js.step_size
        ttmin = ttmin + _t(u) * world.ts.step_size
    js_idx, js_valid = jR._select_segments(world.jm, rcfg_j, world.js, o, d,
                                           tmin, jf)
    ts_idx, ts_valid = tR._select_segments(world.tm, rcfg_t, world.ts, to, td,
                                           ttmin, tf_)
    np.testing.assert_array_equal(_np(ts_valid), np.asarray(js_valid))
    np.testing.assert_array_equal(np.where(_np(ts_valid), _np(ts_idx), -1),
                                  np.where(np.asarray(js_valid),
                                           np.asarray(js_idx), -1))
    assert np.asarray(js_valid).any() and not np.asarray(js_valid).all()
    jw = jR._two_level_density(world.jm, rcfg_j, world.js, jnp.asarray(rays),
                               jf)
    tw = tR._two_level_density(world.tm, rcfg_t, world.ts, _t(rays), tf_)
    np.testing.assert_allclose(_np(tw[6]), np.asarray(jw[6]), atol=1e-5)
    live = np.any(rays[:, 3:6] != 0, axis=-1)
    j_top = jR._aux_topk(rcfg_j, jw[6], jw[0], jw[1], jnp.asarray(live))
    t_top = tR._aux_topk(rcfg_t, tw[6], tw[0], tw[1], _t(live))
    kept = np.asarray(j_top[0]) > rcfg_j.raymarch_weight_thres
    assert kept.any()
    np.testing.assert_array_equal(_np(t_top[0]) > rcfg_t.raymarch_weight_thres,
                                  kept)
    np.testing.assert_allclose(_np(t_top[1])[kept], np.asarray(j_top[1])[kept],
                               atol=1e-6)
    assert float(t_top[3]) == float(j_top[3])


def test_l1_cascade_matches_jax(world, scene):
    """The L1 segment cascade with sub-segments (``use_l1=True``) at
    inference: selections equal, weights within fp32 rounding."""
    rcfg_j = dataclasses.replace(world.jr, coarse_stride=8, sub_stride=4,
                                 max_segments=6, max_subsegments=8)
    rcfg_t = dataclasses.replace(world.tr, coarse_stride=8, sub_stride=4,
                                 max_segments=6, max_subsegments=8)
    jf = jfg.build_render_grids(world.jp, world.jm, rcfg_j, world.js)
    tf_ = tfg.build_render_grids(world.tp, world.tm, rcfg_t, world.ts)
    rcfg_j = jR.occ_grouping_for(rcfg_j, world.js)
    rcfg_t = tR.occ_grouping_for(rcfg_t, world.ts)
    assert dataclasses.asdict(rcfg_j) == dataclasses.asdict(rcfg_t)
    rays = _rays(scene, 150, 9)
    o, d, tmin = jR._ray_tmin(world.js, jnp.asarray(rays))
    to, td, ttmin = tR._ray_tmin(world.ts, _t(rays))
    seg = jR._select_segments(world.jm, rcfg_j, world.js, o, d, tmin, jf)
    tseg = tR._select_segments(world.tm, rcfg_t, world.ts, to, td, ttmin, tf_)
    want = jR._select_subsegments(world.jm, rcfg_j, world.js, o, d, tmin, jf,
                                  *seg)
    got = tR._select_subsegments(world.tm, rcfg_t, world.ts, to, td, ttmin,
                                 tf_, *tseg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    jw = jR._two_level_density(world.jm, rcfg_j, world.js, jnp.asarray(rays),
                               jf)
    tw = tR._two_level_density(world.tm, rcfg_t, world.ts, _t(rays), tf_)
    np.testing.assert_allclose(_np(tw[6]), np.asarray(jw[6]), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_aux_density_weights(world, scene, fused):
    rcfg_j = jstep._aux_rcfg(world.jcfg, world.jr)
    rcfg_t = tstep._aux_rcfg(world.tcfg, world.tr)
    rays = _rays(scene, 128, 10)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (128,)))
    jf = jfg.build_density_only(world.jp, with_occupancy=True) if fused else None
    tf_ = tfg.build_density_only(world.tp, with_occupancy=True) if fused else None
    want = jR.aux_density_weights(world.jp, world.jm, rcfg_j, world.js,
                                  jnp.asarray(rays), key, True, jf)
    got = tR.aux_density_weights(world.tp, world.tm, rcfg_t, world.ts,
                                 _t(rays), tR.RayDraws(_t(u)), True, tf_)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5)
    assert not got[2].requires_grad


@pytest.mark.parametrize("head_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["instance", "segment"])
def test_aux_feature_renders(world, scene, which, head_dtype):
    rcfg_j = dataclasses.replace(jstep._aux_rcfg(world.jcfg, world.jr, 16),
                                 head_dtype=head_dtype)
    rcfg_t = dataclasses.replace(tstep._aux_rcfg(world.tcfg, world.tr, 16),
                                 head_dtype=head_dtype)
    rays = _rays(scene, 128, 11)
    rays[-8:] = 0.0  # zero-padded stream rays
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (128,)))
    jf = jfg.build_density_only(world.jp, with_occupancy=True)
    tf_ = tfg.build_density_only(world.tp, with_occupancy=True)
    jfn = (jR.render_instance_features if which == "instance"
           else jR.render_segment_features)
    tfn = (tR.render_instance_features if which == "instance"
           else tR.render_segment_features)
    want = jfn(world.jp, world.jm, rcfg_j, world.js, jnp.asarray(rays), key,
               True, jf, return_tail=True)
    got = tfn(world.tp, world.tm, rcfg_t, world.ts, _t(rays),
              tR.RayDraws(_t(u)), True, tf_, return_tail=True)
    atol = 1e-5 if head_dtype == "float32" else BF16_ATOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=atol)


@pytest.mark.parametrize("fused", ["none", "density_only", "render_grids"])
def test_training_render_rays(world, scene, fused):
    """render_rays with is_train and JAX's draws (jitter and coin) through
    the three density sources, top-k heads on."""
    rcfg_j = dataclasses.replace(world.jr, head_topk=16)
    rcfg_t = dataclasses.replace(world.tr, head_topk=16)
    rays = _rays(scene, 96, 12)
    key = jax.random.PRNGKey(11)
    k_pts, k_bg = jax.random.split(key)
    draws = tR.RayDraws(_t(np.asarray(jax.random.uniform(k_pts, (96, 1)))[:, 0]),
                        _t(np.asarray(jax.random.uniform(k_bg, ()))))
    jf = tf_ = None
    if fused == "density_only":
        jf, tf_ = (jfg.build_density_only(world.jp),
                   tfg.build_density_only(world.tp))
    elif fused == "render_grids":
        jf = jfg.build_render_grids(world.jp, world.jm, rcfg_j, world.js,
                                    compact=False,
                                    feature_dtype=jnp.float32)
        tf_ = tfg.build_render_grids(world.tp, world.tm, rcfg_t, world.ts,
                                     compact=False, feature_dtype="float32")
    want = jR.render_rays(world.jp, world.jm, rcfg_j, world.js,
                          jnp.asarray(rays), key, True, jf)
    got = tR.render_rays(world.tp, world.tm, rcfg_t, world.ts, _t(rays),
                         draws, True, tf_)
    for k in ("rgb", "semantics", "instances", "depth", "dist_reg",
              "head_tail"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=5e-5, rtol=1e-4, err_msg=k)


def test_render_frames_direct_sampling(world, scene):
    """render_frames(use_fused=False) samples the VM factors directly, as
    JAX's; dense heads and top-k heads."""
    from contrastive_lift_tpu.inference import render as jrender
    frames = scene.val_frames[:1]
    for k in (None, 16):
        rj = dataclasses.replace(world.jr, head_topk=k)
        rt = dataclasses.replace(world.tr, head_topk=k)
        want = jrender.render_frames(world.jp, world.jm, rj, world.js, frames,
                                     chunk=256, use_fused=False)
        got = trender.render_frames(world.tp, world.tm, rt, world.ts, frames,
                                    chunk=256, use_fused=False, device="cpu")
        for key in ("rgb", "semantics", "instances", "depth"):
            np.testing.assert_allclose(got[0][key], want[0][key], atol=5e-5,
                                       rtol=1e-4, err_msg=key)


# ---------------------------------------------------------------------------
# 5. phase losses and their gradients
# ---------------------------------------------------------------------------

def _phase_grads_jax(fn, params):
    (loss, aux), grads = jax.value_and_grad(fn, has_aux=True)(params)
    return float(loss), aux, dict(tree_leaves_with_path(grads))


def _phase_grads_port(fn, params, paths):
    p = tstep._with_grad(params, paths)
    loss, aux = fn(p)
    return float(loss), aux, tstep._grads(loss, p, paths)


def _assert_grads(got, want, paths):
    nonzero = 0
    for path in paths:
        g = np.asarray(want[path])
        if not g.any():
            assert not _np(got[path]).any(), path
            continue
        nonzero += 1
        assert _cos(got[path], g) > MIN_COS, (path, _cos(got[path], g))
    assert nonzero


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("phase", ["main", "segment", "instance"])
def test_phase_loss_and_gradients(world, phase, precision):
    jcfg, tcfg = _cfgs(precision=precision)
    rcfg_j = dataclasses.replace(world.jr, head_dtype={
        "fp32": "float32", "bf16": "bfloat16"}[precision])
    rcfg_t = dataclasses.replace(world.tr, head_dtype=rcfg_j.head_dtype)
    bm, bi, bs = world.batches
    key = jax.random.PRNGKey(21)
    draws = _jax_draws(key, len(bm["rays"]), jcfg.chunk_segment,
                       bi["rays"].shape[:2])
    rng_main, rng_seg, rng_inst = jax.random.split(key, 3)
    gates = jstep.gates_for_epoch(jcfg, EPOCH)
    tgates = tstep.gates_for_epoch(tcfg, EPOCH)
    main_tx, inst_tx, _ = tstate.make_optimizers(tcfg, world.tp)
    k = 16
    if phase == "main":
        def jfn(p):
            return jstep.main_phase_loss(p, jcfg, world.jm, rcfg_j, world.js,
                                         gates, bm, rng_main, 0.001,
                                         world.jw, head_topk=k)

        def tfn(p):
            return tstep.main_phase_loss(p, tcfg, world.tm, rcfg_t, world.ts,
                                         tgates, _batch_t(bm), draws.main,
                                         0.001, world.tw, head_topk=k)
        paths = main_tx.trained_paths()
    elif phase == "segment":
        def jfn(p):
            loss, tail, btail = jstep.segment_phase_loss(
                p, jcfg, world.jm, rcfg_j, world.js, bs, rng_seg, world.jw, k)
            return loss, {"tail": tail, "btail": btail}

        def tfn(p):
            loss, tail, btail = tstep.segment_phase_loss(
                p, tcfg, world.tm, rcfg_t, world.ts, _batch_t(bs),
                draws.seg_jitter, world.tw, k)
            return loss, {"tail": tail, "btail": btail}
        paths = main_tx.trained_paths()
    else:
        def jfn(p):
            loss, tail, btail = jstep.instance_phase_loss(
                p, jcfg, world.jm, rcfg_j, world.js, bi, rng_inst, k)
            return loss, {"tail": tail, "btail": btail}

        def tfn(p):
            loss, tail, btail = tstep.instance_phase_loss(
                p, tcfg, world.tm, rcfg_t, world.ts, _batch_t(bi),
                draws.inst_jitter, k)
            return loss, {"tail": tail, "btail": btail}
        paths = inst_tx.trained_paths()
    lj, aux_j, gj = _phase_grads_jax(jfn, world.jp)
    lt, aux_t, gt = _phase_grads_port(tfn, world.tp, paths)
    assert lj != 0
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    for name, v in aux_j.items():
        np.testing.assert_allclose(float(aux_t[name]), float(v),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=name)
    _assert_grads(gt, gj, paths)


# ---------------------------------------------------------------------------
# 6. optimizer, EMA, checkpoints, schedule, samplers, calibration
# ---------------------------------------------------------------------------

def test_adam_chains_match_optax(world):
    """Three updates of both chains (random gradients) equal optax's."""
    jcfg, tcfg = world.jcfg, world.tcfg
    jmain, jinst, _ = jstate.make_optimizers(jcfg, world.jp)
    tmain, tinst, labels = tstate.make_optimizers(tcfg, world.tp)
    assert labels == dict(tree_leaves_with_path(
        jstate.build_labels(world.jp, jcfg.use_DINO_style)))
    rng = np.random.default_rng(12)
    jp, tp = world.jp, dict(tree_leaves_with_path(world.tp))
    for jtx, ttx in ((jmain, tmain), (jinst, tinst)):
        js, ts = jtx.init(jp), ttx.init(world.tp)
        for _ in range(3):
            grads = jax.tree.map(
                lambda x: rng.normal(size=x.shape).astype(np.float32), jp)
            ju, js = jtx.update(jax.tree.map(jnp.asarray, grads), js, jp)
            tu, ts = ttx.update({p: _t(g) for p, g in
                                 tree_leaves_with_path(grads)}, ts, tp)
            ju = dict(tree_leaves_with_path(ju))
            for path, u in ju.items():
                if path in tu:
                    np.testing.assert_allclose(_np(tu[path]), np.asarray(u),
                                               rtol=2e-5, atol=1e-9)
                else:
                    assert not np.asarray(u).any(), path
        for a, b in zip(tckpt.opt_state_leaves(ts, {}),
                        jax.tree_util.tree_leaves(js)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-5,
                                       atol=1e-12)


def test_opt_leaves_map_to_jax_restore(world, tmp_path):
    """The __opt__ leaves of a JAX checkpoint restore into the port's Adam
    state leaf by leaf as JAX's restore_opt_state pairs them, and the port
    saves a checkpoint the JAX loader restores to the same state."""
    jcfg = world.jcfg
    jmain, jinst, _ = jstate.make_optimizers(jcfg, world.jp)
    rng = np.random.default_rng(13)
    js = []
    for tx in (jmain, jinst):
        s = tx.init(world.jp)
        for _ in range(2):
            g = jax.tree.map(lambda x: jnp.asarray(
                rng.normal(size=x.shape).astype(np.float32)), world.jp)
            _, s = tx.update(g, s, world.jp)
        js.append(s)
    path = tmp_path / "ckpt.npz"
    jckpt.save_checkpoint(path, world.jp, grid_dim=GRID,
                          bbox_aabb=np.asarray(world.js.bbox_aabb), epoch=3,
                          global_step=7, opt_state=tuple(js))
    params, meta = tckpt.load_checkpoint(path)
    tp = params_from_numpy(params, "cpu")
    tmain, tinst, _ = tstate.make_optimizers(world.tcfg, tp)
    t_main, t_inst = tckpt.opt_state_from_leaves(tmain, tinst,
                                                 meta["opt_leaves"], tp)
    fresh = jstate.init_train_state(jcfg, world.jp)
    restored = jckpt.restore_opt_state(
        (fresh.opt_state_main, fresh.opt_state_inst),
        jckpt.load_checkpoint(path)[1]["opt_leaves"])
    want = jax.tree_util.tree_leaves(restored)
    got = tckpt.opt_state_leaves(t_main, t_inst)
    assert len(got) == len(want) == meta["n_opt_leaves"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # label by label: the mu of each port leaf is JAX's mu of that leaf
    jmu = jax.tree_util.tree_leaves_with_path(restored[0])
    assert any("mu" in jax.tree_util.keystr(p) for p, _ in jmu)
    out = tmp_path / "port.npz"
    tckpt.save_checkpoint(out, tp, grid_dim=GRID,
                          bbox_aabb=_np(world.ts.bbox_aabb), epoch=3,
                          global_step=7, opt_state=(t_main, t_inst))
    jparams, jmeta = jckpt.load_checkpoint(out)
    again = jckpt.restore_opt_state(
        (fresh.opt_state_main, fresh.opt_state_inst), jmeta["opt_leaves"])
    for a, b in zip(jax.tree_util.tree_leaves(again), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(jparams),
                                tree_leaves_with_path(world.jp)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("use_proj", [False, True])
def test_ema_update_slow(scene, use_proj):
    jcfg, tcfg = _cfgs(use_proj=use_proj)
    _, jp, _, _ = jbuild_model(jcfg, 2, scene.scene_bounds, (8, 8, 8))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = jstate.ema_update_slow(jp, 0.9 ** 3, use_proj)
    got = tstate.ema_update_slow(tp, 0.9 ** 3, use_proj)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(got),
                                tree_leaves_with_path(want)):
        assert pa == pb
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_schedule_and_gates(world):
    for epoch in range(0, 25):
        assert tschedule.lr_scale_for_epoch(epoch, [9, 18], 0.5, 3, 2.0) == \
            jschedule.lr_scale_for_epoch(epoch, [9, 18], 0.5, 3, 2.0)
        assert dataclasses.asdict(tstep.gates_for_epoch(world.tcfg, epoch)) \
            == dataclasses.asdict(jstep.gates_for_epoch(world.jcfg, epoch))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_sampler_batches_equal(world, which):
    """One seed gives both packages' samplers the same batches."""
    jsmp, tsmp = world.samplers[which]
    n = (world.jcfg.batch_size, 2, world.jcfg.batch_size_segments)[which]
    for seed in (0, 5):
        a = jsmp.sample(np.random.default_rng(seed), n)
        b = tsmp.sample(np.random.default_rng(seed), n)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            assert b[k].dtype == a[k].dtype


def test_native_library_builds_in_port_build_dir():
    from contrastive_lift_tpu_torch.data import native
    src = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
    idx = np.array([3, 1, 49, 3])
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    if native.native_available():
        assert native.library_path().parent == native.BUILD_DIR
        assert native.library_path().exists()


def test_calibrate_aux_topk_equals_jax(world):
    """The port's k equals the JAX Trainer's on the same field and probe."""
    gates = jstep.gates_for_epoch(world.jcfg, EPOCH)
    stub = SimpleNamespace(
        cfg=world.jcfg, rcfg=world.jr, main_sampler=world.samplers[0][0],
        mcfg=world.jm, grid_dim=GRID, state_r=world.js, _count_fn=None,
        _count_key=None, state=SimpleNamespace(params=world.jp))
    with jax.disable_jit():
        want = jloop.Trainer._calibrate_aux_topk(stub, gates, EPOCH)
    got = tloop.calibrate_aux_topk(
        world.tcfg, world.tp, world.tm, world.tr, world.ts,
        tstep.gates_for_epoch(world.tcfg, EPOCH), EPOCH, world.samplers[0][1])
    assert want is not None
    assert got == want
    early = tstep.gates_for_epoch(world.tcfg, 1)
    assert tloop.calibrate_aux_topk(world.tcfg, world.tp, world.tm, world.tr,
                                    world.ts, early, 1,
                                    world.samplers[0][1]) is None


# ---------------------------------------------------------------------------
# 7. the whole step
# ---------------------------------------------------------------------------

def _jax_step_grads(world, jcfg, gates, state, batches, key, lr_scale,
                    lambda_dist, k):
    """The gradients the JAX step takes from ``state``: the main phase's
    (main + segment loss) and the instance phase's (after the main update),
    recomputed with the JAX package's phase losses."""
    bm, bi, bs = batches
    rng_main, rng_seg, rng_inst = jax.random.split(key, 3)
    main_tx, _, _ = jstate.make_optimizers(jcfg, state.params)

    def loss_fn(p):
        loss, _ = jstep.main_phase_loss(p, jcfg, world.jm, world.jr, world.js,
                                        gates, bm, rng_main, lambda_dist,
                                        world.jw, head_topk=k)
        seg, _, _ = jstep.segment_phase_loss(p, jcfg, world.jm, world.jr,
                                             world.js, bs, rng_seg, world.jw,
                                             k)
        return loss + jcfg.lambda_semantics * jcfg.lambda_segment * seg

    def inst_fn(p):
        return jstep.instance_phase_loss(p, jcfg, world.jm, world.jr,
                                         world.js, bi, rng_inst, k)[0]

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    updates, _ = main_tx.update(grads, state.opt_state_main, state.params)
    p1 = jax.tree.map(lambda a, u: a + u * lr_scale, state.params, updates)
    grads_i = jax.jit(jax.grad(inst_fn))(p1)
    return (dict(tree_leaves_with_path(grads)),
            dict(tree_leaves_with_path(grads_i)))


def test_make_train_step_three_steps(world):
    """make_train_step with every phase for 3 steps, JAX's draws injected:
    every metric within rtol 2e-3 at every step, and at every step the
    gradients each chain applies with a cosine above 0.999 per leaf to those
    the JAX step takes from its own state. The slow net moves by the EMA
    alone, as in JAX."""
    jcfg, tcfg = world.jcfg, world.tcfg
    gates = jstep.gates_for_epoch(jcfg, EPOCH)
    tgates = tstep.gates_for_epoch(tcfg, EPOCH)
    k = tloop.calibrate_aux_topk(tcfg, world.tp, world.tm, world.tr, world.ts,
                                 tgates, EPOCH, world.samplers[0][1])
    assert k is not None
    jfn = jstep.make_train_step(jcfg, world.jm, world.jr, gates, world.jw,
                                world.jp, donate=False, aux_head_topk=k)
    tfn = tstep.make_train_step(tcfg, world.tm, world.tr, tgates, world.tw,
                                world.tp, aux_head_topk=k, keep_grads=True)
    main_tx, inst_tx, _ = tstate.make_optimizers(tcfg, world.tp)
    jst = jstate.init_train_state(jcfg, world.jp)
    tst = tstate.init_train_state(tcfg, world.tp)
    rng = np.random.default_rng(2)
    samplers = [s[1] for s in world.samplers]
    for i in range(3):
        batches = (samplers[0].sample(rng, jcfg.batch_size),
                   samplers[1].sample(rng, 1),
                   samplers[2].sample(rng, jcfg.batch_size_segments))
        key = jax.random.PRNGKey(100 + i)
        draws = _jax_draws(key, jcfg.batch_size, jcfg.chunk_segment,
                           batches[1]["rays"].shape[:2])
        want_g = _jax_step_grads(world, jcfg, gates, jst, batches, key, 0.5,
                                 0.001, k)
        jst, jm = jfn(jst, world.js, *batches, key, 0.5, 0.001)
        tst, tm = tfn(tst, world.ts, *batches, draws, 0.5, 0.001)
        assert set(tm) == set(jm)
        for name, v in jm.items():
            np.testing.assert_allclose(float(tm[name]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"step {i} {name}")
        _assert_grads(tfn.grads["main"], want_g[0], main_tx.trained_paths())
        _assert_grads(tfn.grads["inst"], want_g[1], inst_tx.trained_paths())
    path = ("instance_mlp", "slow", "layers", 0, "w")
    start = _np(world.tp["instance_mlp"]["slow"]["layers"][0]["w"])
    moved_t = _np(tst.params["instance_mlp"]["slow"]["layers"][0]["w"]) - start
    moved_j = np.asarray(
        jst.params["instance_mlp"]["slow"]["layers"][0]["w"]) - start
    assert moved_t.any()
    assert _cos(moved_t, moved_j) > MIN_COS, path


def test_entry_points_default_to_the_card(world, scene, monkeypatch):
    """Without a card the training entry points refuse to run unless told
    device="cpu"; there is no quiet fallback."""
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.inference.fidelity import (R5B_CKPT,
                                                               R5B_CONFIG)
    from contrastive_lift_tpu_torch.train import resume
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tbuild_model(world.tcfg, 2, scene.scene_bounds, GRID),
        lambda: tclass_weights(world.tcfg, scene.segmentation),
        lambda: ttf.init_tensorf(torch.Generator(), world.tm, GRID),
        lambda: tL.get_semantic_weights(False, [1], 2),
        lambda: resume.restore_training(R5B_CKPT, load_config(R5B_CONFIG),
                                        scene),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
