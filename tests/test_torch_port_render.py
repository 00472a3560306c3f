"""The port's slice as a whole against the JAX package: checkpoint -> dense
render -> clustering -> PQ^scene, on the CPU at grid 14.

The checkpoint is a grid-14 ``init_tensorf`` field saved with the JAX
package's ``save_checkpoint``; its density factors are scaled and offset so
that rays cross both empty and opaque space. Both packages load the same file
and render the same rays with the PQ gate's dense fp32 config.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastive_lift_tpu.config import Config as JConfig
from contrastive_lift_tpu.data.base import FrameData as JFrame
from contrastive_lift_tpu.data.synthetic import make_synthetic_scene as j_scene
from contrastive_lift_tpu.factory import build_model
from contrastive_lift_tpu.inference import render as jrender
from contrastive_lift_tpu.io.checkpoint import save_checkpoint
from contrastive_lift_tpu.ops import fused_grid as jfg
from contrastive_lift_tpu_torch.config import Config as TConfig
from contrastive_lift_tpu_torch.data.base import FrameData as TFrame
from contrastive_lift_tpu_torch.data.synthetic import make_synthetic_scene as t_scene
from contrastive_lift_tpu_torch.inference import cluster as tcluster
from contrastive_lift_tpu_torch.inference import fidelity as tfid
from contrastive_lift_tpu_torch.inference import render as trender
from contrastive_lift_tpu_torch.ops import fused_grid as tfg
from contrastive_lift_tpu_torch.renderer import render as tR

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import pq_fidelity_gate as gate  # noqa: E402

torch.set_num_threads(2)
BBOX = np.array(((-1.2, -0.9, -1.0), (0.8, 1.1, 1.0)), np.float32)
MAP_KEYS = ("rgb", "semantics", "instances", "depth")
VARIANTS = {
    # the r5b configuration: xyz-MLP semantic/instance heads, slow-fast
    "e2e": dict(),
    # grid-branch heads (dense projected grids), argmax head weights
    "grid_heads": dict(use_mlp_for_semantics=False, use_mlp_for_instances=False,
                       semantic_weight_mode="argmax"),
    # no softmax postprocess, white background
    "white_bg": dict(semantic_weight_mode="none"),
    # the r5b configuration with a bf16 density atlas (ATLAS_DTYPE)
    "e2e_atlas_bf16": dict(),
    # the r5b configuration with bf16 heads (HEAD_DTYPE)
    "e2e_heads_bf16": dict(),
}
# RenderConfig.atlas_dtype / head_dtype of a variant, where not float32
ATLAS_DTYPE = {"e2e_atlas_bf16": "bfloat16"}
HEAD_DTYPE = {"e2e_heads_bf16": "bfloat16"}


def _cfg(Config, **kw):
    base = dict(instance_loss_mode="slow_fast", use_DINO_style=True,
                max_instances=3, use_mlp_for_semantics=True,
                use_mlp_for_instances=True, semantic_weight_mode="softmax",
                image_dim=(16, 24), seed=0)
    base.update(kw)
    return Config(**base).resolve_epochs()


def _checkpoint(path, cfg_kw, bbox=BBOX, classes=2):
    """A grid-14 field whose density spans empty and opaque space."""
    mcfg, params, _, _ = build_model(_cfg(JConfig, **cfg_kw), classes, bbox,
                                     (14, 14, 14), step_ratio=0.25)
    params = jax.tree.map(np.array, params)
    planes = [p * 10 for p in params["density"]["planes"]]
    lines = [line * 3 for line in params["density"]["lines"]]
    planes[0][0], lines[0][0] = 3.0, 3.0
    params["density"] = {"planes": tuple(planes), "lines": tuple(lines)}
    save_checkpoint(path, params, grid_dim=(14, 14, 14), bbox_aabb=bbox,
                    epoch=0, global_step=0)
    return path


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)) + np.array([0.0, 0.0, -2.0])
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 0.05), np.full((n, 1), 5.0)],
                          -1).astype(np.float32)


def _dense(rcfg, atlas_dtype="float32", head_dtype="float32"):
    return dataclasses.replace(rcfg, coarse_stride=None, sub_stride=None,
                               head_topk=None, head_topk_semins=None,
                               head_dtype=head_dtype, atlas_dtype=atlas_dtype)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_render_frames_matches_jax(tmp_path, variant):
    """Dense render, fused grids, device="cpu": maps within atol 2e-5 /
    rtol 1e-4 of the JAX package (fp32; the two sum in different orders).
    A ray count that is not a multiple of the chunk exercises the padding.
    With a bf16 atlas the bar is the same: both packages round the same
    float32 grid to the same bf16 atlas (checked here) and widen it to
    float32 before any arithmetic. With bf16 heads both packages read bf16
    feature grids and run bf16 matmuls, and the bar is the 3e-2 the JAX
    package accepts for bf16 against fp32 heads."""
    kw = VARIANTS[variant]
    atlas_dtype = ATLAS_DTYPE.get(variant, "float32")
    head_dtype = HEAD_DTYPE.get(variant, "float32")
    bar = (dict(atol=3e-2, rtol=0) if head_dtype == "bfloat16"
           else dict(atol=2e-5, rtol=1e-4))
    ckpt = _checkpoint(tmp_path / "field.npz", kw)
    white = variant == "white_bg"
    rays = [_rays(300, 1)]
    jp, jm, jr, js, _ = jrender.load_model_for_inference(
        ckpt, _cfg(JConfig, **kw), 2, white_bg=white, head_topk=None)
    want = jrender.render_frames(
        jp, jm, _dense(jr, atlas_dtype, head_dtype), js,
        [JFrame(str(i), r, *([None] * 6)) for i, r in enumerate(rays)],
        chunk=128)
    tp, tm, tr, ts, _ = trender.load_model_for_inference(
        ckpt, _cfg(TConfig, **kw), 2, white_bg=white, head_topk=None,
        device="cpu")
    got = trender.render_frames(
        tp, tm, _dense(tr, atlas_dtype, head_dtype), ts,
        [TFrame(str(i), r, *([None] * 6)) for i, r in enumerate(rays)],
        chunk=128, device="cpu")
    for w, g in zip(want, got):
        # the heads see above-threshold samples on a good share of the rays
        assert np.mean(np.abs(w["instances"]).sum(-1) > 0) > 0.2
        for key in MAP_KEYS:
            np.testing.assert_allclose(g[key], w[key], **bar,
                                       err_msg=f"{variant}: {key}")
    if atlas_dtype != "float32":
        j_atlas = jfg.build_render_grids(jp, jm, _dense(jr, atlas_dtype), js,
                                         compact=False, atlas_dtype=jnp.bfloat16
                                         ).brick_atlas
        t_atlas = tfg.build_render_grids(tp, tm, _dense(tr, atlas_dtype), ts,
                                         compact=False,
                                         atlas_dtype=atlas_dtype).brick_atlas
        assert t_atlas.dtype == torch.bfloat16
        np.testing.assert_array_equal(t_atlas.float().numpy(),
                                      np.asarray(j_atlas, np.float32))


def test_synthetic_scene_matches_jax():
    kw = dict(num_spheres=5, num_train=3, num_val=4, image_dim=(16, 24),
              num_thing_classes=1, seed=7, checker_freq=18.0)
    js, ts = j_scene(**kw), t_scene(**kw)
    assert dataclasses.asdict(ts.segmentation) == dataclasses.asdict(js.segmentation)
    np.testing.assert_array_equal(ts.scene_bounds, js.scene_bounds)
    for jf, tf in zip(js.train_frames + js.val_frames,
                      ts.train_frames + ts.val_frames):
        np.testing.assert_allclose(tf.rays, jf.rays, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tf.rgbs, jf.rgbs, atol=1e-5, rtol=0)
        for key in ("semantics", "instances", "gt_semantics", "gt_instances",
                    "mask"):
            np.testing.assert_array_equal(getattr(tf, key), getattr(jf, key))


def _maps_from_gt(scene, seed=0):
    """Per-frame maps whose semantics and embeddings follow the GT, with
    noise: what a trained field renders, without training one."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (16, 6)).astype(np.float32)
    out = []
    for f in scene.val_frames:
        sem = np.eye(2, dtype=np.float32)[(f.gt_semantics > 0).astype(int)]
        sem = np.log(0.8 * sem + 0.1 + 0.05 * rng.uniform(size=sem.shape))
        ins = centers[f.gt_instances] + 0.05 * rng.standard_normal(
            (len(f.gt_instances), 6)).astype(np.float32)
        out.append({"semantics": sem.astype(np.float32),
                    "instances": ins.astype(np.float32)})
    return out


def test_cluster_and_pq_match_jax():
    """Mean-shift + PQ^scene on a tiny synthetic scene: the same clusters and
    the same PQ, SQ, RQ and masked PQ as the JAX gate's functions."""
    kw = dict(num_spheres=5, num_train=1, num_val=4, image_dim=(32, 48),
              num_thing_classes=1, seed=7, checker_freq=18.0)
    js, ts = j_scene(**kw), t_scene(**kw)
    maps = _maps_from_gt(js)
    oh_j = gate.cluster_maps(maps, js, 0.15, 3)
    oh_t = tfid.cluster_maps(maps, ts, 0.15, 3, device="cpu")
    np.testing.assert_array_equal(oh_t, oh_j)
    assert oh_t.shape[-1] > 2
    pq_t = tfid.pq_for(maps, oh_t, ts, 3)
    assert pq_t == gate.pq_for(maps, oh_j, js, 3)
    assert pq_t[0] > 0.3


def test_run_dense_matches_jax_pipeline(tmp_path):
    """run_dense (render -> cluster -> PQ) == the JAX render_frames plus the
    gate's cluster_maps / pq_for, on a tiny scene and a grid-14 field."""
    js = gate.e2e_scene((16, 24), 2, 18.0)
    ts = tfid.e2e_scene((16, 24), 2, 18.0)
    ckpt = _checkpoint(tmp_path / "field.npz", {}, bbox=js.scene_bounds)
    cfg = gate.e2e_config((16, 24))
    jp, jm, jr, jst, _ = jrender.load_model_for_inference(
        ckpt, cfg, js.num_semantic_classes, step_ratio=0.25, head_topk=None)
    frames = jrender.render_frames(jp, jm, _dense(jr), jst, js.val_frames,
                                   chunk=256)
    oh = gate.cluster_maps(frames, js, 0.15, cfg.max_instances)
    pq, sq, rq, pq_m = gate.pq_for(frames, oh, js, cfg.max_instances)
    got = tfid.run_dense(ckpt, ts, device="cpu", chunk=256)
    for w, g in zip(frames, got["maps"]):
        for key in MAP_KEYS:
            np.testing.assert_allclose(g[key], w[key], atol=2e-5, rtol=1e-4)
    assert (got["pq_scene"], got["sq"], got["rq"], got["pq_masked"]) == (
        pq, sq, rq, pq_m)


@pytest.mark.parametrize("frame,n_rays", [(0, 64), (2, 100)])
def test_render_chunk_is_what_render_rays_passes_the_kernel(tmp_path,
                                                            monkeypatch,
                                                            frame, n_rays):
    """fidelity.render_chunk, which chip_smoke.py times the kernel on, gives
    exactly the coordinates, shift and atlas grid of the dense render's first
    chunk of a frame."""
    ts = tfid.e2e_scene((16, 24), 2, 18.0)
    ckpt = _checkpoint(tmp_path / "field.npz", {}, bbox=ts.scene_bounds)
    seen = []
    real = tR.sample_density_brick

    def spy(fused, xyz, shift):
        seen.append((fused.brick_atlas, xyz.clone(), shift))
        return real(fused, xyz, shift)

    monkeypatch.setattr(tR, "sample_density_brick", spy)
    _, p, m, r, s, _ = tfid.load_dense(ckpt, ts, device="cpu")
    trender.render_frames(p, m, r, s, ts.val_frames[frame:frame + 1],
                          chunk=n_rays, device="cpu")
    dense, shift, xyz = tfid.render_chunk(ckpt, ts, device="cpu", frame=frame,
                                          n_rays=n_rays)
    atlas, xyz_kernel, shift_kernel = seen[0]
    assert xyz.shape == (n_rays * r.n_samples, 3)
    assert torch.equal(xyz, xyz_kernel)
    assert shift == shift_kernel
    assert torch.equal(tfg.build_brick_atlas(dense), atlas)


def test_unported_options_raise(tmp_path):
    """The production path (head_topk "auto", empty-space skipping), direct
    VM sampling (use_fused=False, fused=None) and training renders (is_train
    with rng) are ported and run; what the port still lacks raises
    NotImplementedError naming it: the L1 budget of the calibration
    (l2_only=False), heavy/light bucketing (what calibration picks with
    termination=False on this field), iter/rank head selection, head dedup,
    span gathers, baked heads and the distilled-feature heads (a mesh
    renders: tests/test_torch_port_parallel.py)."""
    ckpt = _checkpoint(tmp_path / "field.npz", {})
    cfg = _cfg(TConfig)
    p, m, r, s, _ = trender.load_model_for_inference(ckpt, cfg, 2,
                                                     device="cpu")
    assert r.head_topk == 8
    frames = [TFrame("0", _rays(64, 0), *([None] * 6))]
    assert trender.render_frames(p, m, r, s, frames,
                                 device="cpu")[0]["rgb"].shape == (64, 3)
    with pytest.raises(NotImplementedError, match="use_l1"):
        trender.render_frames(p, m, r, s, frames, l2_only=False, device="cpu")
    light = dataclasses.replace(r, max_subsegments_light=4, heavy_fraction=0.5)
    with pytest.raises(NotImplementedError, match="max_subsegments_light"):
        trender.render_frames(p, m, light, s, frames, termination=False,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="bake_heads"):
        trender.render_frames(p, m, r, s, frames, device="cpu",
                              bake_heads=True)
    assert trender.render_frames(p, m, r, s, frames, use_fused=False,
                                 device="cpu")[0]["rgb"].shape == (64, 3)
    # every unported option is refused, on the dense and production paths;
    # the bf16 atlas and bf16 heads are ported and are not
    # (head_dedup_cells needs head_topk)
    for rcfg, dedup in ((_dense(r), ()), (r, (("head_dedup_cells", 4),))):
        for field, value in (("fine_span_rows", 4), ("head_select", "rank"),
                             ("head_select", "iter"), *dedup):
            with pytest.raises(NotImplementedError, match=field):
                trender.render_frames(
                    p, m, dataclasses.replace(rcfg, **{field: value}), s,
                    frames, device="cpu")
    for field in ("atlas_dtype", "head_dtype"):
        bf16 = dataclasses.replace(r, **{field: "bfloat16"})
        assert trender.render_frames(p, m, bf16, s, frames,
                                     device="cpu")[0]["rgb"].shape == (64, 3)
    rays = torch.from_numpy(_rays(8, 0))
    dense = _dense(r)
    assert tR.render_rays(p, m, dense, s, rays)["rgb"].shape == (8, 3)
    train = tR.render_rays(p, m, dense, s, rays, torch.Generator(),
                           is_train=True)
    assert torch.isfinite(train["rgb"]).all()
    distilled = dataclasses.replace(m, use_distilled_features_semantic=True)
    with pytest.raises(NotImplementedError, match="distilled"):
        tR.render_rays(p, distilled, dense, s, rays)
    for fn in (tR.render_instance_features, tR.render_segment_features):
        with pytest.raises(NotImplementedError, match="distilled"):
            fn(p, distilled, dense, s, rays)
        with pytest.raises(NotImplementedError, match="head_select"):
            fn(p, m, dataclasses.replace(dense, head_select="rank"), s, rays)
    # HDBSCAN is ported (slice 1c): clustering with it runs; these
    # features have no thing pixel, so every pixel is noise
    assert tcluster.cluster(np.zeros((200, 4), np.float32), 0.1, 1,
                            use_dbscan=True, device="cpu").shape == (1, 200, 1)
