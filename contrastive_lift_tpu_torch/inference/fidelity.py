"""PQ^scene of the dense fp32 render of a trained checkpoint.

Port of the dense half of ``tools/pq_fidelity_gate.py``: regenerate the
checkpoint's deterministic synthetic scene, render its val frames with the
dense fp32 config (no empty-space skipping, no top-k, fp32 heads and atlas),
cluster the fast instance embeddings with mean-shift, and score PQ^scene
against the scene's ground truth. ``run_dense`` returns the maps and the
scores, so a run on the card can be held against the JAX package's numbers.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from ..config import Config
from ..data.synthetic import make_synthetic_scene
from ..metrics.panoptic_quality import panoptic_quality
from .cluster import cluster, create_instances_from_semantics
from .render import load_model_for_inference, render_frames

# r5b: the committed reference-scale checkpoint and its training scene
# (64x96 frames, 64 train frames, checker_freq 18; ROADMAP, commit 1fdbf4d),
# clustered with the PQ gate's bandwidth and rendered in its 1,024-ray chunks
R5B_CKPT = (Path(__file__).resolve().parents[2] / "artifacts" / "e2e_r5b_tpu"
            / "checkpoints" / "final.npz")
R5B_SCENE = ((64, 96), 64, 18.0)
BANDWIDTH = 0.15
CHUNK = 1024


def e2e_scene(image_dim=(48, 64), num_train=24, checker_freq=40.0):
    return make_synthetic_scene(num_spheres=5, num_train=num_train, num_val=4,
                                image_dim=tuple(image_dim),
                                num_thing_classes=1, seed=7,
                                checker_freq=checker_freq)


def e2e_config(image_dim=(48, 64), max_grid=128, epochs=10):
    return Config(
        instance_loss_mode="slow_fast", use_DINO_style=True, use_proj=False,
        use_delta=False, temperature=100.0, max_instances=3,
        use_mlp_for_semantics=True, use_mlp_for_instances=True,
        pe_sem=0, pe_ins=0, semantic_weight_mode="softmax",
        probabilistic_ce_mode="NoTTAConf",
        batch_size=2048, chunk=4096, min_grid_dim=64, max_grid_dim=max_grid,
        max_epoch=epochs, image_dim=tuple(image_dim), seed=0,
        weight_class_0=1.0,
    ).resolve_epochs()


def pq_for(per_frame, onehot, scene, max_instances):
    """(pq, sq, rq, pq_masked) of rendered maps + clustered instances vs the
    synthetic GT. The masked variant forces predictions on
    pseudo-label-void pixels to void (the reference's validation-time
    masking); it is the variant with signal at short training budgets."""
    preds, preds_masked, targets = [], [], []
    for i, frame in enumerate(scene.val_frames):
        sem_pred = per_frame[i]["semantics"].argmax(-1)
        inst_pred = np.asarray(onehot[i]).argmax(-1)
        m = frame.mask
        preds.append(np.stack([sem_pred[m], inst_pred[m]], -1))
        sem_m = np.where(frame.semantics == 0, 0, sem_pred)
        preds_masked.append(np.stack([sem_m[m], inst_pred[m]], -1))
        targets.append(np.stack([frame.gt_semantics[m],
                                 frame.gt_instances[m]], -1))
    things = scene.things_filtered or set(scene.segmentation.fg_classes)
    stuffs = scene.stuff_filtered or {0}
    targets_cat = np.concatenate(targets)
    pq, sq, rq = panoptic_quality(
        np.concatenate(preds), targets_cat, things, stuffs,
        allow_unknown_preds_category=True)
    pq_m, _, _ = panoptic_quality(
        np.concatenate(preds_masked), targets_cat, things, stuffs,
        allow_unknown_preds_category=True)
    return float(pq), float(sq), float(rq), float(pq_m)


def cluster_maps(per_frame, scene, bandwidth, max_instances, device="cuda"):
    """Cluster the fast half of the slow-fast embeddings on thing pixels."""
    sem_cat = np.concatenate([f["semantics"] for f in per_frame])
    inst_cat = np.concatenate([f["instances"] for f in per_frame])
    fast = inst_cat[:, :max_instances]
    thing_features = create_instances_from_semantics(
        fast, sem_cat, scene.segmentation.fg_classes)
    return cluster(thing_features, bandwidth=bandwidth,
                   num_images=len(scene.val_frames), device=device)


def dense_config(rcfg):
    """The gate's dense fp32 reference config: no ESS, no top-k, fp32."""
    return dataclasses.replace(
        rcfg, coarse_stride=None, sub_stride=None, head_topk=None,
        head_topk_semins=None, head_dtype="float32", atlas_dtype="float32")


def load_dense(ckpt, scene, device="cuda"):
    """(cfg, params, model config, dense render config, render state, meta)
    of checkpoint ``ckpt`` for ``scene``, at the gate's step_ratio 0.25."""
    cfg = e2e_config(scene.image_dim)
    params, mcfg, rcfg, state_r, meta = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, step_ratio=0.25,
        head_topk=None, device=device)
    return cfg, params, mcfg, dense_config(rcfg), state_r, meta


def run_dense(ckpt, scene, device="cuda", bandwidth: float = BANDWIDTH,
              chunk: int = CHUNK) -> dict:
    """Dense render of ``scene``'s val frames from checkpoint ``ckpt``, then
    clustering and PQ^scene. Returns the per-frame maps, the scores and the
    seconds each stage took."""
    cfg, params, mcfg, rcfg, state_r, meta = load_dense(ckpt, scene, device)
    t0 = time.perf_counter()
    frames = render_frames(params, mcfg, rcfg, state_r, scene.val_frames,
                           chunk=chunk, device=device)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    onehot = cluster_maps(frames, scene, bandwidth, cfg.max_instances, device)
    t_cluster = time.perf_counter() - t0
    pq, sq, rq, pq_m = pq_for(frames, onehot, scene, cfg.max_instances)
    return {"maps": frames, "pq_scene": pq, "pq_masked": pq_m, "sq": sq,
            "rq": rq, "n_samples": rcfg.n_samples,
            "grid_dim": tuple(meta["grid_dim"]),
            "render_seconds": t_render, "cluster_seconds": t_cluster}
