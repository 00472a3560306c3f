"""PQ^scene of the dense and the production render of a trained checkpoint.

Port of ``tools/pq_fidelity_gate.py``: regenerate the checkpoint's
deterministic synthetic scene, render its val frames, cluster the fast
instance embeddings with mean-shift, and score PQ^scene against the scene's
ground truth. ``run_dense`` renders with the dense fp32 config (no
empty-space skipping, no top-k, fp32 heads and, unless asked for bf16 as the
gate's ``--atlas_dtype`` does, an fp32 atlas); ``run_production`` with the
gate's production point (``production_config``: ``render_frames`` defaults,
top-8 bf16 heads) in the gate's 4,096-ray chunks. Both return the maps and
the scores, so a run on the card can be held against the JAX package's
numbers. ``render_chunk`` and ``production_chunk`` give the density kernel's
inputs for one chunk of each render, for timing the kernel on the render's
own samples.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..data.synthetic import make_synthetic_scene
from ..metrics.panoptic_quality import panoptic_quality
from ..ops.fused_grid import build_dense_density
from ..renderer import render as R
from ..renderer.render import normalize_coordinates, sample_points_in_box
from ..utils.device import resolve_device
from .cluster import cluster, create_instances_from_semantics
from .render import (load_model_for_inference, prepare_render, render_frames,
                     render_frames_report)

# r5b: the committed reference-scale checkpoint and its training scene
# (64x96 frames, 64 train frames, checker_freq 18; ROADMAP, commit 1fdbf4d),
# clustered with the PQ gate's bandwidth and rendered in its 1,024-ray chunks
R5B_CKPT = (Path(__file__).resolve().parents[2] / "artifacts" / "e2e_r5b_tpu"
            / "checkpoints" / "final.npz")
R5B_SCENE = ((64, 96), 64, 18.0)
# the configuration r5b was trained with
R5B_CONFIG = R5B_CKPT.parents[1] / "config.json"
BANDWIDTH = 0.15
CHUNK = 1024
# the gate renders the production path in chunks of cfg.chunk; the number of
# termination survivors, round(chunk * term_fraction), depends on it
PRODUCTION_CHUNK = 4096
# the RenderConfig fields render_frames sets before it renders (grouping,
# L2-only, tail completion, calibrated budgets)
BUDGET_FIELDS = ("max_segments", "max_subsegments", "max_subsegments_light",
                 "term_first", "term_fraction", "head_term_first",
                 "head_term_fraction", "occ_group_l1", "occ_group_l2",
                 "l2_flat_group", "use_l1", "head_tail_complete")


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


def load_dense(ckpt, scene, device="cuda", atlas_dtype: str = "float32"):
    """(cfg, params, model config, dense render config, render state, meta)
    of checkpoint ``ckpt`` for ``scene``, at the gate's step_ratio 0.25,
    with a density atlas of ``atlas_dtype``."""
    cfg = e2e_config(scene.image_dim)
    params, mcfg, rcfg, state_r, meta = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, step_ratio=0.25,
        head_topk=None, device=device)
    rcfg = dataclasses.replace(dense_config(rcfg), atlas_dtype=atlas_dtype)
    return cfg, params, mcfg, rcfg, state_r, meta


def render_chunk(ckpt, scene, device="cuda", frame: int = 0,
                 n_rays: int = CHUNK):
    """The density kernel's inputs for the first chunk of ``run_dense``'s
    render: (dense pre-activation density grid [gx,gy,gz], softplus shift,
    the [n_rays * n_samples, 3] normalized coordinates of the first
    ``n_rays`` rays of val frame ``frame``, exactly as ``render_rays`` passes
    them to ``sample_density_brick``). The atlas is
    ``ops/fused_grid.py::build_brick_atlas`` of the grid."""
    dev = resolve_device(device)
    _, params, mcfg, rcfg, state_r, _ = load_dense(ckpt, scene, dev)
    rays = scene.val_frames[frame].rays.astype(np.float32)[:n_rays]
    with torch.no_grad():
        xyz, _, _ = sample_points_in_box(torch.from_numpy(rays).to(dev),
                                         state_r, rcfg.n_samples)
        xyz_n = normalize_coordinates(state_r, xyz).reshape(-1, 3)
        return build_dense_density(params), mcfg.splus_density_shift, xyz_n


def run_dense(ckpt, scene, device="cuda", bandwidth: float = BANDWIDTH,
              chunk: int = CHUNK, atlas_dtype: str = "float32") -> dict:
    """Dense render of ``scene``'s val frames from checkpoint ``ckpt``, with
    a density atlas of ``atlas_dtype``, then clustering and PQ^scene.
    Returns the per-frame maps, the scores and the seconds each stage
    took."""
    cfg, params, mcfg, rcfg, state_r, meta = load_dense(ckpt, scene, device,
                                                        atlas_dtype)
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


def guardrail_messages(caught) -> list:
    """The messages of the guardrail warnings among ``caught`` (the warnings
    ``render_frames`` raises, not those of the libraries it calls)."""
    here = Path(render_frames_report.__code__.co_filename)
    return [str(w.message) for w in caught if Path(w.filename) == here]


def guardrail(message: str) -> str:
    """Which guardrail a warning message names: its text before the colon
    (the rest quotes the guardrail's value)."""
    return message.split(":")[0]


def production_config(rcfg):
    """The gate's production point (``tools/pq_fidelity_gate.py
    --head_topk 8 --k2 8``): top-8 heads, the semantic and instance heads on
    the same 8 samples, bf16 heads."""
    return dataclasses.replace(rcfg, head_topk=8, head_topk_semins=8,
                               head_dtype="bfloat16")


def load_production(ckpt, scene, device="cuda"):
    """(cfg, params, model config, production render config, render state,
    meta) of checkpoint ``ckpt`` for ``scene``, at the gate's step_ratio
    0.25."""
    cfg = e2e_config(scene.image_dim)
    params, mcfg, rcfg, state_r, meta = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, step_ratio=0.25, head_topk=8,
        device=device)
    return cfg, params, mcfg, production_config(rcfg), state_r, meta


def production_chunk(ckpt, scene, device="cuda", frame: int = 0,
                     n_rays: int = PRODUCTION_CHUNK):
    """The density kernel's inputs for pass A of the first chunk of
    ``run_production``'s render of val frame ``frame``: (dense pre-activation
    density grid, softplus shift, the [n_rays * term_first * sub_stride, 3]
    normalized coordinates exactly as ``_fine_density`` passes them to
    ``sample_density_brick``, out-of-box ones included). The budgets are
    calibrated as ``render_frames`` calibrates them. ``n_rays`` is at most the
    frame's ray count."""
    dev = resolve_device(device)
    _, params, mcfg, rcfg, state_r, _ = load_production(ckpt, scene, dev)
    rays = scene.val_frames[frame].rays.astype(np.float32)[:n_rays]
    with torch.no_grad():
        rcfg, fused = prepare_render(params, mcfg, rcfg, state_r,
                                     scene.val_frames)
        o, d, t_min = R._ray_tmin(state_r, torch.from_numpy(rays).to(dev))
        fine_steps, valid, _ = R._select_subsegments(mcfg, rcfg, state_r, o,
                                                     d, t_min, fused)
        k = rcfg.term_first if 0 < rcfg.term_first < fine_steps.shape[1] else None
        _, _, xyz_n = R.fine_positions(state_r, o, d, t_min,
                                       fine_steps[:, :k], valid[:, :k])
        return (build_dense_density(params), mcfg.splus_density_shift,
                xyz_n.reshape(-1, 3))


def run_production(ckpt, scene, device="cuda", bandwidth: float = BANDWIDTH,
                   chunk: int = PRODUCTION_CHUNK) -> dict:
    """The production render of ``scene``'s val frames from checkpoint
    ``ckpt`` (``render_frames`` with its defaults at ``production_config``),
    then clustering and PQ^scene. Returns the maps, the scores, the render
    config the chunks used (``rcfg``; its ``BUDGET_FIELDS`` are the
    calibrated ones), the guardrail maxima, the guardrail warnings raised and
    the seconds each stage took."""
    cfg, params, mcfg, rcfg, state_r, meta = load_production(ckpt, scene,
                                                             device)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = render_frames_report(params, mcfg, rcfg, state_r,
                                   scene.val_frames, chunk=chunk,
                                   device=device)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    onehot = cluster_maps(rep.maps, scene, bandwidth, cfg.max_instances,
                          device)
    t_cluster = time.perf_counter() - t0
    pq, sq, rq, pq_m = pq_for(rep.maps, onehot, scene, cfg.max_instances)
    return {"maps": rep.maps, "pq_scene": pq, "pq_masked": pq_m, "sq": sq,
            "rq": rq, "rcfg": rep.rcfg, "budget_tail": rep.budget_tail,
            "head_tail": rep.head_tail,
            "warnings": guardrail_messages(caught),
            "n_samples": rcfg.n_samples, "grid_dim": tuple(meta["grid_dim"]),
            "render_seconds": t_render, "cluster_seconds": t_cluster}
