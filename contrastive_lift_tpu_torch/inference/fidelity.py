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
numbers. ``run_production(option=)`` renders the production point with one
render option of ``OPTIONS`` (the L1 cascade, no termination, iter or rank
head selection, head dedup, span gathers, baked heads). ``render_chunk``
and ``production_chunk`` give the density kernel's inputs for one chunk of
each render, for timing the kernel on the render's own samples.

``write_mos_scene`` and ``cli_run_dir`` lay r5b's synthetic scene and
checkpoint out as files, so that the render and evaluate CLIs read them as
a user's run: the scene in the MOS layout (PNG colour, npy labels,
``metadata.json`` cameras), and a run directory whose ``config.json`` is
r5b's with the scene as its dataset. ``cli_chunk`` gives the density
kernel's inputs for the first chunk of that CLI render.

``write_raw_scannet`` writes a raw ScanNet capture at ScanNet's own sizes
from a seed, ``run_preprocess`` runs the port's ``preprocess_scannet`` on
it, ``check_preprocess`` holds the tree and the port's reader to the
golden's digests (``file_digest``, ``reader_record``), and
``train_preprocessed`` and ``render_preprocessed`` train and render on
the result, as a user would after preprocessing. ``check_codecs`` holds
the port's JPEG decoder, its PanopLi frame loader and its grey conversion
to the codec golden (one file of each JPEG kind PIL reads, with PIL's
pixels) and times each decode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ..config import Config, load_config
from ..data.synthetic import _look_at, make_synthetic_scene
from ..metrics.panoptic_quality import panoptic_quality
from ..ops.fused_grid import build_dense_density
from ..renderer import render as R
from ..renderer.render import normalize_coordinates, sample_points_in_box
from ..utils.device import resolve_device
from ..utils.png import write_png
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
# the render CLI's arguments for r5b's scene: its frame size, the gate's
# chunk (the termination survivors depend on it) and every 4th of the 14 MOS
# test frames (4 frames, 24,576 rays)
CLI_ARGS = ("--image_dim", "64", "96", "--chunk", str(PRODUCTION_CHUNK),
            "--subsample", "4")
# the RenderConfig fields render_frames sets before it renders (grouping,
# L2-only, tail completion, calibrated budgets)
BUDGET_FIELDS = ("max_segments", "max_subsegments", "max_subsegments_light",
                 "term_first", "term_fraction", "head_term_first",
                 "head_term_fraction", "occ_group_l1", "occ_group_l2",
                 "l2_flat_group", "use_l1", "head_tail_complete")
# the opt-in render options, each rendered at the production point with one
# change: (RenderConfig fields set before render_frames, render_frames
# keyword arguments). "l1" is the render CLI's --l1, "no_term" its --no-term
# (on r5b the calibration then picks heavy/light bucketing); "dedup" keeps 6
# unique cells of the 8 head samples; "span" reads 4 atlas rows per
# sub-segment of 8 samples (the least r5b's step admits)
OPTIONS = {
    "l1": ({}, {"l2_only": False}),
    "no_term": ({}, {"termination": False}),
    "iter": ({"head_select": "iter"}, {}),
    "rank": ({"head_select": "rank"}, {}),
    "dedup": ({"head_dedup_cells": 6}, {}),
    "span": ({"fine_span_rows": 4}, {}),
    "baked": ({}, {"bake_heads": True}),
}


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


def load_production(ckpt, scene, device="cuda", cfg=None):
    """(cfg, params, model config, production render config, render state,
    meta) of checkpoint ``ckpt`` for ``scene``, at the gate's step_ratio
    0.25; ``cfg`` (default ``e2e_config``) gives the model's heads."""
    cfg = cfg or e2e_config(scene.image_dim)
    params, mcfg, rcfg, state_r, meta = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, step_ratio=0.25, head_topk=8,
        device=device)
    return cfg, params, mcfg, production_config(rcfg), state_r, meta


def _pass_a_positions(params, mcfg, rcfg, state_r, frames, rays, dev):
    """(dense pre-activation density grid, softplus shift, the pass-A
    normalized coordinates of ``rays`` exactly as ``_fine_density`` passes
    them to ``sample_density_brick``, out-of-box ones included), with the
    budgets ``render_frames`` calibrates on ``frames``."""
    with torch.no_grad():
        rcfg, fused = prepare_render(params, mcfg, rcfg, state_r, frames)
        o, d, t_min = R._ray_tmin(state_r, torch.from_numpy(rays).to(dev))
        fine_steps, valid, _ = R._select_subsegments(mcfg, rcfg, state_r, o,
                                                     d, t_min, fused)
        k = rcfg.term_first if 0 < rcfg.term_first < fine_steps.shape[1] else None
        _, _, xyz_n = R.fine_positions(state_r, o, d, t_min,
                                       fine_steps[:, :k], valid[:, :k])
        return (build_dense_density(params), mcfg.splus_density_shift,
                xyz_n.reshape(-1, 3))


def production_chunk(ckpt, scene, device="cuda", frame: int = 0,
                     n_rays: int = PRODUCTION_CHUNK, option: str = None):
    """The density kernel's inputs for pass A of the first chunk of
    ``run_production``'s render of val frame ``frame`` (with the render
    config changes of ``OPTIONS[option]``): (dense pre-activation density
    grid, softplus shift, the [n_rays * term_first * sub_stride, 3]
    normalized coordinates exactly as ``_fine_density`` passes them to
    ``sample_density_brick``, out-of-box ones included; under the "span"
    option, viewed as [n_rays, term_first, sub_stride, 3], what it passes to
    ``sample_density_brick_span``). The budgets are calibrated as
    ``render_frames`` calibrates them. ``n_rays`` is at most the frame's ray
    count."""
    dev = resolve_device(device)
    _, params, mcfg, rcfg, state_r, _ = load_production(ckpt, scene, dev)
    if option:
        rcfg = dataclasses.replace(rcfg, **OPTIONS[option][0])
    rays = scene.val_frames[frame].rays.astype(np.float32)[:n_rays]
    return _pass_a_positions(params, mcfg, rcfg, state_r, scene.val_frames,
                             rays, dev)


def run_production(ckpt, scene, device="cuda", bandwidth: float = BANDWIDTH,
                   chunk: int = PRODUCTION_CHUNK, option: str = None,
                   cfg=None) -> dict:
    """The production render of ``scene``'s val frames from checkpoint
    ``ckpt`` (``render_frames`` with its defaults at ``production_config``,
    or with the one change of ``OPTIONS[option]``), then clustering and
    PQ^scene; ``cfg`` as in ``load_production``. Returns the maps, the
    scores, the render config the chunks used (``rcfg``; its
    ``BUDGET_FIELDS`` are the calibrated ones), the guardrail maxima, the
    guardrail warnings raised and the seconds each stage took."""
    cfg, params, mcfg, rcfg, state_r, meta = load_production(ckpt, scene,
                                                             device, cfg)
    changes, render_kw = OPTIONS[option] if option else ({}, {})
    rcfg = dataclasses.replace(rcfg, **changes)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = render_frames_report(params, mcfg, rcfg, state_r,
                                   scene.val_frames, chunk=chunk,
                                   device=device, **render_kw)
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


def rotation_to_quaternion(rot) -> np.ndarray:
    """wxyz unit quaternion of a 3x3 rotation matrix (the inverse of
    ``data/mos.py::quaternion_to_rotation``)."""
    m = np.asarray(rot, np.float64)
    trace = np.trace(m)
    if trace > 0:
        s = 2.0 * np.sqrt(trace + 1.0)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = [0.0] * 4
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def write_mos_scene(scene, root) -> Path:
    """All frames of ``scene`` (train, then val) in the MOS layout under
    ``root``: ``color/*.png`` (8-bit RGB), the machine labels and
    confidences as ``detic_semantic``, ``detic_instance`` and
    ``detic_probabilities`` npy, the GT as ``semantic`` / ``instance`` npy,
    and ``metadata.json`` with the intrinsics normalised by the frame size
    and each camera's position and wxyz quaternion in the Blender
    convention (the OpenCV pose times diag(1, -1, -1, 1), which the reader
    undoes)."""
    root = Path(root)
    for sub in ("color", "detic_semantic", "detic_instance",
                "detic_probabilities", "semantic", "instance"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    h, w = scene.image_dim
    frames = scene.train_frames + scene.val_frames
    blender2opencv = np.diag([1.0, -1.0, -1.0, 1.0])
    positions, quaternions = [], []
    for f in frames:
        rgb = np.round(np.clip(f.rgbs, 0, 1) * 255).astype(np.uint8)
        write_png(root / "color" / f"{f.name}.png", rgb.reshape(h, w, 3))
        for sub, value in (("detic_semantic", f.semantics),
                           ("detic_instance", f.instances),
                           ("detic_probabilities", f.confidences),
                           ("semantic", f.gt_semantics),
                           ("instance", f.gt_instances)):
            np.save(root / sub / f"{f.name}.npy", np.asarray(value).reshape(h, w))
        pose = np.asarray(f.cam2normscene, np.float64) @ blender2opencv
        positions.append(pose[:3, 3].tolist())
        quaternions.append(rotation_to_quaternion(pose[:3, :3]).tolist())
    K = np.asarray(frames[0].intrinsics, np.float64).copy()
    K[0] /= w
    K[1] /= h
    meta = {"camera": {"K": K.tolist(), "positions": positions,
                       "quaternions": quaternions}}
    (root / "metadata.json").write_text(json.dumps(meta))
    return root


def cli_run_dir(root, scene_root, overrides=None) -> Path:
    """A run directory under ``root`` as the render CLI reads one:
    ``checkpoints/final.npz`` (a link to r5b's checkpoint) and
    ``config.json``, r5b's configuration with the MOS scene at
    ``scene_root`` as its dataset and ``overrides`` (config fields) set.
    Returns the checkpoint path to pass as ``--ckpt_path``."""
    run = Path(root)
    (run / "checkpoints").mkdir(parents=True, exist_ok=True)
    link = run / "checkpoints" / "final.npz"
    os.symlink(R5B_CKPT, link)
    load_config(R5B_CONFIG, {"dataset_class": "mos",
                             "dataset_root": str(scene_root),
                             **(overrides or {})}).save(run / "config.json")
    return link


def cli_chunk(ckpt, device="cuda", n_rays: int = PRODUCTION_CHUNK):
    """The density kernel's inputs for pass A of the first chunk of the
    render CLI's render with ``CLI_ARGS`` from checkpoint ``ckpt``: the run's
    config, scene and model loaded as the CLI loads them (head_topk
    "auto"), the budgets calibrated on the scene's test frames. Returns
    what ``production_chunk`` returns."""
    from ..cli.render import run_config
    from ..data import load_scene
    dev = resolve_device(device)
    cfg = run_config(ckpt, (int(CLI_ARGS[1]), int(CLI_ARGS[2])),
                     int(CLI_ARGS[CLI_ARGS.index("--subsample") + 1]))
    scene = load_scene(cfg, load_train=False)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg,
        device=dev)
    rays = scene.val_frames[0].rays.astype(np.float32)[:n_rays]
    return _pass_a_positions(params, mcfg, rcfg, state_r, scene.val_frames,
                             rays, dev)


# the CLI runs of the cli_r5b golden: mean-shift (the default) and HDBSCAN
CLI_CLUSTERINGS = {"meanshift": (), "dbscan": ("--use_dbscan",)}
CLI_METRICS = ("iou", "pq_scene", "sq_scene", "rq_scene")
# every 3rd point of the HDBSCAN sample is kept in the golden
HDBSCAN_STRIDE = 3


def hdbscan_sample(thing_features: np.ndarray) -> np.ndarray:
    """The points ``cluster`` hands HDBSCAN for ``thing_features`` (the
    thing pixels' fast features, 3-sigma filtered and rescaled to the unit
    cube, as ``inference/cluster.py::_fit_predict`` does; all of them where
    there are at most 50,000)."""
    features = thing_features[thing_features[:, 0] == -np.inf][:, 1:]
    centmean, centstd = features.mean(axis=0), features.std(axis=0)
    filtered = features[np.all(np.abs(features - centmean) < 3 * centstd,
                               axis=1)]
    bias = filtered.min(axis=0)
    scale = 1.0 / np.maximum(filtered.max(axis=0) - filtered.min(axis=0),
                             1e-12)
    return (filtered - bias) * scale


def labels_match(a, b) -> bool:
    """Whether cluster labels ``a`` and ``b`` agree up to renaming the
    clusters, with noise (-1) in the same places."""
    a, b = np.asarray(a), np.asarray(b)
    if not np.array_equal(a == -1, b == -1):
        return False
    pairs = set(zip(a[a != -1].tolist(), b[b != -1].tolist()))
    return (len(pairs) == len({p[0] for p in pairs})
            == len({p[1] for p in pairs}))


@contextlib.contextmanager
def recorded_budgets(module=R):
    """Inside, every render config ``module.calibrate_budgets`` returns is
    appended to the yielded list (``module``: the port's or the JAX
    package's ``renderer.render``)."""
    real = module.calibrate_budgets
    calibrated = []

    def spy(*args, **kwargs):
        calibrated.append(real(*args, **kwargs))
        return calibrated[-1]

    module.calibrate_budgets = spy
    try:
        yield calibrated
    finally:
        module.calibrate_budgets = real


def budgets_of(rcfg) -> dict:
    """The ``BUDGET_FIELDS`` of a render config."""
    return {f: getattr(rcfg, f) for f in BUDGET_FIELDS}


def run_cli(ckpt, scene_root, out_root, device="cuda",
            clusterings=tuple(CLI_CLUSTERINGS)) -> dict:
    """The render CLI on checkpoint ``ckpt`` (its run's ``config.json``
    names the scene) with ``CLI_ARGS``, once per clustering of
    ``clusterings`` (names of ``CLI_CLUSTERINGS``), each followed by the
    evaluate CLI on the scene at ``scene_root``. Returns per clustering the
    render summary, the evaluate scores, the budgets the render calibrated
    and the artifact tree's directory."""
    from ..cli import evaluate as evaluate_cli
    from ..cli import render as render_cli
    h, w = CLI_ARGS[1:3]
    out = {}
    for name in clusterings:
        extra = CLI_CLUSTERINGS[name]
        with recorded_budgets() as calibrated:
            summary = render_cli.main(
                ["--ckpt_path", str(ckpt), *CLI_ARGS, *extra, "--output_dir",
                 str(Path(out_root) / name), "--device", str(device)])
        scores = evaluate_cli.main(
            ["--root_path", str(scene_root), "--exp_path",
             str(Path(out_root) / name), "--image_size", h, w])
        out[name] = {"summary": summary, "scores": scores,
                     "budgets": budgets_of(calibrated[-1]),
                     "dir": Path(out_root) / name}
    return out


def check_cli(res: dict, golden):
    """What of ``run_cli``'s result ``res`` breaks the bars of the eager
    JAX golden ``golden`` (``testdata/r5b_cli_golden.npz``): calibrated
    budgets equal, pred_semantics equal on at least 99.9% of the pixels,
    instance_features.npy within the bf16-head bar 3e-2 at the golden's
    rays, pred_surrogateid 16-bit, and the evaluate scores within 0.005.
    Returns (the failures, empty when every bar holds; per clustering the
    share of equal semantics and the largest feature difference)."""
    from ..utils.png import read_png
    bad, measured = [], {}
    names = [str(n) for n in golden["frame_names"]]
    for name, run in res.items():
        for field, value in run["budgets"].items():
            if value != golden[f"budget_{field}"].item():
                bad.append(f"{name}: budget {field} {value} != "
                           f"{golden[f'budget_{field}'].item()}")
        sem = np.stack([read_png(run["dir"] / "pred_semantics" / f"{n}.png")
                        for n in names])
        agree = float((sem == golden["pred_semantics"]).mean())
        if agree < 0.999:
            bad.append(f"{name}: pred_semantics agree on {agree:.5f}")
        inst = np.load(run["dir"] / "instance_features.npy")
        err = float(np.abs(inst[golden["ray_index"]]
                           - golden["instance_features"]).max())
        if err > 3e-2:
            bad.append(f"{name}: instance_features differ by {err}")
        measured[name] = {"pred_semantics_agree": agree,
                          "instance_features_max_abs_err": err}
        for n in names:
            if read_png(run["dir"] / "pred_surrogateid" / f"{n}.png").dtype \
                    != np.uint16:
                bad.append(f"{name}: pred_surrogateid/{n}.png is not 16-bit")
        for key in CLI_METRICS:
            want = float(golden[f"{name}_{key}"])
            if not abs(float(run["scores"][key]) - want) <= 0.005:
                bad.append(f"{name}: {key} {run['scores'][key]} vs {want}")
    return bad, measured


def _reference_linear(sd: dict, key: str, layer: dict, gen) -> None:
    """A torch Linear's ``weight`` [out, in] (and ``bias``) at ``key`` in
    the shapes of ``layer`` ({"w": [in, out], "b": [out]}): N(0, 1/in)."""
    din, dout = np.shape(layer["w"])
    sd[f"{key}.weight"] = torch.randn(dout, din, generator=gen) / din ** 0.5
    if "b" in layer:
        sd[f"{key}.bias"] = 0.1 * torch.randn(dout, generator=gen)


def reference_like_state_dict(params, grid_dim, bbox_aabb, seed: int = 0) -> dict:
    """A Lightning ``state_dict`` in the reference's layout whose import
    (``io/torch_import.py::convert_state_dict``) has the shapes of the
    parameter tree ``params`` (any leaves with a shape): plane factors
    [1, C, H, W] and line factors [1, C, L, 1] N(0, 1) (about a tenth
    of the space is opaque at r5b's widths), Sequential
    MLPs with linears at indices 0, 2, 4, ... and the DINO heads' weight-normed
    last layers, all drawn from a ``torch.Generator`` seeded with ``seed``;
    ``renderer.grid_dim`` and ``renderer.bbox_aabb`` as buffers."""
    gen = torch.Generator().manual_seed(seed)
    sd: dict = {}
    mlps = {"appearance_mlp": "render_appearance_mlp.mlp",
            "semantic_mlp": "render_semantic_mlp.mlp",
            "feature_mlp": "render_feature_mlp.mlp"}
    for name in ("density", "appearance", "semantic", "instance", "feature"):
        if name not in params:
            continue
        for i, plane in enumerate(params[name]["planes"]):
            sd[f"model.{name}_plane.{i}"] = torch.randn(
                1, *np.shape(plane), generator=gen)
        for i, line in enumerate(params[name]["lines"]):
            sd[f"model.{name}_line.{i}"] = torch.randn(
                1, *np.shape(line), 1, generator=gen)
        if f"{name}_basis" in params:
            _reference_linear(sd, f"model.{name}_basis_mat",
                              params[f"{name}_basis"], gen)
    for name, key in mlps.items():
        for i, layer in enumerate(params.get(name, {}).get("layers", ())):
            _reference_linear(sd, f"model.{key}.{2 * i}", layer, gen)
    for which, key in (("fast", "mlp"), ("slow", "slow_mlp")):
        layers = params.get("instance_mlp", {}).get(which, {}).get("layers", ())
        for i, layer in enumerate(layers):
            _reference_linear(sd, f"model.render_instance_mlp.{key}.{2 * i}",
                              layer, gen)
    for which in params.get("proj", {}):
        head = params["proj"][which]
        prefix = f"model.proj_layer.{which}_proj"
        _reference_linear(sd, f"{prefix}.mlp", head["mlp"], gen)
        din, dout = np.shape(head["last_v"])
        sd[f"{prefix}.last_layer.weight_v"] = torch.randn(dout, din,
                                                          generator=gen)
    sd["renderer.bbox_aabb"] = torch.tensor(np.asarray(bbox_aabb, np.float32))
    sd["renderer.grid_dim"] = torch.tensor([int(g) for g in grid_dim])
    return sd


# ---------------------------------------------------------------------------
# The tools of slice 3a on r5b's scene laid out as files (phase tools_r5b)
# ---------------------------------------------------------------------------

# find_bandwidth and extract_centroids render every 18th of the MOS scene's
# 54 train frames (3 frames, 18,432 rays); the tools' run directory renders
# every 4th test frame (its config's subsample_frames, which
# visualize_bboxes reads), as CLI_ARGS does
TOOLS_SUBSAMPLE = 18
TOOLS_RUN_OVERRIDES = {"subsample_frames": 4}
TOOLS_ARGS = ("--image_dim", "64", "96", "--chunk", str(PRODUCTION_CHUNK))
BOX_RUN_METHODS = ("mbr", "aabb")
# the legacy CLI's trajectory: a spherical orbit of 4 poses
TRAJECTORY_FRAMES = 4
# the edits render every 12th ray of the first test frame (512 rays) with
# the mbr box of the largest volume, moved by this translation and rotation
# about z (duplicate, manipulate)
EDIT_RAY_STRIDE = 12
EDIT_KINDS = ("delete", "extract", "duplicate", "manipulate")
EDIT_TRANSLATION = (0.1, 0.05, 0.0)
EDIT_ROTATION_DEG = 30.0
# every 8th back-projected point of the mbr run, with its instance id
BOX_POINT_STRIDE = 8
IMPORT_SEED = 0
# the bars: find_bandwidth PQ, the boxes (a share of the checkpoint AABB's
# largest extent), the edits' maps, the legacy PNGs' shares of equal pixels
TOOLS_PQ_TOL = 0.005
BOX_TOL = 1e-2
EDIT_TOL = 1e-4
CENTROID_TOL = 3e-2
LEGACY_SEMANTICS_AGREE = 0.999
LEGACY_SURROGATE_AGREE = 0.99


def edit_rotation() -> np.ndarray:
    """The edits' rotation about z, float32."""
    t = np.deg2rad(EDIT_ROTATION_DEG)
    return np.array([[np.cos(t), -np.sin(t), 0.0], [np.sin(t), np.cos(t), 0.0],
                     [0.0, 0.0, 1.0]], np.float32)


def box_arrays(boxes: dict) -> dict:
    """{id: {position, extent, orientation}} (``instance_bounding_boxes``,
    or ``boxes.json`` read back) as arrays in increasing id order."""
    boxes = {int(k): v for k, v in boxes.items()}
    ids = sorted(boxes)
    return {"ids": np.asarray(ids, np.int64),
            **{f: np.asarray([boxes[k][f] for k in ids], np.float64).reshape(
                len(ids), *((3, 3) if f == "orientation" else (3,)))
               for f in ("position", "extent", "orientation")}}


def boxes_match(got: dict, want: dict, tol: float) -> tuple:
    """(whether the boxes ``got`` and ``want`` (``box_arrays``) match: as
    many boxes, and paired up to a permutation of their ids by nearest
    positions, every position and extent within ``tol``; the largest
    difference)."""
    from scipy.optimize import linear_sum_assignment
    if len(got["ids"]) != len(want["ids"]):
        return False, float("inf")
    if not len(want["ids"]):
        return True, 0.0
    cost = np.linalg.norm(got["position"][:, None] - want["position"][None],
                          axis=-1)
    rows, cols = linear_sum_assignment(cost)
    err = max(float(np.abs(got[f][rows] - want[f][cols]).max())
              for f in ("position", "extent"))
    return err <= tol, err


def tools_run_dir(root, scene_root) -> Path:
    """``cli_run_dir`` with ``TOOLS_RUN_OVERRIDES``."""
    return cli_run_dir(root, scene_root, TOOLS_RUN_OVERRIDES)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_tools(ckpt, scene_root, out_root, device="cuda") -> dict:
    """The port's tools as a user runs them on the run of ``ckpt``
    (``tools_run_dir``): find_bandwidth on every ``TOOLS_SUBSAMPLE``-th train
    frame, extract_centroids at its best bandwidth, the render CLI with
    those centroids (``CLI_ARGS``) scored by the evaluate CLI,
    visualize_bboxes with each of ``BOX_RUN_METHODS``, and render_legacy on
    every 4th test frame and on a ``TRAJECTORY_FRAMES``-pose orbit. Returns
    per tool what it returned or wrote, its host seconds and its rays."""
    from ..cli import evaluate as evaluate_cli
    from ..cli import extract_centroids as extract_cli
    from ..cli import find_bandwidth as bandwidth_cli
    from ..cli import render as render_cli
    from ..cli import render_legacy as legacy_cli
    from ..cli import visualize_bboxes as bboxes_cli
    out_root = Path(out_root)
    common = ["--ckpt_path", str(ckpt), *TOOLS_ARGS, "--device", str(device)]
    h, w = (int(x) for x in TOOLS_ARGS[1:3])
    res = {}
    bw, sec = _timed(lambda: bandwidth_cli.main(
        common + ["--subsample", str(TOOLS_SUBSAMPLE), "--output_dir",
                  str(out_root / "bandwidth")]))
    feats = np.load(out_root / "bandwidth" / "all_thing_features_train.npy")
    res["find_bandwidth"] = {"result": bw, "seconds": sec, "rays": len(feats),
                             "thing_points": int((feats[:, 0] == -np.inf)
                                                 .sum())}
    pkl = out_root / "all_centroids.pkl"
    cents, sec = _timed(lambda: extract_cli.main(
        common + ["--subsample", str(TOOLS_SUBSAMPLE), "--bandwidth",
                  repr(bw["best_value"]), "--output_path", str(pkl)]))
    res["extract_centroids"] = {"centroids": cents, "seconds": sec,
                                "rays": len(feats)}
    with recorded_budgets() as calibrated:
        summary, sec = _timed(lambda: render_cli.main(
            ["--ckpt_path", str(ckpt), *CLI_ARGS, "--cached_centroids_path",
             str(pkl), "--output_dir", str(out_root / "cached"), "--device",
             str(device)]))
    scores = evaluate_cli.main(["--root_path", str(scene_root), "--exp_path",
                                str(out_root / "cached"), "--image_size",
                                str(h), str(w)])
    res["render_cached"] = {"summary": summary, "scores": scores,
                            "budgets": budgets_of(calibrated[-1]),
                            "dir": out_root / "cached", "seconds": sec,
                            "rays": summary["num_frames"] * h * w}
    for method in BOX_RUN_METHODS:
        boxes, sec = _timed(lambda: bboxes_cli.main(
            common + ["--method", method, "--output_dir",
                      str(out_root / f"boxes_{method}")]))
        # one OBJ vertex per rendered ray
        n = len((out_root / f"boxes_{method}" / "points.obj").read_text()
                .splitlines())
        res[f"visualize_bboxes_{method}"] = {"boxes": box_arrays(boxes),
                                             "seconds": sec, "rays": n}
    for tag, extra in (("test", ["--subsample", str(TOOLS_RUN_OVERRIDES[
            "subsample_frames"])]), ("trajectory", [
            "--render_trajectory", "--trajectory_frames",
            str(TRAJECTORY_FRAMES)])):
        with recorded_budgets() as calibrated:
            summary, sec = _timed(lambda: legacy_cli.main(
                common + extra + ["--output_dir",
                                  str(out_root / f"legacy_{tag}")]))
        res[f"render_legacy_{tag}"] = {
            "summary": summary, "budgets": budgets_of(calibrated[-1]),
            "dir": out_root / f"legacy_{tag}", "seconds": sec,
            "rays": summary["num_frames"] * h * w}
    return res


def tools_model(ckpt, device="cuda"):
    """(params, mcfg, rcfg, state, scene's test frames) of the tools' run of
    ``ckpt``, loaded as the render CLI loads it with ``CLI_ARGS``."""
    from ..cli.render import run_config
    from ..data import load_scene
    cfg = run_config(ckpt, (int(CLI_ARGS[1]), int(CLI_ARGS[2])),
                     int(CLI_ARGS[CLI_ARGS.index("--subsample") + 1]))
    scene = load_scene(cfg, load_train=False)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg,
        device=device)
    return params, mcfg, rcfg, state_r, scene.val_frames


def edit_box(golden) -> dict:
    return {f: golden[f"edit_{f}"] for f in ("extent", "position",
                                             "orientation")}


def run_edits(ckpt, golden, device="cuda", rows=None) -> dict:
    """``renderer/editing.py::render_edited`` with each of ``EDIT_KINDS`` on
    the golden's rays (``rows`` of them, default all) and box, on the
    model of ``ckpt``. Returns per edit the maps (numpy), the host seconds,
    and per ray the compositing weight of the samples inside the box and
    outside it and the depth, in the edited and in the unedited field
    (``edited_weights``)."""
    from ..renderer.editing import (edited_weights, points_in_oriented_box,
                                    render_edited)
    dev = resolve_device(device)
    params, mcfg, rcfg, state_r, _ = tools_model(ckpt, dev)
    rays_np = golden["edit_rays"] if rows is None else golden["edit_rays"][rows]
    rays = torch.from_numpy(np.ascontiguousarray(rays_np)).to(dev)
    box = edit_box(golden)
    move = {"translation": golden["edit_translation"],
            "rotation": golden["edit_rotation"]}
    with torch.no_grad():
        xyz, _, _ = sample_points_in_box(rays, state_r, rcfg.n_samples)
        inside = points_in_oriented_box(
            xyz.reshape(-1, 3), box["extent"], box["position"],
            box["orientation"]).reshape(xyz.shape[:2])

    def masses(kind, kw):
        with torch.no_grad():
            _, _, w, z_vals = edited_weights(params, mcfg, rcfg, state_r,
                                             rays, kind, box, **kw)
        return tuple(t.cpu().numpy() for t in (
            torch.where(inside, w, 0.0).sum(-1),
            torch.where(inside, 0.0, w).sum(-1), (w * z_vals).sum(-1)))

    base = masses(None, {})
    out = {}
    for kind in EDIT_KINDS:
        kw = move if kind in ("duplicate", "manipulate") else {}
        # timed to the maps on the host: the copy waits for the device
        maps, sec = _timed(lambda: {k: v.cpu().numpy() for k, v in
                                    render_edited(params, mcfg, rcfg, state_r,
                                                  rays, kind, box, device=dev,
                                                  **kw).items()})
        out[kind] = {"maps": maps, "seconds": sec, "rays": len(rays_np),
                     "mass": masses(kind, kw), "base_mass": base}
    return out


def check_edits(edits: dict, golden, rows=None):
    """(failures, largest map difference per edit) of ``run_edits`` against
    the golden: maps within ``EDIT_TOL`` (the semantics on rays whose
    opacity reaches 1e-4: below, the 1e-8 of the softmax normalisation
    competes with the weights). Delete leaves no weight inside the box and
    extract none outside it, where the unedited field had some; delete
    keeps the rays that miss the box as they were; duplicate and manipulate
    move the depth of some ray."""
    bad, measured = [], {}
    for kind, run in edits.items():
        (w_in, w_out, depth), (b_in, b_out, b_depth) = (run["mass"],
                                                        run["base_mass"])
        lit = w_in + w_out >= 1e-4
        errs = {}
        for key, value in run["maps"].items():
            want = golden[f"edit_{kind}_{key}"]
            want = want if rows is None else want[rows]
            if key == "semantics":
                value, want = value[lit], want[lit]
            errs[key] = float(np.abs(value - want).max()) if value.size else 0.0
            if not errs[key] <= EDIT_TOL:
                bad.append(f"edit {kind}: {key} differs by {errs[key]}")
        measured[kind] = errs
        if kind == "delete":
            misses = b_in == 0
            if not ((b_in > 1e-3).any() and (w_in == 0).all()
                    and (w_out[misses] == b_out[misses]).all()):
                bad.append("edit delete: weight left inside the box, none "
                           "there to delete, or a ray missing it changed")
        if kind == "extract" and not ((b_out > 1e-3).any()
                                      and (w_out == 0).all()):
            bad.append("edit extract: weight left outside the box, or none "
                       "there to remove")
        if kind in ("duplicate", "manipulate") and not (
                np.abs(depth - b_depth) > 1e-3).any():
            bad.append(f"edit {kind}: no ray's depth changed")
    return bad, measured


def run_import(out_root, device="cuda") -> dict:
    """A reference-layout Lightning checkpoint at r5b's widths, drawn from
    ``IMPORT_SEED`` (``reference_like_state_dict``), saved with
    ``torch.save``, converted by ``io/torch_import.py``'s CLI, loaded with
    r5b's config and its first val frame rendered on the production path.
    Returns the maps, the converter's summary and the seconds."""
    from ..io.checkpoint import load_checkpoint
    from ..io.torch_import import main as import_main
    out_root = Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    params, meta = load_checkpoint(R5B_CKPT)
    sd = reference_like_state_dict(params, meta["grid_dim"],
                                   meta["bbox_aabb"], IMPORT_SEED)
    torch.save({"state_dict": sd, "epoch": 0, "global_step": 0},
               out_root / "reference.ckpt")
    info = import_main(["--ckpt_path", str(out_root / "reference.ckpt"),
                        "--output_path", str(out_root / "imported.npz")])
    import_seconds = time.perf_counter() - t0
    cfg = load_config(R5B_CONFIG)
    scene = e2e_scene(*R5B_SCENE)
    model = load_model_for_inference(out_root / "imported.npz", cfg,
                                     scene.num_semantic_classes,
                                     device=device)[:4]
    maps, sec = _timed(lambda: render_frames(
        *model, scene.val_frames[:1], chunk=PRODUCTION_CHUNK, device=device))
    return {"maps": maps[0], "info": info, "import_seconds": import_seconds,
            "seconds": sec, "rays": len(scene.val_frames[0].rays)}


def _agree(run_dir: Path, names, sub: str, want) -> float:
    from ..utils.png import read_png
    got = np.stack([read_png(run_dir / sub / f"{n}.png") for n in names])
    return float((got == want).mean())


def check_tools(res: dict, golden):
    """What of ``run_tools``'s result ``res`` breaks the bars of the eager
    JAX golden (``testdata/r5b_tools_golden.npz``). Returns (the failures,
    the measured differences)."""
    bad, measured = [], {}
    # find_bandwidth: the reference's 50-value grid, PQ within 0.005, the
    # same best value (or, where the golden's curve holds another value
    # within 0.005 of its top, a best PQ within 0.005 of the golden's)
    bw = res["find_bandwidth"]["result"]
    values = np.asarray([v for v, _ in bw["curve"]])
    pqs = np.asarray([p for _, p in bw["curve"]])
    gv, gp = golden["bw_values"], golden["bw_pq"]
    measured["bandwidth_curve"] = len(values)
    if len(values) < len(gv):
        bad.append(f"find_bandwidth: curve of {len(values)} values, the "
                   f"golden's {len(gv)}")
    elif len(values) != len(gv) or not np.allclose(values, gv, rtol=0,
                                                   atol=1e-12):
        bad.append("find_bandwidth: the curve's values differ")
    else:
        err = float(np.abs(pqs - gp).max())
        measured["bandwidth_pq_max_abs_err"] = err
        if err > TOOLS_PQ_TOL:
            bad.append(f"find_bandwidth: PQ differs by {err}")
    best = float(golden["bw_best_value"])
    near_top = int((gp >= float(golden["bw_best_pq"]) - TOOLS_PQ_TOL).sum())
    if bw["best_value"] != best and not (
            near_top > 1 and abs(bw["best_pq"] - float(golden["bw_best_pq"]))
            <= TOOLS_PQ_TOL):
        bad.append(f"find_bandwidth: best value {bw['best_value']} vs "
                   f"{best}")
    # centroids: per class the same count, each within 3e-2 of its nearest
    # golden centroid
    cents = res["extract_centroids"]["centroids"]
    classes = [int(c) for c in golden["centroid_classes"]]
    if sorted(cents) != classes:
        bad.append(f"extract_centroids: classes {sorted(cents)} vs {classes}")
    for c in classes:
        got, want = np.asarray(cents.get(c, np.zeros((0, 3)))), \
            golden[f"centroids_{c}"]
        if len(got) != len(want):
            bad.append(f"extract_centroids: class {c} has {len(got)} "
                       f"centroids, the golden {len(want)}")
            continue
        err = float(np.abs(got[:, None] - want[None]).max(-1).min(1).max())
        measured[f"centroids_{c}_max_abs_err"] = err
        if err > CENTROID_TOL:
            bad.append(f"extract_centroids: class {c} off by {err}")
    # the render CLI with the cached centroids
    run = res["render_cached"]
    for field, value in run["budgets"].items():
        if value != golden[f"cached_budget_{field}"].item():
            bad.append(f"render_cached: budget {field} {value} != "
                       f"{golden[f'cached_budget_{field}'].item()}")
    names = [str(n) for n in golden["test_names"]]
    agree = _agree(run["dir"], names, "pred_semantics",
                   golden["cached_pred_semantics"])
    measured["cached_pred_semantics_agree"] = agree
    if agree < 0.999:
        bad.append(f"render_cached: pred_semantics agree on {agree:.5f}")
    for key in CLI_METRICS:
        want = float(golden[f"cached_{key}"])
        if not abs(float(run["scores"][key]) - want) <= TOOLS_PQ_TOL:
            bad.append(f"render_cached: {key} {run['scores'][key]} vs {want}")
    # the boxes, up to a permutation of the ids
    tol = BOX_TOL * float(golden["aabb_extent"])
    for method in BOX_RUN_METHODS:
        want = {f: golden[f"boxes_{method}_{f}"] for f in
                ("ids", "position", "extent", "orientation")}
        ok, err = boxes_match(res[f"visualize_bboxes_{method}"]["boxes"],
                              want, tol)
        measured[f"boxes_{method}_max_abs_err"] = err
        if not ok:
            bad.append(f"visualize_bboxes {method}: "
                       f"{len(res[f'visualize_bboxes_{method}']['boxes']['ids'])}"
                       f" boxes vs {len(want['ids'])}, largest difference "
                       f"{err} (bar {tol})")
    # the legacy PNGs
    for tag in ("test", "trajectory"):
        run = res[f"render_legacy_{tag}"]
        names = [str(n) for n in golden[f"legacy_{tag}_names"]]
        sem = _agree(run["dir"], names, "pred_semantics",
                     golden[f"legacy_{tag}_semantics"])
        sur = _agree(run["dir"], names, "pred_surrogateid",
                     golden[f"legacy_{tag}_surrogate"])
        measured[f"legacy_{tag}_semantics_agree"] = sem
        measured[f"legacy_{tag}_surrogate_mismatch"] = 1.0 - sur
        if sem < LEGACY_SEMANTICS_AGREE or sur < LEGACY_SURROGATE_AGREE:
            bad.append(f"render_legacy {tag}: semantics agree on {sem:.5f}, "
                       f"surrogate ids on {sur:.5f}")
    return bad, measured


# ---------------------------------------------------------------------------
# the data-parallel phase (ddp_r5b)
# ---------------------------------------------------------------------------

# r5b's widths and batch sizes, but for its instance images, which must
# split over the ranks (r5b's one image cannot; the JAX Trainer refuses it)
DDP_OVERRIDES = {"batch_size_contrastive": 2}
DDP_STEPS = 3
DDP_BATCH_SEED = 1
# the sharded render computes each chunk as the unsharded one does
DDP_MAP_TOL = 1e-6
# Sharded against unsharded on the card, 3 steps: every main-phase metric
# of two unsharded runs is bitwise equal, while half batches give other
# sums (metrics 1.2e-4 relative, sketches after the steps 1.2e-5, of the
# change 2.3e-2). Counting TV on every rank moves them to 7.9e-4, 1.7e-4
# and 4.2e-2; the bars lie between (PERF.md, ddp_r5b).
DDP_METRIC_RTOL = 4e-4
DDP_SKETCH_TOL = {"sketch_after": 5e-5, "sketch_delta": 3.5e-2}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ddp_r5b(device="cuda", steps: int = DDP_STEPS, backend=None) -> dict:
    """What each rank of the data-parallel check runs, and one process for
    the unsharded run it is held to: r5b resumed from ``final.npz`` with its
    optimizer state and ``DDP_OVERRIDES``, the head budget calibrated (and
    agreed), ``steps`` steps on the batches of ``DDP_BATCH_SEED``'s sampler
    stream (each rank keeping its rows) with the draws of a generator on the
    device seeded by the config's seed, TF32 off; then ``render_frames`` of
    r5b's val frames at the production point in 4,096-ray chunks. On a
    rank of a launch the step and the render are sharded (``backend``: the
    group's, e.g. "gloo" for ranks sharing one card). Returns the metrics
    and host seconds of each step, the all-reduce bytes of each step and
    the milliseconds of one all-reduce of that many bytes, the sketches of
    every parameter leaf after the steps and of its change, every rank's
    digest of its parameters and optimizer state, and the render's maps,
    config, guardrail maxima, seconds and every rank's density-kernel
    launches."""
    from ..ops import brick_interp as bi
    from ..parallel import mesh as pmesh
    from ..parallel.dryrun import replica_digests
    from ..train import resume
    from ..train.loop import calibrate_aux_topk
    from ..train.step import make_train_step
    from ..utils.tree import tree_leaves_with_path

    mesh = (pmesh.make_mesh(device=device, backend=backend)
            if pmesh.launched() else None)
    dev = resolve_device(device) if mesh is None else mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = e2e_scene(*R5B_SCENE)
    cfg = load_config(R5B_CONFIG, dict(DDP_OVERRIDES))
    setup = resume.restore_training(R5B_CKPT, cfg, scene, dev)
    state = setup.state
    if mesh is not None:
        pmesh.replicate_tree(mesh, state)
    k = calibrate_aux_topk(cfg, state.params, setup.mcfg, setup.rcfg,
                           setup.state_r, setup.gates, setup.epoch,
                           setup.samplers[0])
    if mesh is not None:
        k = pmesh.agree(mesh, k, "the head budget")
    step = make_train_step(cfg, setup.mcfg, setup.rcfg, setup.gates,
                           setup.class_weights, state.params,
                           aux_head_topk=k, mesh=mesh)
    before = {p: t.clone() for p, t in tree_leaves_with_path(state.params)}
    rng = np.random.default_rng(DDP_BATCH_SEED)
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed or 0))
    metrics, seconds, reduced = [], [], []
    for _ in range(steps):
        batches = resume.step_batches(setup, rng)
        if mesh is not None:
            batches = [None if b is None else pmesh.shard_main_batch(mesh, b)
                       for b in batches]
        sent = mesh.all_reduce_bytes if mesh is not None else 0
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, setup.state_r, *batches, gen, setup.lr_scale,
                        setup.lambda_dist_reg)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        metrics.append({name: float(v) for name, v in m.items()})
        reduced.append((mesh.all_reduce_bytes - sent)
                       if mesh is not None else 0)
    after = tree_leaves_with_path(state.params)
    sketches = [resume.leaf_sketches(i, t, t - before[p])
                for i, (p, t) in enumerate(after)]
    allreduce_ms = None
    if mesh is not None:
        buf = torch.zeros(reduced[-1] // 4, device=dev)
        pmesh.all_reduce_(mesh, buf)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            pmesh.all_reduce_(mesh, buf)
        _sync(dev)
        allreduce_ms = (time.perf_counter() - t0) / 5 * 1e3

    _, params, mcfg, rcfg, state_r, _ = load_production(R5B_CKPT, scene, dev)
    bi.reset_launches()
    t0 = time.perf_counter()
    rep = render_frames_report(params, mcfg, rcfg, state_r, scene.val_frames,
                               chunk=PRODUCTION_CHUNK, mesh=mesh, device=dev)
    _sync(dev)
    render_s = time.perf_counter() - t0
    launches = [{w.__name__: dict(w.dtype_launches) for w in bi.KERNELS}]
    if mesh is not None:
        launches = [None] * mesh.size
        torch.distributed.all_gather_object(
            launches, {w.__name__: dict(w.dtype_launches) for w in bi.KERNELS},
            group=mesh.host_group)
    return {"aux_head_topk": k, "metrics": metrics, "step_seconds": seconds,
            "all_reduce_bytes": reduced, "all_reduce_ms": allreduce_ms,
            "ranks": 1 if mesh is None else mesh.size,
            "leaf_paths": [str(p) for p, _ in after],
            "sketch_after": np.stack([s[0] for s in sketches]),
            "sketch_delta": np.stack([s[1] for s in sketches]),
            "param_digests": replica_digests(mesh, state.params),
            "opt_digests": replica_digests(
                mesh, (state.opt_state_main, state.opt_state_inst)),
            "maps": rep.maps, "rcfg": rep.rcfg,
            "budget_tail": rep.budget_tail, "head_tail": rep.head_tail,
            "render_seconds": render_s, "launches": launches}


def check_ddp(sharded: dict, unsharded: dict) -> tuple:
    """(failures, measured) of a sharded ``ddp_r5b`` run against the
    unsharded one: the head budget equal; every metric of every step within
    ``DDP_METRIC_RTOL`` (guardrails also 1e-6 absolute); each leaf's
    sketches after the steps and of its change within ``DDP_SKETCH_TOL``;
    the replicas' parameters and optimizer state bitwise equal; the
    render's budgets equal and maps within ``DDP_MAP_TOL``; a float32
    density-kernel launch on every rank."""
    from ..train import resume
    bad, measured = [], {}
    if sharded["aux_head_topk"] != unsharded["aux_head_topk"]:
        bad.append(f"aux_head_topk {sharded['aux_head_topk']} != "
                   f"{unsharded['aux_head_topk']}")
    rel = {}
    for i, (got, want) in enumerate(zip(sharded["metrics"],
                                        unsharded["metrics"])):
        if set(got) != set(want):
            bad.append(f"step {i}: metrics {sorted(got)} vs {sorted(want)}")
        for name, value in want.items():
            atol = resume.GUARDRAIL_ATOL if name.endswith("_tail") else 0.0
            err = abs(got.get(name, np.nan) - value)
            rel[name] = max(rel.get(name, 0.0),
                            err / max(abs(value), 1e-30))
            if not err <= DDP_METRIC_RTOL * abs(value) + atol:
                bad.append(f"step {i} {name} {got.get(name)} vs {value}")
    measured["metric_max_rel_err"] = max(
        v for k, v in rel.items() if not k.endswith("_tail"))
    measured["metric_rel_err"] = rel
    for name in ("sketch_after", "sketch_delta"):
        errs = [resume.sketch_error(a, b) for a, b in
                zip(sharded[name], unsharded[name])]
        measured[f"{name}_max_err"] = max(errs)
        bad.extend(f"{name} {p} error {e:.3g}" for p, e in
                   zip(sharded["leaf_paths"], errs)
                   if not e <= DDP_SKETCH_TOL[name])
    for key in ("param_digests", "opt_digests"):
        if len(set(sharded[key])) != 1:
            bad.append(f"the ranks' {key} differ: the replicas drifted")
    got = {f: getattr(sharded["rcfg"], f) for f in BUDGET_FIELDS}
    want = {f: getattr(unsharded["rcfg"], f) for f in BUDGET_FIELDS}
    if got != want:
        bad.append(f"sharded render budgets {got} vs unsharded {want}")
    map_err = max(float(np.abs(a[key] - b[key]).max())
                  for a, b in zip(sharded["maps"], unsharded["maps"])
                  for key in ("rgb", "semantics", "instances", "depth"))
    measured["render_max_abs_err"] = map_err
    if not map_err <= DDP_MAP_TOL:
        bad.append(f"sharded render maps differ by {map_err}")
    for rank, counts in enumerate(sharded["launches"]):
        if counts["sample_density_brick"].get("float32", 0) < 1:
            bad.append(f"rank {rank} never launched the float32 "
                       "sample_density_brick kernel")
    return bad, measured


# ---------------------------------------------------------------------------
# r5b with distilled-feature heads grafted on (distilled_r5b)
# ---------------------------------------------------------------------------

# the seed of the grafted branch and heads, and of the feature targets
DISTILLED_SEED = 0
# r5b's configuration with both distilled inputs on and trained through
# (r5b resumes at epoch 29, past the default feature_optimization_end_epoch
# of 5, which would close the feature gate: it is raised to r5b's max_epoch)
DISTILLED_OVERRIDES = {"use_distilled_features_semantic": True,
                       "use_distilled_features_instance": True,
                       "feature_stop_grad": False}
DISTILLED_WIDTH = 64   # the distilled head's output, appended to the heads
DISTILLED_BASIS = 96   # the feature branch's projected width
# the first layers that take the distilled input
DISTILLED_HEAD_INPUTS = (("semantic_mlp",), ("instance_mlp", "fast"),
                         ("instance_mlp", "slow"))


def distilled_config(path=R5B_CONFIG) -> Config:
    """r5b's training configuration with ``DISTILLED_OVERRIDES`` and the
    feature gate open through r5b's last epoch."""
    cfg = load_config(path, DISTILLED_OVERRIDES)
    cfg.feature_optimization_end_epoch = cfg.max_epoch
    return cfg


def distilled_render_config(image_dim) -> Config:
    """The PQ gate's render configuration (``e2e_config``) with the
    distilled heads of ``DISTILLED_OVERRIDES``."""
    return dataclasses.replace(e2e_config(image_dim), **DISTILLED_OVERRIDES)


def _uniform(rng, shape, fan_in: int) -> np.ndarray:
    """``_linear_init``'s U(-1/sqrt(fan_in), 1/sqrt(fan_in)), float32."""
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def graft_distilled(arrays: dict, seed: int = DISTILLED_SEED) -> dict:
    """r5b's parameter tree (numpy, as ``load_checkpoint`` gives it) with
    distilled-feature heads grafted on, every new value drawn by
    ``np.random.default_rng(seed)`` in this order: a ``feature`` VM branch
    at the checkpoint's grid with the appearance branch's component counts
    (planes, then lines, axis by axis; ``_svd_grid_init``'s 0.1 N(0,1)),
    ``feature_basis`` [sum of components, 96], ``feature_mlp`` (96 -> 256 ->
    256 -> 64, weight then bias per layer) at ``_linear_init``'s scale, and
    64 rows appended last to the first layer of ``semantic_mlp`` and of the
    fast and slow ``instance_mlp``, at ``_linear_init``'s scale for the
    widened fan-in (not zero: the heads then depend on the distilled
    input). The input is not modified."""
    from ..ops.grid_sample import MATRIX_MODE, VECTOR_MODE
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    planes0 = arrays["density"]["planes"][0]
    grid = (planes0.shape[2], planes0.shape[1],
            arrays["density"]["lines"][0].shape[1])
    comps = [p.shape[0] for p in arrays["appearance"]["planes"]]
    planes, lines = [], []
    for i in range(3):
        m0, m1 = MATRIX_MODE[i]
        planes.append(0.1 * rng.standard_normal(
            (comps[i], grid[m1], grid[m0]), dtype=np.float32))
        lines.append(0.1 * rng.standard_normal(
            (comps[i], grid[VECTOR_MODE[i]]), dtype=np.float32))
    out["feature"] = {"planes": tuple(planes), "lines": tuple(lines)}
    out["feature_basis"] = {"w": _uniform(rng, (sum(comps), DISTILLED_BASIS),
                                          sum(comps))}
    layers = []
    for din, dout in ((DISTILLED_BASIS, 256), (256, 256),
                      (256, DISTILLED_WIDTH)):
        w = _uniform(rng, (din, dout), din)
        layers.append({"w": w, "b": _uniform(rng, (dout,), din)})
    out["feature_mlp"] = {"layers": layers}
    for path in DISTILLED_HEAD_INPUTS:
        parent = out
        for key in path[:-1]:
            parent[key] = dict(parent[key])
            parent = parent[key]
        mlp = dict(parent[path[-1]])
        first = dict(mlp["layers"][0])
        din = first["w"].shape[0] + DISTILLED_WIDTH
        first["w"] = np.concatenate(
            [first["w"], _uniform(rng, (DISTILLED_WIDTH, first["w"].shape[1]),
                                  din)])
        mlp["layers"] = [first] + list(mlp["layers"][1:])
        parent[path[-1]] = mlp
    return out


def graft_opt_state(cfg, arrays: dict, grafted: dict, opt_leaves):
    """(main, instance) Adam states of the port for ``grafted`` from the
    stored optimizer leaves of ``arrays``: every group keeps its step count
    and its leaves' moments; the new leaves start from zero moments, and a
    widened first layer's moments gain zero rows for its new inputs."""
    from ..io.checkpoint import opt_state_from_leaves
    from ..io.convert import params_from_numpy
    from ..train.state import AdamState, make_optimizers
    from ..utils.tree import tree_leaves_with_path
    old = params_from_numpy(arrays, "cpu")
    new = params_from_numpy(grafted, "cpu")
    main_tx, inst_tx, _ = make_optimizers(cfg, old)
    states = opt_state_from_leaves(main_tx, inst_tx, opt_leaves, old)
    leaves = dict(tree_leaves_with_path(new))
    out = []
    for state, tx in zip(states, make_optimizers(cfg, new)[:2]):
        def grow(moments, label):
            grown = {}
            for path in tx.paths(label):
                z = torch.zeros_like(leaves[path])
                if path in moments:
                    z[tuple(slice(0, n) for n in moments[path].shape)] = \
                        moments[path]
                grown[path] = z
            return grown

        out.append({label: AdamState(state[label].count,
                                     grow(state[label].mu, label),
                                     grow(state[label].nu, label))
                    for label in tx.groups})
    return tuple(out)


def write_distilled_checkpoint(path, seed: int = DISTILLED_SEED,
                               ckpt=R5B_CKPT) -> Path:
    """r5b's checkpoint with ``graft_distilled``'s heads and
    ``graft_opt_state``'s optimizer state, at r5b's grid, AABB, epoch and
    step, written to ``path`` in the checkpoint format both packages
    read."""
    from ..io.checkpoint import load_checkpoint, save_checkpoint
    arrays, meta = load_checkpoint(ckpt)
    grafted = graft_distilled(arrays, seed)
    opt = graft_opt_state(distilled_config(), arrays, grafted,
                          meta["opt_leaves"])
    save_checkpoint(path, grafted, grid_dim=meta["grid_dim"],
                    bbox_aabb=meta["bbox_aabb"], epoch=meta["epoch"],
                    global_step=meta["global_step"],
                    config_dict=dataclasses.asdict(distilled_config()),
                    opt_state=opt)
    return Path(path)


def distilled_targets(scene, seed: int = DISTILLED_SEED):
    """``scene`` with unit-norm 64-d distilled-feature targets on every
    train and then val frame (``feats``, drawn by
    ``np.random.default_rng(seed)``), as the JAX package's
    ``tests/test_variant_paths.py`` attaches them; returns the scene."""
    rng = np.random.default_rng(seed)
    for f in scene.train_frames + scene.val_frames:
        feats = rng.normal(size=(f.rays.shape[0], DISTILLED_WIDTH)).astype(
            np.float32)
        f.feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    return scene


def distilled_chunk(ckpt, scene, device="cuda",
                    n_rays: int = PRODUCTION_CHUNK) -> torch.Tensor:
    """The ``distilled`` map [n_rays, 64] of ``render_rays`` on the first
    ``n_rays`` rays of val frame 0 (the first chunk of ``run_production``'s
    render), on the production grids with the budgets ``render_frames``
    calibrates on ``scene``'s val frames."""
    dev = resolve_device(device)
    _, params, mcfg, rcfg, state_r, _ = load_production(
        ckpt, scene, dev, distilled_render_config(scene.image_dim))
    rays = scene.val_frames[0].rays.astype(np.float32)[:n_rays]
    with torch.no_grad():
        rcfg, fused = prepare_render(params, mcfg, rcfg, state_r,
                                     scene.val_frames)
        return R.render_rays(params, mcfg, rcfg, state_r,
                             torch.from_numpy(rays).to(dev),
                             fused=fused)["distilled"]


# ---------------------------------------------------------------------------
# preprocess_scannet: a raw ScanNet capture at ScanNet's own sizes, through
# data/preprocessing/scannet.py into the layout the PanopLi reader reads
# ---------------------------------------------------------------------------

SCANNET_SEED = 0
SCANNET_FRAMES = 12
SCANNET_COLOR_HW = (968, 1296)
SCANNET_DEPTH_HW = (480, 640)
SCANNET_QUALITY = 90
SCANNET_IMAGE_HW = (480, 640)
# every frame streamed (frame_skip 1), the sharper of each pair kept: 6 of
# 12 frames, split 4 / 2 at the script's test fraction 0.2
SCANNET_KEYFRAME_WINDOW = 2
# ScanNet's colour and depth intrinsics (fx, fy, cx, cy)
SCANNET_COLOR_K = (1170.187988, 1170.187988, 647.75, 483.75)
SCANNET_DEPTH_K = (571.623718, 571.623718, 319.5, 239.5)
# raw ScanNet label ids (two above 255) -> the script's reduced classes
SCANNET_RAW_TO_REDUCED = {1: 1, 2: 2, 22: 3, 5: 4, 7: 5, 6: 6, 157: 7, 3: 8,
                          300: 9, 1163: 15}
# the label layout: a grid of cells, each one object, that slides with the
# camera; segment 0 (no prediction) on a band of the panoptic dumps
SCANNET_CELLS = (6, 8)
SCANNET_CLASSES = 21
# rays of each frame the golden keeps for the reader's check
SCANNET_RAY_STRIDE = 509
SCANNET_RAY_TOL = 1e-6
READER_FIELDS = ("rgbs", "semantics", "instances", "probabilities",
                 "confidences", "mask", "gt_semantics", "gt_instances",
                 "segments", "intrinsics", "depth")


def _cells(hw, frame: int):
    """The cell index of each pixel of an ``hw`` image of frame ``frame``
    (the grid slides 1/64 of the width a frame)."""
    h, w = hw
    rows, cols = SCANNET_CELLS
    y = np.arange(h)[:, None] * rows // h
    x = ((np.arange(w)[None, :] + frame * w // 64) * cols // w) % cols
    return (y * cols + x).astype(np.int64)


def _intrinsic4(k) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[0, 2], m[1, 2] = k
    return m


def write_raw_scannet(root, seed: int = SCANNET_SEED,
                      n_frames: int = SCANNET_FRAMES, encode=None) -> dict:
    """A raw ScanNet scene under ``root``, made with numpy from ``seed``:
    ``scene.sens`` (version 4, ``n_frames`` frames of 968x1296 colour as
    JPEG at quality 90 through ``encode(image, quality)``, default the
    port's ``encode_jpeg``, and 480x640 depth as ``zlib_ushort``, shift
    1000), ``labels/<idx>_sem.png`` and ``<idx>_inst.png`` (uint16 raw ids
    at 968x1296, some above 255), ``label_mapping.json`` (raw -> reduced)
    and Mask2Former-style dumps ``panoptic/<idx>.npz`` at 480x640. The
    colour is a smooth texture with noise whose strength differs from frame
    to frame, so keyframe selection does not tie. Returns the paths."""
    import zlib

    from ..data.preprocessing.scannet import reduced_class_names
    from ..data.preprocessing.sens_reader import (SensFrame, SensHeader,
                                                  write_sens)
    from ..utils.jpeg import encode_jpeg

    encode = encode or encode_jpeg
    root = Path(root)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    (root / "panoptic").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    n_cells = SCANNET_CELLS[0] * SCANNET_CELLS[1]
    raw_ids = np.array(sorted(SCANNET_RAW_TO_REDUCED))
    cell_raw = raw_ids[rng.integers(0, len(raw_ids), n_cells)]
    cell_inst = np.arange(1, n_cells + 1) + np.where(
        np.arange(n_cells) % 2, 250, 0)
    cell_tint = rng.uniform(-40, 40, (n_cells, 3)).astype(np.float32)
    seg_probs = rng.dirichlet(np.ones(SCANNET_CLASSES),
                              n_cells + 1).astype(np.float32)
    seg_conf = rng.uniform(0.5, 1.0, (2, n_cells + 1)).astype(np.float32)
    names = reduced_class_names()
    h, w = SCANNET_COLOR_HW
    dh, dw = SCANNET_DEPTH_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dyy, dxx = np.mgrid[0:dh, 0:dw].astype(np.float32)
    phase = np.array([0.0, 2.1, 4.2], np.float32)
    frames = []
    for i in range(n_frames):
        cells = _cells((h, w), i)
        texture = (128 + 60 * np.sin(xx[..., None] / 41 + i * 0.3 + phase)
                   * np.cos(yy[..., None] / 57 + phase / 2))
        noise = rng.normal(0, 2 + 3 * ((i * 5) % 12), (h, w, 3))
        rgb = np.clip(texture + cell_tint[cells] + noise, 0, 255).astype(
            np.uint8)
        depth = (1500 + 400 * np.sin(dxx / 90 + i * 0.2)
                 * np.cos(dyy / 70)).astype(np.uint16)
        angle = 0.15 * i
        pose = _look_at(np.array([2 * np.cos(angle), 2 * np.sin(angle),
                                  1.2]), np.zeros(3))
        frames.append(SensFrame(pose, i * 33333,
                                i * 33333, encode(rgb, SCANNET_QUALITY),
                                zlib.compress(depth.tobytes())))
        write_png(root / "labels" / f"{i}_sem.png",
                  cell_raw[cells].astype(np.uint16))
        write_png(root / "labels" / f"{i}_inst.png",
                  cell_inst[cells].astype(np.uint16))
        # the panoptic dump at the processed size: segment ids 1.. per
        # cell, 0 on a band without prediction; the no-TTA mask merges
        # neighbouring cells
        seg = _cells(SCANNET_IMAGE_HW, i) + 1
        seg[:, :dw // 40] = 0
        seg_nt = np.where(seg > 0, (seg + 1) // 2 * 2 - 1, 0)
        segments = [{"id": int(s), "category_id": int(SCANNET_RAW_TO_REDUCED[
            int(cell_raw[s - 1])]), "category_name": names[
            SCANNET_RAW_TO_REDUCED[int(cell_raw[s - 1])]]}
            for s in range(1, n_cells + 1)]
        segments_nt = [s for s in segments if s["id"] % 2]
        np.savez(root / "panoptic" / f"{i}.npz", mask=seg.astype(np.int32),
                 mask_notta=seg_nt.astype(np.int32),
                 segments=json.dumps(segments),
                 segments_notta=json.dumps(segments_nt),
                 probabilities=seg_probs[seg], confidences=seg_conf[0][seg],
                 confidences_notta=seg_conf[1][seg_nt])
    header = SensHeader("StructureSensor", _intrinsic4(SCANNET_COLOR_K),
                        np.eye(4, dtype=np.float32),
                        _intrinsic4(SCANNET_DEPTH_K),
                        np.eye(4, dtype=np.float32), "jpeg", "zlib_ushort",
                        w, h, dw, dh, 1000.0, n_frames)
    sens = write_sens(root / "scene.sens", header, frames)
    mapping = root / "label_mapping.json"
    mapping.write_text(json.dumps({str(k): v for k, v in
                                   SCANNET_RAW_TO_REDUCED.items()}))
    return {"sens": sens, "labels": root / "labels", "mapping": mapping,
            "panoptic": root / "panoptic"}


def preprocess_kwargs(raw: dict, out, keyframe_window: int =
                      SCANNET_KEYFRAME_WINDOW) -> dict:
    """The keyword arguments of ``preprocess_scannet`` (either package's)
    for the raw scene ``raw`` (``write_raw_scannet``'s paths) into
    ``out``."""
    return dict(sens_path=raw["sens"], output_dir=out,
                label_dir=raw["labels"], label_mapping=raw["mapping"],
                frame_skip=1, keyframe_window=keyframe_window,
                image_hw=SCANNET_IMAGE_HW, panoptic_dir=raw["panoptic"])


def run_preprocess(raw: dict, out, keyframe_window: int =
                   SCANNET_KEYFRAME_WINDOW) -> dict:
    """The port's ``preprocess_scannet`` of ``raw`` into ``out``; returns
    its summary and seconds."""
    from ..data.preprocessing.scannet import preprocess_scannet

    t0 = time.perf_counter()
    summary = preprocess_scannet(**preprocess_kwargs(raw, out,
                                                     keyframe_window))
    return {**summary, "seconds": time.perf_counter() - t0}


def _sha(data) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()


def array_digest(a) -> str:
    """sha256 of an array's shape and values, integers and booleans as
    int64 and floats as float64 (so that two readers' dtypes do not
    matter, only their values)."""
    a = np.asarray(a)
    kind = np.float64 if a.dtype.kind == "f" else np.int64
    return _sha(repr(a.shape).encode() + np.ascontiguousarray(
        a.astype(kind)).tobytes())


def _canonical(obj):
    """A repr-able form of an unpickled object that keeps its types: the
    digest of ``segmentation_data.pkl`` tells int from numpy int."""
    if isinstance(obj, dict):
        return ("dict", sorted((repr(_canonical(k)), _canonical(v))
                               for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [_canonical(v) for v in obj])
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, _sha(
            np.ascontiguousarray(obj).tobytes()))
    return (type(obj).__name__, repr(obj))


def file_digest(path, png_pixels=None) -> str:
    """The digest a file of the preprocessed tree is held to: a PNG's
    header (size, bit depth, colour type) and pixels (``png_pixels(data)``,
    default the port's ``decode_png``), an npz's arrays, a pickle's loaded
    objects, and any other file's bytes (JPEG, txt, json)."""
    import io
    import pickle
    import struct

    from ..utils.png import decode_png

    path = Path(path)
    data = path.read_bytes()
    if path.suffix == ".png":
        w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
        px = np.asarray((png_pixels or decode_png)(data))
        return (f"png:{w}x{h}:{depth}:{colour}:{px.dtype.str}:"
                + _sha(repr(px.shape).encode() + px.tobytes()))
    if path.suffix == ".npz":
        with np.load(io.BytesIO(data)) as z:
            parts = [(k, z[k].dtype.str, z[k].shape, _sha(z[k].tobytes()))
                     for k in sorted(z.files)]
        return "npz:" + _sha(repr(parts).encode())
    if path.suffix == ".pkl":
        return "pkl:" + _sha(repr(_canonical(pickle.loads(data))).encode())
    return "bytes:" + _sha(data)


def tree_digests(root, png_pixels=None) -> dict:
    """{path relative to ``root``: ``file_digest``} of every file."""
    root = Path(root)
    return {p.relative_to(root).as_posix(): file_digest(p, png_pixels)
            for p in sorted(root.rglob("*")) if p.is_file()}


def reader_record(scene) -> dict:
    """What the golden keeps of a scene read from the preprocessed tree:
    each frame's name and ``READER_FIELDS`` digests (train frames, then
    val), every ``SCANNET_RAY_STRIDE``-th ray, and the segmentation
    bookkeeping's digest."""
    frames = scene.train_frames + scene.val_frames
    seg = scene.segmentation
    return {
        "names": np.array([f.name for f in frames]),
        "splits": np.array([len(scene.train_frames), len(scene.val_frames)]),
        "digests": np.array([[array_digest(getattr(f, k)) if getattr(
            f, k) is not None else "none" for k in READER_FIELDS]
            for f in frames]),
        "rays": np.stack([f.rays[::SCANNET_RAY_STRIDE].astype(np.float32)
                          for f in frames]),
        "segmentation": np.array(_sha(repr(_canonical(
            (sorted(seg.fg_classes), sorted(seg.bg_classes),
             int(seg.num_semantic_classes),
             {int(k): int(v) for k, v in seg.instance_to_semantics.items()},
             int(seg.num_instances)))).encode()))}


def load_preprocessed(tree, image_hw=SCANNET_IMAGE_HW):
    """The port's ``load_scene`` of the preprocessed tree (dataset_class
    panopli at ``image_hw``)."""
    from ..data import load_scene
    return load_scene(Config(dataset_class="panopli", dataset_root=str(tree),
                             image_dim=tuple(image_hw)))


def check_preprocess(tree, golden, prefix: str = "", scene=None) -> dict:
    """Hold the preprocessed ``tree`` (and the scene the port's reader
    loads from it, ``scene``, when given) to ``golden``'s ``prefix``
    record: the file list equal, every file at its digest (JPEGs, txt and
    json bytes equal; PNG headers and pixels equal; npz arrays equal;
    pickles' objects equal), the reader's arrays equal and its rays within
    ``SCANNET_RAY_TOL``. Raises AssertionError naming what differs;
    returns the counts checked."""
    want = dict(zip(golden[prefix + "files"].tolist(),
                    golden[prefix + "digests"].tolist()))
    got = tree_digests(tree)
    if sorted(got) != sorted(want):
        raise AssertionError(
            f"preprocessed files differ: extra {sorted(set(got) - set(want))}"
            f", missing {sorted(set(want) - set(got))}")
    bad = [k for k in want if got[k] != want[k]]
    if bad:
        raise AssertionError(f"{len(bad)} preprocessed files differ from the "
                             f"golden's: {bad[:10]}")
    out = {"files": len(got)}
    if scene is None:
        return out
    rec = reader_record(scene)
    for key in ("names", "splits", "segmentation"):
        if not np.array_equal(rec[key], golden[prefix + "reader_" + key]):
            raise AssertionError(f"reader {key}: {rec[key]} vs "
                                 f"{golden[prefix + 'reader_' + key]}")
    diff = rec["digests"] != golden[prefix + "reader_digests"]
    if diff.any():
        where = [(str(rec["names"][i]), READER_FIELDS[j])
                 for i, j in zip(*np.nonzero(diff))]
        raise AssertionError(f"reader arrays differ: {where[:10]}")
    ray_err = float(np.abs(rec["rays"] - golden[prefix + "reader_rays"]).max())
    if not ray_err <= SCANNET_RAY_TOL:
        raise AssertionError(f"reader rays {ray_err} from the golden's")
    return {**out, "frames": len(rec["names"]), "ray_max_abs_err": ray_err}


# the training cut of preprocess_scannet: r5b's configuration and widths on
# the preprocessed scene read at 60x80 (9 steps an epoch of its 4 train
# frames), 2 epochs with the instance and segment phases open in the second
PREPROCESS_TRAIN_HW = (60, 80)
PREPROCESS_OVERRIDES = {"max_epoch": 2, "instance_optimization_epoch": 1,
                        "segment_optimization_epoch": 1, "sanity_steps": 1,
                        "val_check_percent": 1.0}


def train_preprocessed(tree, run_dir, overrides=None, device="cuda",
                       train_hw=PREPROCESS_TRAIN_HW) -> dict:
    """``Trainer.fit`` of r5b's configuration with ``overrides``
    (default ``PREPROCESS_OVERRIDES``) on the preprocessed ``tree`` read at
    ``train_hw``. Returns the config, the trainer, its metric records, the
    fit seconds, the warm steps/s (the first step of each epoch left out)
    and the path of ``last.npz``."""
    from ..data import load_scene
    from ..train.loop import Trainer

    cfg = load_config(R5B_CONFIG, {
        "dataset_class": "panopli", "dataset_root": str(tree),
        "image_dim": list(train_hw),
        **(PREPROCESS_OVERRIDES if overrides is None else overrides)}
    ).resolve_epochs()
    scene = load_scene(cfg)
    run_dir = Path(run_dir)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, scene, run_dir, log_every=1, device=device)
    trainer.fit()
    fit_seconds = time.perf_counter() - t0
    records = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = trainer.seconds["step"]
    warm = [s for i, (e, s) in enumerate(steps) if i and steps[i - 1][0] == e]
    return {"cfg": cfg, "trainer": trainer, "records": records,
            "fit_seconds": fit_seconds, "steps": len(steps),
            "warm_steps_per_second": len(warm) / sum(warm) if warm else None,
            "last": run_dir / "checkpoints" / "last.npz"}


def render_preprocessed(ckpt, cfg, scene, device="cuda",
                        chunk: int = PRODUCTION_CHUNK) -> dict:
    """``render_frames`` (its defaults) of ``scene``'s val frames from the
    checkpoint ``ckpt`` trained with ``cfg``, in chunks of ``chunk`` rays;
    the maps and the render seconds (host clock)."""
    dev = resolve_device(device)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, device=dev)
    t0 = time.perf_counter()
    maps = render_frames(params, mcfg, rcfg, state_r, scene.val_frames,
                         chunk=chunk, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"maps": maps, "render_seconds": time.perf_counter() - t0,
            "rays": sum(len(f.rays) for f in scene.val_frames)}


# ---------------------------------------------------------------------------
# The codecs: every JPEG kind the JAX package reads through PIL and the
# scene writer does not write, at a frame's size
# ---------------------------------------------------------------------------

CODEC_KINDS = ("rgb_coded", "cmyk", "ycck", "sampling_440", "sampling_411",
               "progressive_smoothed", "arithmetic", "arithmetic_progressive",
               "lossless")
CODEC_HW = (480, 640)
# the size the RGB-coded and the CMYK frame are loaded at, and the corner
# of each decode kept whole beside its digest
CODEC_LOAD_HW = (60, 80)
CODEC_CROP = 64


def check_codecs(golden: dict, tmp_dir, repeats: int = 3) -> dict:
    """Decode each of the codec golden's files with the port on the host:
    PIL's shape and mode, its pixels (``array_digest`` of the whole and the
    top-left ``CODEC_CROP`` square equal), each kind's median decode
    seconds over ``repeats``; then the RGB-coded and the CMYK frame as
    files through ``data/panopli.py::_load_rgb`` at ``CODEC_LOAD_HW``
    equal to the JAX package's, and the CMYK frame greyed
    (``to_grey_pil``) equal to PIL's ``convert("L")``. Returns the seconds
    and the failures."""
    from ..data.panopli import _load_rgb
    from ..utils.image import image_mode, read_image, to_grey_pil
    from ..utils.jpeg import decode_jpeg

    failures, seconds = [], {}
    crop = (slice(0, CODEC_CROP), slice(0, CODEC_CROP))
    for kind in CODEC_KINDS:
        data = golden[f"{kind}_file"].tobytes()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            got = decode_jpeg(data)
            times.append(time.perf_counter() - t0)
        seconds[kind] = float(np.median(times))
        path = Path(tmp_dir) / f"{kind}.jpg"
        path.write_bytes(data)
        if image_mode(path) != str(golden[f"{kind}_mode"]):
            failures.append(f"{kind}: mode {image_mode(path)}, PIL's "
                            f"{golden[kind + '_mode']}")
        if list(got.shape) != list(golden[f"{kind}_shape"]):
            failures.append(f"{kind}: shape {got.shape}, PIL's "
                            f"{tuple(golden[kind + '_shape'])}")
        elif (array_digest(got) != str(golden[f"{kind}_digest"])
              or not np.array_equal(got[crop], golden[f"{kind}_crop"])):
            diff = np.abs(got[crop].astype(int)
                          - golden[f"{kind}_crop"].astype(int))
            failures.append(f"{kind}: pixels differ from PIL's (corner: "
                            f"{int((diff > 0).sum())} values, up to "
                            f"{int(diff.max())})")
    for kind in ("rgb_coded", "cmyk"):
        loaded = _load_rgb(Path(tmp_dir) / f"{kind}.jpg", CODEC_LOAD_HW)
        if not np.array_equal(loaded, golden[f"{kind}_load_rgb"]):
            failures.append(f"{kind}: _load_rgb differs from the JAX "
                            "package's")
    path = Path(tmp_dir) / "cmyk.jpg"
    grey = to_grey_pil(read_image(path), mode=image_mode(path))
    if (array_digest(grey) != str(golden["cmyk_grey_digest"])
            or not np.array_equal(grey[crop], golden["cmyk_grey_crop"])):
        failures.append("cmyk: the grey conversion differs from PIL's")
    return {"decode_seconds": seconds, "hw": list(CODEC_HW),
            "file_bytes": {k: int(golden[f"{k}_file"].size)
                           for k in CODEC_KINDS},
            "failures": failures}
