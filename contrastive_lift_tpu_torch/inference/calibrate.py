"""Clustering calibration: bandwidth sweep + train-centroid extraction.

Port of ``contrastive_lift_tpu/inference/calibrate.py``; the renders and the
clustering run on ``device``.

``find_bandwidth``: renders the TRAIN views once, folds every thing class into
one (otherwise a degenerate single-instance prediction scores high PQ because
(semantic, instance) tuples still differ), sweeps mean-shift bandwidths (range
proportional to sqrt(embedding dim)) or HDBSCAN min_cluster_size, and scores
each value with per-frame PQ against the machine pseudo-labels — never GT.

``extract_train_centroids``: clusters the train-view embeddings segmentwise and
pickles {thing_class: centroids} -> all_centroids.pkl for test-time reuse
(``cli/render.py --cached_centroids_path``).
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import Config
from ..data.base import FrameData
from ..metrics.panoptic_quality import panoptic_quality
from .cluster import (cluster, cluster_segmentwise,
                      create_instances_from_semantics)
from .render import render_frames


def modify_things_to_singleclass(sem_onehot: np.ndarray, thing_classes) -> np.ndarray:
    """Fold all thing classes into thing_classes[0] (anti-cheating hack)."""
    labels = sem_onehot.argmax(-1)
    thing_mask = np.isin(labels, np.asarray(list(thing_classes)))
    out = sem_onehot.copy()
    out[thing_mask] = 0.0
    out[thing_mask, list(thing_classes)[0]] = 1.0
    return out


def render_train_embeddings(params, mcfg, rcfg, state_r, cfg: Config,
                            frames: List[FrameData], thing_classes,
                            chunk: int = 8192, device="cuda"):
    """(thing_features [N,D+1], folded semantics one-hot [N,C], per-frame list)."""
    per_frame = render_frames(params, mcfg, rcfg, state_r, frames, chunk,
                              device=device)
    sem_list, feat_list = [], []
    for i, frame in enumerate(frames):
        out = per_frame[i]
        inst = out["instances"]
        if cfg.use_delta:
            inst = inst + frame.rays[:, 0:3] + out["depth"][:, None] * frame.rays[:, 3:6]
        if mcfg.slow_fast_mode:
            inst = inst[:, :cfg.max_instances]
        feat_list.append(create_instances_from_semantics(
            inst, out["semantics"], thing_classes))
        sem_list.append(modify_things_to_singleclass(out["semantics"], thing_classes))
    return np.concatenate(feat_list), np.concatenate(sem_list), per_frame


def sweep_values(cfg: Config, use_dbscan: bool, is_mos: bool) -> np.ndarray:
    """The reference's sweep grids: 25 mean-shift bandwidths up to
    sqrt(max_instances) / 3.5 (50 on MOS scenes; the arange's length, as
    the reference computes it), or HDBSCAN min_cluster_size values."""
    if not use_dbscan:
        top = np.sqrt(cfg.max_instances) / 3.5
        steps = 50 if is_mos else 25
        return np.arange(top / steps, top, top / steps)
    return np.arange(10, 200, 10) if is_mos else np.arange(250, 3000, 50)


def find_bandwidth(params, mcfg, rcfg, state_r, cfg: Config,
                   frames: List[FrameData], thing_classes,
                   use_dbscan: bool = False, segmentwise: bool = False,
                   chunk: int = 8192, sweep: Optional[np.ndarray] = None,
                   output_dir=None, device="cuda") -> dict:
    """Sweep the clustering hyperparameter; return the best value (the last
    of equal bests) and the PQ curve.

    A value whose clustering is degenerate is skipped, as in the JAX
    package, but only for what the port's clusterings raise then:
    ``ValueError`` (mean-shift: no point within the bandwidth of any seed;
    HDBSCAN: fewer than two samples). Any other error, a CUDA one
    included, propagates."""
    thing_feats, sem_folded, _ = render_train_embeddings(
        params, mcfg, rcfg, state_r, cfg, frames, thing_classes, chunk,
        device)
    if output_dir is not None:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        np.save(Path(output_dir) / "all_thing_features_train.npy", thing_feats)

    num_images = len(frames)
    sem_pred = sem_folded.argmax(-1).reshape(num_images, -1)
    # pseudo-label targets, also folded to a single thing class
    folded_cls = list(thing_classes)[0]
    targets = []
    for frame in frames:
        t_sem = frame.semantics.copy()
        t_sem[np.isin(t_sem, np.asarray(list(thing_classes)))] = folded_cls
        targets.append(np.stack([t_sem, frame.instances], -1))

    values = sweep if sweep is not None else sweep_values(
        cfg, use_dbscan, cfg.dataset_class == "mos")
    best_pq, best_val = 0.0, None
    curve = []
    for val in values:
        kwargs = dict(num_images=num_images, use_dbscan=use_dbscan,
                      device=device)
        if use_dbscan:
            kwargs["cluster_size"] = int(val)
            bw = 0.15
        else:
            bw = float(val)
        try:
            if segmentwise:
                onehot, _ = cluster_segmentwise(thing_feats, sem_folded, bw,
                                                **kwargs)
            else:
                onehot = cluster(thing_feats, bw, **kwargs)
        except ValueError as exc:  # degenerate clustering for this value
            print(f"clustering failed for value {val}: {exc}")
            continue
        # per-frame PQ vs pseudo-labels (not PQ^scene: machine ids are not
        # consistent across frames)
        pqs = []
        for i in range(num_images):
            pred = np.stack([sem_pred[i], np.asarray(onehot[i]).argmax(-1)], -1)
            pq, _, _ = panoptic_quality(pred, targets[i], {folded_cls},
                                        set(range(0, folded_cls)),
                                        allow_unknown_preds_category=True)
            pqs.append(pq)
        pq = float(np.mean(pqs))
        curve.append((float(val), pq))
        print(f"value: {val}, pq: {pq}")
        if pq >= best_pq:
            best_pq, best_val = pq, float(val)

    result = {"best_value": best_val, "best_pq": best_pq, "curve": curve,
              "mode": "min_cluster_size" if use_dbscan else "bandwidth"}
    if output_dir is not None:
        _plot_curve(result, Path(output_dir) / "bandwidth_vs_pq.png")
    return result


def _plot_curve(result: dict, path) -> None:
    """The PQ curve as a PNG; nothing is written where matplotlib is
    missing, as in the JAX package."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    xs = [c[0] for c in result["curve"]]
    ys = [c[1] for c in result["curve"]]
    plt.figure()
    plt.plot(xs, ys)
    if result["best_value"] is not None:
        plt.scatter([result["best_value"]], [result["best_pq"]], s=100,
                    facecolors="none", edgecolors="r")
    plt.xlabel(result["mode"])
    plt.ylabel("panoptic quality")
    plt.title(f"Best {result['mode']}: {result['best_value']}, pq: {result['best_pq']:.4f}")
    plt.savefig(path)
    plt.close()


def extract_train_centroids(params, mcfg, rcfg, state_r, cfg: Config,
                            frames: List[FrameData], thing_classes,
                            bandwidth: float = 0.15, use_dbscan: bool = False,
                            use_silverman: bool = False, cluster_size: int = 500,
                            chunk: int = 8192, output_path=None,
                            device="cuda") -> dict:
    """Cluster train-view embeddings per thing class; pickle the centroids."""
    per_frame = render_frames(params, mcfg, rcfg, state_r, frames, chunk,
                              device=device)
    sem_cat = np.concatenate([f["semantics"] for f in per_frame])
    inst = np.concatenate([f["instances"] for f in per_frame])
    if mcfg.slow_fast_mode:
        inst = inst[:, :cfg.max_instances]
    thing_feats = create_instances_from_semantics(inst, sem_cat, thing_classes)
    _, centroids = cluster_segmentwise(
        thing_feats, sem_cat, bandwidth, len(frames), use_dbscan,
        use_silverman, cluster_size, device=device)
    if output_path is not None:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "wb") as f:
            pickle.dump(centroids, f)
    return centroids
